"""The traffic generator: every cell's inputs from its traffic file's
parameters and the run's seed, made on the device.

  * ``train``: each step a batch of ``batch`` rows of ``seq + 1`` tokens
    drawn uniformly over the vocabulary (inputs, and labels shifted by
    one); step ``k`` has its own stream, so every row of a run differs.
  * ``score``: a closed loop of requests, each ``rows`` prompts of one
    length.  The lengths come as decks of ``deck`` requests whose lengths
    are the quantiles of a log-uniform law over ``[length_min,
    length_max]``, rounded to ``length_multiple``; every seed plays the
    same decks, each deck in its own order.  So every run does the same
    work, and its tail is the same tail.
"""

from __future__ import annotations

import torch

from portbench.weights import derive_seed, generator


def token_batch(seed: int, tag: str, rows: int, seq: int, vocab: int, device) -> dict:
    """``{"tokens", "labels"}`` (rows, seq) int32 for one stream."""

    gen = generator(seed, tag, device)
    t = torch.randint(0, vocab, (rows, seq + 1), generator=gen, device=device, dtype=torch.int64)
    t = t.to(torch.int32)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def train_batch(traffic: dict, seed: int, step: int, vocab: int, device) -> dict:
    return token_batch(seed, f"train:{step}", traffic["batch"], traffic["seq"], vocab, device)


def deck_lengths(traffic: dict) -> list:
    """The lengths of one deck, in ascending order."""

    lo, hi, mult = traffic["length_min"], traffic["length_max"], traffic["length_multiple"]
    n = traffic["deck"]
    out = []
    for i in range(n):
        length = lo * (hi / lo) ** ((i + 0.5) / n)
        out.append(min(hi, max(lo, mult * round(length / mult))))
    return out


def request_length(traffic: dict, seed: int, i: int) -> int:
    """The prompt length of request ``i`` of a run: its deck's lengths in
    an order drawn from the seed and the deck's number."""

    lengths = deck_lengths(traffic)
    deck, pos = divmod(i, len(lengths))
    g = torch.Generator().manual_seed(derive_seed(seed, f"deck:{deck}"))
    order = torch.randperm(len(lengths), generator=g).tolist()
    return lengths[order[pos]]


def score_request(traffic: dict, seed: int, i: int, vocab: int, device) -> dict:
    length = request_length(traffic, seed, i)
    return token_batch(seed, f"score:{i}", traffic["rows"], length, vocab, device)
