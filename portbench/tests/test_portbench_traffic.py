"""The generators give the same inputs for a seed, and other inputs for
another; every seed plays the same lengths."""

import torch

from portbench import traffic
from portbench import weights as W

SCORE = {"rows": 2, "length_min": 512, "length_max": 4096, "length_multiple": 256, "deck": 32}
BIG = 2**31 + 12345


def test_train_batches_are_the_seeds():
    tr = {"batch": 2, "seq": 16}
    a = traffic.train_batch(tr, BIG, 3, 1000, "cpu")
    b = traffic.train_batch(tr, BIG, 3, 1000, "cpu")
    c = traffic.train_batch(tr, BIG + 1, 3, 1000, "cpu")
    d = traffic.train_batch(tr, BIG, 4, 1000, "cpu")
    assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["labels"], b["labels"])
    assert not torch.equal(a["tokens"], c["tokens"]) and not torch.equal(a["tokens"], d["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert a["tokens"].dtype == torch.int32 and int(a["tokens"].max()) < 1000


def test_every_seed_plays_the_same_decks():
    for seed in (0, BIG, 2**40 + 3):
        deck = [traffic.request_length(SCORE, seed, i) for i in range(32)]
        assert sorted(deck) == traffic.deck_lengths(SCORE)
    one = [traffic.request_length(SCORE, BIG, i) for i in range(64)]
    two = [traffic.request_length(SCORE, BIG + 1, i) for i in range(64)]
    assert one != two and sorted(one) == sorted(two)


def test_deck_lengths_follow_the_law():
    lengths = traffic.deck_lengths(SCORE)
    assert lengths == sorted(lengths)
    assert min(lengths) >= 512 and max(lengths) <= 4096
    assert all(n % 256 == 0 for n in lengths)
    assert 1600 <= sum(lengths) / len(lengths) <= 1850   # (4096 - 512) / ln 8 = 1723


def test_score_requests_are_the_seeds():
    a = traffic.score_request(SCORE, BIG, 5, 1000, "cpu")
    b = traffic.score_request(SCORE, BIG, 5, 1000, "cpu")
    assert torch.equal(a["tokens"], b["tokens"])
    assert a["tokens"].shape == (2, traffic.request_length(SCORE, BIG, 5))


def test_weights_are_the_seeds():
    conf = {"family": "dense", "hidden_size": 32, "intermediate_size": 64,
            "num_attention_heads": 4, "num_key_value_heads": 2, "num_hidden_layers": 2,
            "vocab_size": 50}
    a = W.make_params(conf, BIG, "cpu")
    b = W.make_params(conf, BIG, "cpu")
    c = W.make_params(conf, BIG + 1, "cpu")
    assert torch.equal(a["blocks"]["attn"]["wq"], b["blocks"]["attn"]["wq"])
    assert not torch.equal(a["blocks"]["attn"]["wq"], c["blocks"]["attn"]["wq"])
    assert W.derive_seed(BIG, "x") < 2**63
