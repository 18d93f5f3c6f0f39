"""Scoring: the logits-only prefill, as ``launch/score.py`` calls it.

One client in a closed loop: a request is ``rows`` prompts of one length
(``traffic.request_length``); the program's ``model_zoo.make_prefill_fn``
gives their logits under the big class's execution context, and the
client reduces them to what a scorer keeps, each prompt token's
log-probability given its prefix, and waits for it.  A request is timed
from its issue to its synchronised answer.

Set-up makes the weights in bfloat16, the type they are served in, and
runs one request of every length a deck holds.  Once the window has
closed, a sample of the answered requests drawn from the seed, the
longest among them, is held to the reference.

``fault``: ``"half_batch"`` hands the prefill the first half of the
prompts; ``"altered"`` changes the answer to every request's first
prompt (its logits rolled by one along the vocabulary).
"""

from __future__ import annotations

import gc
import time

import torch

from portbench import compare, counts, traffic
from portbench import weights as W
from portbench.reference import models as R


def logprobs(logits, labels):
    """Each position's log-probability of its label, (B, S) float32, a
    prompt at a time."""

    out = []
    for r in range(logits.shape[0]):
        lf = logits[r].float()
        out.append(lf.gather(-1, labels[r, :, None].long())[:, 0] - torch.logsumexp(lf, dim=-1))
        del lf
    return torch.stack(out)


class Session:
    def __init__(self, cell, seed: int, device, fault=None):
        self.cell, self.seed, self.device, self.fault = cell, seed, torch.device(device), fault
        self.answers = {}
        pk, conf, rows = counts.peaks(), cell.conf, cell.traffic["rows"]
        self.counts = {
            n: {"model_flops": counts.forward_flops(conf, rows, n),
                "gemm_bound_s": counts.gemm_bound_s(
                    counts.gemm_products(conf, rows * n, train=False), pk),
                "flash_bound_s": counts.flash_bound_s(conf, rows, n, pk)}
            for n in set(traffic.deck_lengths(cell.traffic))}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self):
        from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes
        from repro_torch.models import model_zoo as Z

        cell = self.cell
        self.params = W.make_params(cell.conf, self.seed, self.device, torch.bfloat16)
        want = W.tree_signature(Z.init_params(cell.port_cfg, None, "meta", dtype=torch.bfloat16))
        if W.tree_signature(self.params) != want:
            raise SystemExit(f"the program's parameter tree of {cell.port_cfg.name} is not the "
                             "benchmark's")
        self.prefill = Z.make_prefill_fn(cell.port_cfg)
        self.ctx = AsymmetricMesh(biglittle_classes(chips_per_pod=1),
                                  batch_tile=1).execution_context("big")
        for length in sorted(set(traffic.deck_lengths(cell.traffic))):
            req = traffic.token_batch(self.seed, f"warm:{length}", cell.traffic["rows"], length,
                                      cell.vocab, self.device)
            self._answer(req)
        self._sync()

    def _answer(self, req):
        tokens, labels = req["tokens"], req["labels"]
        if self.fault == "half_batch":
            tokens, labels = tokens[: tokens.shape[0] // 2], labels[: labels.shape[0] // 2]
        with self.ctx:
            logits = self.prefill(self.params, {"tokens": tokens})
        if self.fault == "altered":
            logits = logits.clone()
            logits[0] = logits[0].roll(1, dims=-1)
        out = logprobs(logits, labels)
        del logits
        return out

    def unit(self, i: int) -> dict:
        req = traffic.score_request(self.cell.traffic, self.seed, i, self.cell.vocab, self.device)
        rows, length = req["tokens"].shape
        t0 = time.perf_counter()
        self.answers[i] = self._answer(req)
        self._sync()
        latency = time.perf_counter() - t0
        return dict(self.counts[length], tokens=rows * length, latency_s=latency)

    def sample(self) -> list:
        """The requests the comparison takes: the first of the longest
        answered, and ``checked_requests - 1`` more drawn from the seed."""

        done = sorted(self.answers)
        lengths = {i: traffic.request_length(self.cell.traffic, self.seed, i) for i in done}
        longest = max(done, key=lambda i: (lengths[i], -i))
        rest = [i for i in done if i != longest]
        g = torch.Generator().manual_seed(W.derive_seed(self.seed, "sample"))
        k = min(len(rest), self.cell.traffic["checked_requests"] - 1)
        picks = [rest[j] for j in torch.randperm(len(rest), generator=g)[:k].tolist()]
        return [longest] + sorted(picks)

    def finish(self) -> dict:
        chosen = self.sample()
        readings = {i: self.answers[i] for i in chosen}
        self.answers = {}
        del self.params, self.prefill
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return readings

    def reference(self, readings: dict, precision: str = "fp32") -> dict:
        """The reference's log-probabilities of the sampled requests, on
        the same weights (bfloat16 values, computed in float32)."""

        conf = self.cell.conf
        params = _as_float32(W.make_params(conf, self.seed, self.device, torch.bfloat16))
        out = {}
        for i in readings:
            req = traffic.score_request(self.cell.traffic, self.seed, i, self.cell.vocab,
                                        self.device)
            out[i] = R.token_logprobs(params, conf, req["tokens"], req["labels"], precision)
        del params
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return out


def numbers(prog: dict, ref: dict) -> dict:
    return compare.logprob_numbers([(prog.get(i), ref[i]) for i in ref])


def _as_float32(tree):
    if isinstance(tree, dict):
        return {k: _as_float32(v) for k, v in tree.items()}
    return tree.float()
