"""Deterministic token data pipeline with asymmetric batch layout (the
port's ``repro.data.pipeline``: numpy only, the same arrays).

Sources:
  * :class:`SyntheticLM` — seeded counter-based token stream (fully
    deterministic and resumable from any step — the property the
    fault-tolerance tests rely on),
  * :class:`MemmapLM` — flat uint16/int32 token files (production path).

:class:`AsymmetricBatcher` lays each global batch out as the padded
``(n_pods * c_max, S)`` block prescribed by the scheduler's chunk table,
with a validity mask, so pod *i*'s data shard contains exactly the rows
the (CA-)SAS/DAS schedule assigned to it (the paper's coarse-grain Loop-1/3
partition, at batch granularity).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from repro_torch.core.asymmetric import AsymmetricMesh, BatchLayout


class SyntheticLM:
    """Deterministic pseudo-text: tokens from a counter-keyed Philox."""

    def __init__(self, vocab: int, seed: int = 0):
        self.vocab = vocab
        self.seed = seed

    def batch(self, step: int, batch: int, seq: int) -> dict[str, np.ndarray]:
        rng = np.random.Generator(np.random.Philox(key=self.seed, counter=step))
        tokens = rng.integers(0, self.vocab, size=(batch, seq + 1), dtype=np.int32)
        # Inject learnable structure: every even position repeats the
        # previous token mod vocab, so tiny models can visibly learn.
        tokens[:, 1::2] = (tokens[:, 0:-1:2] + 1) % self.vocab
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


class MemmapLM:
    """Flat binary token file -> (tokens, labels) windows."""

    def __init__(self, path: str, vocab: int, dtype=np.uint16):
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.vocab = vocab

    def batch(self, step: int, batch: int, seq: int) -> dict[str, np.ndarray]:
        n = len(self.data)
        span = seq + 1
        starts = (step * batch + np.arange(batch)) * span % max(n - span, 1)
        rows = np.stack([self.data[s : s + span].astype(np.int32) for s in starts])
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


@dataclasses.dataclass
class BatchWithLayout:
    arrays: dict[str, np.ndarray]  # tokens/labels: (n_pods*c_max, S); mask: (n_pods*c_max, S)
    layout: BatchLayout


class AsymmetricBatcher:
    """Reshapes a logical global batch onto the scheduler's chunk table."""

    def __init__(self, source, asym: AsymmetricMesh):
        self.source = source
        self.asym = asym

    def batch(self, step: int, global_batch: int, seq: int) -> BatchWithLayout:
        layout = self.asym.batch_layout(global_batch)
        logical = self.source.batch(step, global_batch, seq)
        n_pods, c_max = len(layout.sizes), layout.c_max
        out = {}
        for k, v in logical.items():
            padded = np.zeros((n_pods * c_max,) + v.shape[1:], v.dtype)
            pos = 0
            for i, size in enumerate(layout.sizes):
                padded[i * c_max : i * c_max + size] = v[pos : pos + size]
                pos += size
            out[k] = padded
        mask = np.repeat(
            layout.mask.reshape(n_pods * c_max, 1), logical["tokens"].shape[1], axis=1
        ).astype(np.float32)
        out["mask"] = mask
        return BatchWithLayout(arrays=out, layout=layout)


def batches(source, global_batch: int, seq: int, steps: int, start_step: int = 0
            ) -> Iterator[dict[str, np.ndarray]]:
    for step in range(start_step, start_step + steps):
        yield source.batch(step, global_batch, seq)


__all__ = ["SyntheticLM", "MemmapLM", "AsymmetricBatcher", "BatchWithLayout", "batches"]
