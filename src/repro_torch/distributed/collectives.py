"""Distributed-optimization collectives (the port's
``repro.distributed.collectives``).

``compressed_crosspod_mean`` is the int8-quantized gradient reduction
across pods with error feedback: each pod quantizes ``g + err`` to int8
with one fp32 scale, keeps the quantization residual as its next ``err``,
and every pod's int8 blocks are summed back in fp32 and divided by the
pod count.  Wire bytes drop 4x against an fp32 all-reduce; the residual
carried to the next step keeps convergence unbiased in practice [Seide
et al. 2014; Karimireddy et al. 2019].

In the reference the pods are shards of a ``shard_map`` and the int8
blocks travel by ``all_gather``.  Here the pods of the class-sharded step
share one card and one address space, so the functions take a list of
per-pod gradient trees and the gather is the list.  Neither package wires
the reduction into a training step: the class-sharded step reduces
exactly (``runtime.trainer.weighted_mean_epilogue``).
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten


# Callables ``(kind, nbytes)`` told of every collective the port runs (the
# dry-run's counter, ``launch.op_analysis.count_ops``); empty otherwise.
COLLECTIVE_OBSERVERS: list = []


def note_collective(kind: str, tensors) -> None:
    """Report one collective: ``kind`` (the reference's op name, e.g.
    ``"all-reduce"``) and the tensors one pod sends, the operand bytes the
    reference's HLO counts per device."""

    if not COLLECTIVE_OBSERVERS:
        return
    def flat(tree):
        if isinstance(tree, dict):
            return [t for v in tree.values() for t in flat(v)]
        if isinstance(tree, (list, tuple)):
            return [t for v in tree for t in flat(v)]
        return [tree] if isinstance(tree, torch.Tensor) else []

    nbytes = sum(t.numel() * t.element_size() for t in flat(tensors))
    for observe in COLLECTIVE_OBSERVERS:
        observe(kind, nbytes)


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8 quantization -> ``(q, scale)``."""

    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-30) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _crosspod_mean_one(gs: Sequence[torch.Tensor], errs: Sequence[torch.Tensor]):
    """One leaf: quantize each pod's ``g + err``, sum the int8 blocks in
    fp32 against their scales, divide by the pod count."""

    qs, scales, new_errs = [], [], []
    for g, err in zip(gs, errs):
        gf = g.float() + err
        q, scale = quantize_int8(gf)
        new_errs.append(gf - dequantize_int8(q, scale))
        qs.append(q)
        scales.append(scale)
    note_collective("all-gather", [qs[0], scales[0]])  # the reference's int8 all_gather
    mean = torch.tensordot(torch.stack(scales), torch.stack(qs).float(), dims=([0], [0]))
    return (mean / len(gs)).to(gs[0].dtype), new_errs


def compressed_crosspod_mean(grads: Sequence, err_trees: Sequence, mesh=None, *,
                             axis: str = "pod"):
    """Mean of per-pod gradient trees with an int8 wire format.

    ``grads``: one tree per pod, each already reduced within its pod (a
    per-pod mean); ``err_trees``: the pods' error-feedback residuals (the
    same structure, fp32).  Returns ``(mean_grads, new_err_trees)``: one
    tree, the same on every pod, and one residual tree per pod.  A
    ``mesh`` without the pod axis has one pod and passes its tree and
    residual through, as the reference does.
    """

    if mesh is not None and axis not in mesh.axis_names:
        if len(grads) != 1:
            raise ValueError(f"{len(grads)} gradient trees on a mesh without a {axis!r} axis")
        return grads[0], list(err_trees)
    if len(grads) != len(err_trees) or not grads:
        raise ValueError(f"{len(grads)} gradient trees against {len(err_trees)} residuals")
    flat_g = [tree_leaves(g) for g in grads]
    flat_e = [tree_leaves(e) for e in err_trees]
    means, errs = [], [[] for _ in grads]
    for j in range(len(flat_g[0])):
        mean, new = _crosspod_mean_one([fg[j] for fg in flat_g], [fe[j] for fe in flat_e])
        means.append(mean)
        for pod, e in enumerate(new):
            errs[pod].append(e)
    return tree_unflatten(grads[0], means), [tree_unflatten(grads[0], e) for e in errs]


def init_error_feedback(params):
    """Zero fp32 residuals in the params' tree."""

    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


__all__ = [
    "COLLECTIVE_OBSERVERS",
    "note_collective",
    "quantize_int8",
    "dequantize_int8",
    "compressed_crosspod_mean",
    "init_error_feedback",
]
