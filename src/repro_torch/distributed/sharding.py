"""The pod→class mapping and per-pod splits of the class-sharded step (the
pod half of the reference's ``repro.distributed.sharding``).

``core.execution.class_sharded`` runs one program per device class in one
step: pod *i* takes its shard of the work under its own class's control
tree.  In the reference the shards are ``shard_map`` blocks described by
``PartitionSpec``s; here they are views of the caller's tensors, and a
spec says which dim of a leaf splits over the pods:

  * :class:`PodSplit` ``(dim, axis)`` — the leaf's ``dim`` splits evenly,
    pod *i* taking the *i*-th block (``P(axis)`` placed at ``dim``);
  * ``None`` — every pod sees the whole leaf (``P()``, replicated).

A spec may stop above the leaves (a prefix of the argument's tree), as a
``PartitionSpec`` may: one ``PodSplit(0)`` covers every tensor of a batch
dict.  :func:`split_pods` makes the per-pod views (no copies) and
:func:`stitch_pods` joins per-pod outputs back.

The reference's other half — name-based FSDP / tensor-parallel rules for
params, caches and activations (``param_pspec``, ``shard_params``,
``constrain*``, ``activation_manual_axes``) — serves GSPMD across many
chips; on one card nothing is sharded over ``data`` or ``model`` and the
port's models carry no activation constraints, so it waits for a
multi-card configuration.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PodSplit:
    """Split a leaf's ``dim`` evenly over the mesh's ``axis``."""

    dim: int = 0
    axis: str = "pod"


def pod_class_indices(asym) -> np.ndarray:
    """``(n_pods,)`` int32 class index per pod — the pod→class mapping."""

    return np.asarray(asym.pod_class_indices(), np.int32)


def pod_class_specs(asym, *, axis: str = "pod") -> tuple[np.ndarray, PodSplit]:
    """The pod→class mapping plus the spec that shards it one-per-pod."""

    return pod_class_indices(asym), PodSplit(0, axis)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def pod_batch_specs(batch_tree, *, axis: str = "pod"):
    """Batch tensors shard their leading (row) dim over the pod axis."""

    return _tree_map(lambda _: PodSplit(0, axis), batch_tree)


def pod_state_specs(state_tree, *, axis: str = "pod", dim: int = 1):
    """Decode caches / SSM states shard their batch dim (default dim 1)."""

    return _tree_map(lambda _: PodSplit(dim, axis), state_tree)


def pod_decode_specs(state_spec, *, axis: str = "pod",
                     batch_keys: Sequence[str] = ("tokens",)):
    """(in_specs, out_specs) for a slot-table decode step over the pod axis.

    The serving engine's step is ``decode(params, batch, state, pos)``
    with ``B = n_pods × c_max`` pod-major slots: params replicated, every
    batch tensor (``"tokens"`` (B, 1), and for the paged engine
    ``"page_table"`` (B, W) and ``"live"`` (B,)) split one slot region per
    pod, positions likewise, and the decode state split on dim 1 — the
    slot dim of dense caches, the *page* dim of the paged arena, which is
    pod-partitioned on pages as the dense cache is on slots.  The same
    specs serve the engine's bulk prefill (tokens (B, P)).
    """

    sspecs = pod_state_specs(state_spec, axis=axis)
    in_specs = (None, {k: PodSplit(0, axis) for k in batch_keys}, sspecs, PodSplit(0, axis))
    out_specs = (PodSplit(0, axis), sspecs)
    return in_specs, out_specs


def _is_spec_leaf(spec) -> bool:
    return spec is None or isinstance(spec, PodSplit)


def _shard(x, spec: Optional[PodSplit], pod: int, n_pods: int, views: dict):
    if spec is None or not isinstance(x, torch.Tensor):
        return x
    size = x.shape[spec.dim]
    if size % n_pods:
        raise ValueError(f"dim {spec.dim} of a {tuple(x.shape)} tensor does not split "
                         f"over {n_pods} pods")
    c = size // n_pods
    view = x.narrow(spec.dim, pod * c, c)
    views[id(view)] = (x, pod)
    return view


def _sub_spec(spec, key):
    """The spec of one child: a leaf spec covers every child (a prefix)."""

    if _is_spec_leaf(spec):
        return spec
    try:
        return spec[key]
    except (KeyError, IndexError):
        raise ValueError(f"the spec has no entry {key!r} for the tree") from None


def split_pods(tree, spec, n_pods: int, views: Optional[dict] = None) -> list:
    """``n_pods`` per-pod trees of ``tree`` under ``spec``: views along
    each ``PodSplit`` dim, the whole leaf where the spec is ``None``.
    ``views`` (optional) records ``id(view) -> (tensor, pod)`` for
    :func:`stitch_pods`."""

    views = {} if views is None else views
    if isinstance(tree, dict):
        sub = {k: split_pods(v, _sub_spec(spec, k), n_pods, views) for k, v in tree.items()}
        return [{k: s[i] for k, s in sub.items()} for i in range(n_pods)]
    if isinstance(tree, (tuple, list)):
        sub = [split_pods(v, _sub_spec(spec, j), n_pods, views) for j, v in enumerate(tree)]
        return [type(tree)(s[i] for s in sub) for i in range(n_pods)]
    if not _is_spec_leaf(spec):
        raise ValueError(f"a {type(spec).__name__} spec for a leaf")
    return [_shard(tree, spec, i, n_pods, views) for i in range(n_pods)]


def _join(leaves: list, spec: Optional[PodSplit], views: dict):
    if spec is None or not isinstance(leaves[0], torch.Tensor):
        return leaves[0]  # replicated: every pod holds the same value
    whence = [views.get(id(x)) for x in leaves]
    if all(w is not None and w[0] is whence[0][0] and w[1] == i for i, w in enumerate(whence)):
        return whence[0][0]  # the pods wrote their views of one tensor in place: no copy
    return torch.cat(leaves, dim=spec.dim)


def stitch_pods(outs: list, spec, views: Optional[dict] = None):
    """Join per-pod output trees under ``spec``: a ``PodSplit`` leaf
    concatenates along its dim — or, when the pods returned the views
    :func:`split_pods` made of one tensor (a state written in place), is
    that tensor, with no copy; a ``None`` leaf is pod 0's (replicated)."""

    views = {} if views is None else views
    first = outs[0]
    if isinstance(first, dict):
        return {k: stitch_pods([o[k] for o in outs], _sub_spec(spec, k), views) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(stitch_pods([o[j] for o in outs], _sub_spec(spec, j), views)
                           for j in range(len(first)))
    return _join(outs, spec, views)


__all__ = [
    "PodSplit",
    "pod_batch_specs",
    "pod_class_indices",
    "pod_class_specs",
    "pod_decode_specs",
    "pod_state_specs",
    "split_pods",
    "stitch_pods",
]
