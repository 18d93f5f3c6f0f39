"""PartitionSpec rules for every parameter, activation and cache tensor
(the port's ``repro.distributed.sharding``).

Axes, as in the reference:

  * ``pod``   — data parallelism across pods (multi-pod mesh only);
  * ``data``  — data parallelism within a pod; with ``fsdp`` the params
                and AdamW state also shard over it (ZeRO-3);
  * ``model`` — tensor parallelism (Megatron column / row split).

Two halves.  The name-based FSDP / tensor-parallel rules
(:func:`param_pspec`, :func:`shard_params`, :func:`cache_pspec`,
:func:`batch_pspec`, the activation specs of :func:`constrain` and its
kin) are the reference's, over the port's :class:`P`: a tuple with one
entry per dim, an axis name, a tuple of names or ``None``.  Where the
reference hands a spec to GSPMD, the port's rank-local step
(``distributed.spmd``) reads it: :func:`local_shape` and
:func:`local_slice` cut a full tensor into a rank's shard and
``spmd.gather_full`` joins the shards back.  The activation functions
return the spec the reference would constrain a tensor of that global
shape to; ``spmd.Layout`` decides the step's sequence sharding and
context-parallel split from them, and the models lay their activations
out that way themselves (``models/layers.py``, ``models/transformer.py``).

The pod half serves the class-sharded step
(``core.execution.class_sharded``): pod *i* takes its shard of the work
under its own class's control tree.  In the reference the shards are
``shard_map`` blocks described by ``PartitionSpec``s; here they are views
of the caller's tensors, and a spec says which dim of a leaf splits over
the pods:

  * :class:`PodSplit` ``(dim, axis)`` — the leaf's ``dim`` splits evenly,
    pod *i* taking the *i*-th block (``P(axis)`` placed at ``dim``);
  * ``None`` — every pod sees the whole leaf (``P()``, replicated).

A spec may stop above the leaves (a prefix of the argument's tree), as a
``PartitionSpec`` may: one ``PodSplit(0)`` covers every tensor of a batch
dict.  With the pods as streams in one process, :func:`split_pods` makes
the per-pod views (no copies) and :func:`stitch_pods` joins per-pod
outputs back.  With a rank a pod (a ``RankMesh`` with a ``pod`` axis),
:func:`pod_view` takes this rank's pod's view and :func:`gather_pods`
all-gathers an output's ``PodSplit`` dims over the pod group; a rank that
holds only its own pod's state passes it under ``None`` both ways
(``pod_decode_specs(..., held=True)``).  Inside a pod's program the pod
axis is manual: ``constrain(..., manual=("pod",))`` drops it from an
activation's spec, as the reference's ``activation_manual_axes`` does in
its ``shard_map`` body.
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
                     batch_keys: Sequence[str] = ("tokens",), held: bool = False):
    """(in_specs, out_specs) for a slot-table decode step over the pod axis.

    The serving engine's step is ``decode(params, batch, state, pos)``
    with ``B = n_pods × c_max`` pod-major slots: params replicated, every
    batch tensor (``"tokens"`` (B, 1), and for the paged engine
    ``"page_table"`` (B, W) and ``"live"`` (B,)) split one slot region per
    pod, positions likewise, and the decode state split on dim 1 — the
    slot dim of dense caches, the *page* dim of the paged arena, which is
    pod-partitioned on pages as the dense cache is on slots.  The same
    specs serve the engine's bulk prefill (tokens (B, P)).  ``held``: each
    rank holds its own pod's state (a rank a pod), so the state's specs
    are ``None`` — nothing to cut on the way in, nothing to gather on the
    way out — while the batch, the positions and the logits still split
    and gather over the pods.
    """

    sspecs = None if held else pod_state_specs(state_spec, axis=axis)
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


def pod_view(tree, spec, n_pods: int, pod: int):
    """Pod ``pod``'s tree of ``tree`` under ``spec``, the rank form of
    :func:`split_pods`: its block of every ``PodSplit`` dim (a view), the
    whole leaf where the spec is ``None``."""

    if isinstance(tree, dict):
        return {k: pod_view(v, _sub_spec(spec, k), n_pods, pod) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(pod_view(v, _sub_spec(spec, j), n_pods, pod) for j, v in enumerate(tree))
    if not _is_spec_leaf(spec):
        raise ValueError(f"a {type(spec).__name__} spec for a leaf")
    return _shard(tree, spec, pod, n_pods, {})


def gather_pods(tree, spec, mesh):
    """This rank's output tree made whole, the rank form of
    :func:`stitch_pods`: every ``PodSplit`` leaf all-gathered over its
    axis's group along its dim (pod-major, as the views were cut); a
    ``None`` leaf is this rank's as it is."""

    from repro_torch.distributed import collectives as C

    if isinstance(tree, dict):
        return {k: gather_pods(v, _sub_spec(spec, k), mesh) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(gather_pods(v, _sub_spec(spec, j), mesh) for j, v in enumerate(tree))
    if spec is None or not isinstance(tree, torch.Tensor):
        return tree
    return C.all_gather(tree, mesh, spec.axis, spec.dim)


# ---------------------------------------------------------------------------
# The name-based FSDP / tensor-parallel rules
# ---------------------------------------------------------------------------


class P(tuple):
    """A partition spec: one entry per dim (an axis name, a tuple of axis
    names or ``None``), as ``jax.sharding.PartitionSpec`` holds them."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def __reduce__(self):  # pickled as its entries (spawned ranks send specs)
        return (P, tuple(self))


# Column-parallel: shard output features on "model", fsdp on input features.
_COL = {"wq", "wk", "wv", "w1", "w3", "wz", "wx", "wdt", "lm_head"}
# Row-parallel: shard input features on "model", fsdp on output features.
_ROW = {"wo", "w2", "out_proj"}
# Feature-sharded vectors (live on the "model"-sharded dim).
_VEC_MODEL = {"bq", "bk", "bv", "b1", "dt_bias", "A_log", "D", "norm_w", "conv_b_x"}
# fsdp-only matrices (output dim too small / must stay replicated for TP).
_NOTP = {"wbc", "router", "shared_gate"}
# Last-dim-model only (no fsdp dim available).
_LASTDIM_MODEL = {"conv_w_x"}


def _data_axis(mesh) -> Optional[str]:
    return "data" if "data" in mesh.axis_names else None


def dp_axes(mesh):
    """Batch-sharding axes: ("pod","data") on the multi-pod mesh."""

    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return axes if axes else None


def param_pspec(path, leaf, *, fsdp: bool) -> P:
    """The reference's rule for the leaf at ``path`` (its dict keys, the
    last one the leaf's name); ``leaf`` needs only ``ndim``."""

    name = path[-1]
    nd = leaf.ndim
    f = "data" if fsdp else None

    if name == "embed":
        return P("model", None)
    if name in _COL and nd >= 2:
        return P(*([None] * (nd - 2) + [f, "model"]))
    if name in _ROW and nd >= 2:
        return P(*([None] * (nd - 2) + ["model", f]))
    if name in _NOTP and nd >= 2:
        return P(*([None] * (nd - 2) + [f, None]))
    if name in _LASTDIM_MODEL:
        return P(*([None] * (nd - 1) + ["model"]))
    if name in _VEC_MODEL and nd >= 1:
        return P(*([None] * (nd - 1) + ["model"]))
    return P(*([None] * nd))


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def axes_size(mesh, entry) -> int:
    """The number of shards of a dim whose spec entry is ``entry``."""

    n = 1
    for a in _axes(entry):
        n *= mesh.shape[a]
    return n


def _drop_indivisible(spec: P, shape, mesh) -> P:
    """Drop sharding from dims the mesh axes don't divide (the reference's
    rule: jit requires exact divisibility — e.g. whisper's vocab 51865)."""

    out = []
    for dim, axes in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if axes is None:
            out.append(None)
            continue
        out.append(axes if dim % axes_size(mesh, axes) == 0 else None)
    return P(*out)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def shard_params(params, mesh, *, fsdp: bool = True):
    """The spec tree of a param tree (tensors, on any device, ``meta``
    included): :func:`param_pspec` with indivisible dims replicated."""

    def f(path, leaf):
        spec = param_pspec(path, leaf, fsdp=fsdp and _data_axis(mesh) is not None)
        return _drop_indivisible(spec, tuple(leaf.shape), mesh)

    return _map_with_path(f, params)


def shard_opt_state(opt_state, params_sharding, mesh):
    """m/v mirror the params; step is replicated."""

    return {"m": params_sharding, "v": params_sharding, "step": P()}


def batch_pspec(mesh, batch_size: int) -> P:
    """Batch tensors (B, ...). Falls back to replication when B is tiny."""

    axes = dp_axes(mesh)
    if axes is None:
        return P(None)
    if batch_size % axes_size(mesh, axes) != 0:
        return P(None)
    return P(axes)


def batch_sharding(mesh, batch_tree):
    """The spec of every tensor of a batch: its rows over the dp axes."""

    def f(_, leaf):
        spec = batch_pspec(mesh, leaf.shape[0])
        return P(*(list(spec) + [None] * (leaf.ndim - 1)))

    return _map_with_path(f, batch_tree)


def cache_pspec(mesh, shape) -> P:
    """Decode caches (L, B, S, H, Dh) / SSM states (L, B, H, N, P).

    B shards over the dp axes; dim 2 (cache length for KV caches, heads for
    SSM states) additionally shards over "model".  When B cannot shard (B=1
    long-context), dim 2 carries the data axes too.
    """

    axes = dp_axes(mesh)
    nd = len(shape)
    if axes is None or nd < 3:
        return P(*([None] * nd))
    size = axes_size(mesh, axes)
    model = mesh.shape.get("model", 1)
    b = shape[1]
    dim2 = []
    if model > 1 and shape[2] % model == 0:
        dim2 = ["model"]
    if b % size == 0:
        return P(*([None, axes] + [tuple(dim2) if dim2 else None] + [None] * (nd - 3)))
    if shape[2] % (size * model) == 0:
        return P(*([None, None, (axes + ("model",)) if dim2 else axes]
                   + [None] * (nd - 3)))
    return P(*([None, None] + [tuple(dim2) if dim2 else None] + [None] * (nd - 3)))


# -- shards of a full tensor ---------------------------------------------------


def _spec_entries(spec, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def local_shape(shape, spec: P, mesh) -> tuple:
    """A rank's shard shape of a ``shape`` tensor laid out by ``spec``."""

    return tuple(d // axes_size(mesh, e) for d, e in zip(shape, _spec_entries(spec, len(shape))))


def shard_index(mesh, entry) -> int:
    """This rank's block along a dim sharded on ``entry`` (row-major over
    a tuple of axes, as ``jax.sharding`` orders them)."""

    i = 0
    for a in _axes(entry):
        i = i * mesh.shape[a] + mesh.coord(a)
    return i


def local_slice(x, spec: P, mesh):
    """This rank's shard of the full tensor (or numpy array) ``x``: a view,
    narrowed along every sharded dim."""

    for dim, e in enumerate(_spec_entries(spec, x.ndim)):
        n = axes_size(mesh, e)
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of a {tuple(x.shape)} tensor does not split {n} ways "
                             f"over {e!r}")
        c = x.shape[dim] // n
        i = shard_index(mesh, e)
        x = x.narrow(dim, i * c, c) if hasattr(x, "narrow") else \
            x[(slice(None),) * dim + (slice(i * c, (i + 1) * c),)]
    return x


# -- activation specs ------------------------------------------------------------
#
# The reference pins activations with ``with_sharding_constraint`` at
# layer boundaries; GSPMD inserts the collectives.  The port's models lay
# their activations out themselves, and these functions give the spec a
# tensor of a given *global* shape has on ``mesh`` (``None`` where the
# reference's constraint is a no-op): ``spmd.Layout`` reads its sequence
# sharding from :func:`constrain_batch` and its context-parallel split
# from :func:`constrain_qkv_context_parallel`.  ``seq_shard`` is the
# reference's ``use_mesh_for_activations(mesh, seq_shard=)`` and
# ``manual`` its ``activation_manual_axes`` (the axes a surrounding
# shard_map body holds manual, which no spec may mention), passed here
# rather than installed.


def _drop_manual(axes, manual):
    """Filter manual axes out of one spec entry (name | tuple | None)."""

    if axes is None or not manual:
        return axes
    ax = axes if isinstance(axes, tuple) else (axes,)
    kept = tuple(a for a in ax if a not in manual)
    if not kept:
        return None
    return kept if isinstance(axes, tuple) else kept[0]


def constrain(mesh, shape, spec_axes: tuple, *, manual: Sequence[str] = ()) -> Optional[P]:
    """The spec the reference constrains a ``shape`` activation to for
    ``spec_axes`` (one entry per dim); indivisible or absent axes dropped.
    ``None`` without a mesh."""

    if mesh is None:
        return None
    out = []
    for dim, axes in zip(shape, spec_axes):
        axes = _drop_manual(axes, manual)
        if axes is None:
            out.append(None)
            continue
        ax = axes if isinstance(axes, tuple) else (axes,)
        if not all(a in mesh.axis_names for a in ax):
            out.append(None)
            continue
        out.append(axes if dim % axes_size(mesh, ax) == 0 else None)
    return P(*out)


def constrain_qkv_context_parallel(mesh, q_shape, k_shape, v_shape, n_heads: int, *,
                                   manual: Sequence[str] = ()):
    """Context-parallel attention for head counts the model axis can't
    split: the query *sequence* shards over "model" and every rank attends
    its rows against the full K/V.  ``(q, k, v)`` specs, or ``None`` when
    heads divide the axis, the sequence does not, or there is no mesh
    (the reference's no-op)."""

    if mesh is None or "model" not in mesh.axis_names:
        return None
    msize = mesh.shape["model"]
    if msize <= 1 or n_heads % msize == 0:
        return None
    if q_shape[1] % msize != 0 or q_shape[1] == 1:
        return None
    axes = dp_axes(mesh)
    return (constrain(mesh, q_shape, (axes, "model", None, None), manual=manual),
            constrain(mesh, k_shape, (axes, None, None, None), manual=manual),
            constrain(mesh, v_shape, (axes, None, None, None), manual=manual))


def constrain_batch(mesh, shape, *, extra: Optional[tuple] = None, allow_seq: bool = True,
                    seq_shard: bool = False, manual: Sequence[str] = ()) -> Optional[P]:
    """The spec of a (B, ...) activation batch-sharded over the dp axes
    (and its sequence over "model" under ``seq_shard``); ``extra`` is the
    spec's tail for the trailing dims (("model",) on the vocab dim of
    logits).  ``None`` where the reference's constraint is a no-op."""

    if mesh is None:
        return None
    axes = _drop_manual(dp_axes(mesh), manual)
    if axes is None:
        return None
    if shape[0] % axes_size(mesh, axes) != 0:
        return None
    tail = list(extra) if extra is not None else []
    nd = len(shape)
    mid = [None] * (nd - 1 - len(tail))
    model = mesh.shape.get("model", 1)
    if seq_shard and allow_seq and not tail and nd >= 3 and mid and shape[1] % model == 0 \
            and model > 1:
        mid[0] = "model"
    return P(*([axes] + mid + tail))


__all__ = [
    "P",
    "PodSplit",
    "axes_size",
    "batch_pspec",
    "batch_sharding",
    "cache_pspec",
    "constrain",
    "constrain_batch",
    "constrain_qkv_context_parallel",
    "dp_axes",
    "local_shape",
    "local_slice",
    "param_pspec",
    "shard_index",
    "shard_opt_state",
    "shard_params",
    "pod_batch_specs",
    "pod_class_indices",
    "pod_class_specs",
    "pod_decode_specs",
    "pod_state_specs",
    "pod_view",
    "gather_pods",
    "split_pods",
    "stitch_pods",
]
