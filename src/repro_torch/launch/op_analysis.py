"""Cost analysis of one eager step by its dispatched operators.

The port's counterpart of ``repro.launch.hlo_analysis`` (there is no HLO
to parse, hence the new name).  The reference AOT-compiles a cell and
walks the compiled HLO: FLOPs of every dot and convolution, the operand
and result bytes of every top-level kernel (the fusion boundary is the
HBM boundary), collective bytes, with while-loop trip counts.  The port
runs the cell's step under :func:`count_ops`, a ``TorchDispatchMode``
that sees every operator after autograd and the composite
decompositions, on the ``meta`` device (shapes only: no memory, no
kernel).  In eager PyTorch every operator is its own kernel, so its
operand and result bytes are its device-memory traffic, and a Python loop
is unrolled, so nothing needs a trip count.  Counted (all for one card):

  * ``flops`` — 2·M·N·K of every ``mm`` / ``addmm`` / ``bmm`` /
    ``baddbmm``, of every ``matmul``, ``linear`` and ``einsum`` that
    reaches the counter whole (under ``inference_mode`` the composite
    operators are not decomposed first) and of every convolution;
  * ``bytes`` — operand plus result bytes of every operator that is not a
    view (nor a composite that returned an alias of its input, such as a
    ``reshape`` that viewed); an expanded operand counts its distinct
    elements; an indexed
    read or write (``index``, ``gather``, ``embedding``, ``index_put_``,
    ``scatter``) counts the moved window twice plus its indices, not the
    whole indexed tensor, as the reference counts ``dynamic-slice`` and
    ``scatter``;
  * ``attn_score_bytes`` — the traffic of the plain attentions the meta
    device runs (``chunked_attention`` for a sequence,
    ``grouped_attention`` for a decode step's cache, the paged gather
    route) beyond reading their inputs and writing their output once: the
    scores, probabilities and fp32 copies that ``flash_attention_cuda``
    and ``paged_attention_cuda`` keep on chip;
  * ``collective_bytes`` by type — what the port's collectives report
    (``distributed.collectives.note_collective``) under the reference's
    ``hlo_analysis`` kinds (``all-gather``, ``reduce-scatter``,
    ``all-reduce``), one device's operand bytes: on a rank mesh the
    sharded step's FSDP gathers and gradient reduce-scatters, the tensor-
    and sequence-parallel boundaries, the vocab-parallel embedding and
    cross-entropy, the dp gradient sums and the norm; on one card the
    class-sharded step's cross-pod reduction and the int8 cross-pod mean;
  * the GEMM funnel apart — ``gemm_calls`` and ``gemm_flops`` (Σ 2·M·N·K)
    of every product through ``execution.dispatch_gemm``: the calls a card
    run launches a kernel for;
  * ``peak_live_bytes`` — the most bytes that storages created inside the
    count held at once: a storage is added when an operator creates it and
    released by a finalizer when its last tensor dies.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from collections import defaultdict
from typing import Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# Operators that move no data: allocation without a fill, aliases.
_NO_TRAFFIC = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "detach", "alias", "_unsafe_view", "lift_fresh", "set_", "resize_",
    "_local_scalar_dense", "sym_size", "sym_stride", "sym_numel", "is_same_size",
    "_has_compatible_shallow_copy_type",
})
# Indexed reads: the window read and written is the result.
_READ_WINDOW = frozenset({"index", "index_select", "gather", "embedding", "take"})
# Indexed writes: the window is the values written (``src``, the last
# tensor operand).
_WRITE_WINDOW = frozenset({
    "index_put", "index_put_", "_index_put_impl_", "_index_put_impl",
    "scatter", "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
    "scatter_reduce_", "index_add", "index_add_", "index_copy", "index_copy_",
    "slice_scatter", "select_scatter",
})
_DOTS = frozenset({"mm", "addmm", "bmm", "baddbmm"})
_CONVS = frozenset({"convolution", "_convolution", "conv1d", "conv2d", "conv3d"})


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t``'s distinct elements (a broadcast dim counts once)."""

    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def tree_bytes(tree) -> int:
    """Bytes of every tensor of a nested structure (``numel · itemsize``)."""

    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _dot_flops(name: str, args) -> float:
    a, b = (args[1], args[2]) if name in ("addmm", "baddbmm") else (args[0], args[1])
    if name in ("mm", "addmm"):
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


def _composite_flops(name: str, args, out: torch.Tensor) -> float:
    """2 x every output element x the length of its reduction."""

    if name == "einsum":
        eq, ops = args[0].replace(" ", ""), args[1]
        lhs, _, rhs = eq.partition("->")
        sizes = {}
        for term, t in zip(lhs.split(","), ops):
            for letter, size in zip(term.replace("...", ""), t.shape[t.ndim - len(term.replace("...", "")):]):
                sizes[letter] = size
        return 2.0 * out.numel() * math.prod(v for c, v in sizes.items() if c not in rhs)
    return 2.0 * out.numel() * args[0].shape[-1]  # matmul, linear


def _conv_flops(args, out: torch.Tensor) -> float:
    # 2 x every output element x its receptive field (input channels of
    # its group x the kernel's extent).
    w = args[1]
    return 2.0 * out.numel() * math.prod(w.shape[1:])


@dataclasses.dataclass
class OpCost:
    flops: float = 0.0
    bytes: float = 0.0
    attn_score_bytes: float = 0.0
    collective_bytes: float = 0.0
    by_collective: dict = dataclasses.field(default_factory=dict)
    dot_count: int = 0
    # Kept for the reference's record shape: eager loops are unrolled, so
    # no operator repeats by a trip count.
    while_trips: dict = dataclasses.field(default_factory=dict)
    gemm_calls: int = 0
    gemm_flops: float = 0.0
    peak_live_bytes: int = 0
    live_bytes: int = 0
    op_count: int = 0
    by_op_bytes: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    by_op_flops: dict = dataclasses.field(default_factory=lambda: defaultdict(float))
    _live: dict = dataclasses.field(default_factory=dict, repr=False)
    # Storages some operator read or wrote (to tell the arguments a step
    # uses from those it never touches, which XLA prunes from its program).
    touched: set = dataclasses.field(default_factory=set, repr=False)

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "attn_score_bytes": self.attn_score_bytes,
            "collective_bytes": self.collective_bytes,
            "by_collective": dict(self.by_collective),
            "dot_count": self.dot_count,
            "while_trips": dict(self.while_trips),
            "gemm_calls": self.gemm_calls,
            "gemm_flops": self.gemm_flops,
        }

    def top(self, n: int = 20) -> dict:
        """The operators moving the most bytes and doing the most FLOPs."""

        pick = lambda d: sorted(((v, k) for k, v in d.items()), reverse=True)[:n]  # noqa: E731
        return {"bytes": pick(self.by_op_bytes), "flops": pick(self.by_op_flops)}

    # -- accounting --------------------------------------------------------

    def _release(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _track(self, out: torch.Tensor, inputs: set) -> None:
        storage = out.untyped_storage()
        key = storage._cdata
        if key in inputs or key in self._live:
            return
        self._live[key] = storage.nbytes()
        self.live_bytes += storage.nbytes()
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        weakref.finalize(storage, self._release, key)

    def account(self, func, args, kwargs, out) -> None:
        name = func.overloadpacket.__name__
        outs = _tensors(out)
        ins = _tensors(args) + _tensors(kwargs)
        keys = {t.untyped_storage()._cdata for t in ins}
        self.touched |= keys
        for t in outs:
            self._track(t, keys)
        if func.is_view or name in _NO_TRAFFIC:
            return
        if (outs and not func._schema.is_mutable
                and all(t.untyped_storage()._cdata in keys for t in outs)):
            return  # a composite that returned an alias of its input
        self.op_count += 1
        if name in _DOTS:
            fl = _dot_flops(name, args)
        elif name in ("matmul", "linear", "einsum"):
            fl = _composite_flops(name, args, outs[0])
        elif name in _CONVS:
            fl = _conv_flops(args, outs[0])
        else:
            fl = 0.0
        if fl:
            self.flops += fl
            self.dot_count += 1
            self.by_op_flops[name] += fl
        if name in _READ_WINDOW:
            idx = sum(distinct_bytes(t) for t in ins[1:])
            b = 2 * sum(distinct_bytes(t) for t in outs) + idx
        elif name in _WRITE_WINDOW:
            b = 2 * distinct_bytes(ins[-1]) + sum(distinct_bytes(t) for t in ins[1:-1])
        else:
            b = sum(distinct_bytes(t) for t in ins) + sum(distinct_bytes(t) for t in outs)
        self.bytes += b
        self.by_op_bytes[name] += b


class _CountingMode(TorchDispatchMode):
    def __init__(self, cost: OpCost):
        super().__init__()
        self.cost = cost

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.cost.account(func, args, kwargs, out)
        return out


def _attention_region(cost: OpCost, fn):
    """``fn`` (a plain attention) counting what it moves beyond reading its
    tensor inputs and writing its output once as score traffic."""

    def counted(*args):
        before = cost.bytes
        out = fn(*args)
        io = sum(distinct_bytes(t) for t in _tensors(args) + [out])
        cost.attn_score_bytes += max(cost.bytes - before - io, 0.0)
        return out

    return counted


def _funnel_entries(cost: OpCost) -> dict:
    """The dispatch-table entries wrapped to count: every GEMM entry (the
    funnel's calls and 2·M·N·K) and the plain attention entries (their
    score traffic)."""

    from repro_torch.core import execution as X

    def gemm(fn):
        def counted(a2, b, config, out_dtype):
            cost.gemm_calls += 1
            cost.gemm_flops += 2.0 * a2.shape[0] * a2.shape[1] * b.shape[1]
            return fn(a2, b, config, out_dtype)

        return counted

    wrapped = {name: gemm(fn) for name, fn in X.BACKENDS.items() if X.BACKEND_OPS[name] == "gemm"}
    for name in ("flash_attn_torch", "paged_attn_torch"):
        wrapped[name] = _attention_region(cost, X.BACKENDS[name])
    return wrapped


@contextlib.contextmanager
def count_ops() -> Iterator[OpCost]:
    """Count what runs inside: ``with count_ops() as cost: step(...)``.

    The dispatch table's GEMM entries and plain attention entries, and
    the dense decode's ``layers.grouped_attention``, are wrapped for the
    duration (restored on exit), and the port's collectives report to the
    counter.  Those are process-wide: count one step at a time, from one
    thread.
    """

    from repro_torch.core import execution as X
    from repro_torch.distributed import collectives as C
    from repro_torch.models import layers as L

    cost = OpCost(by_collective=defaultdict(float))

    def collective(kind: str, nbytes: int) -> None:
        cost.collective_bytes += nbytes
        cost.by_collective[kind] += nbytes

    saved, grouped = dict(X.BACKENDS), L.grouped_attention
    X.BACKENDS.update(_funnel_entries(cost))
    L.grouped_attention = _attention_region(cost, grouped)
    C.COLLECTIVE_OBSERVERS.append(collective)
    try:
        with _CountingMode(cost):
            yield cost
    finally:
        C.COLLECTIVE_OBSERVERS.remove(collective)
        L.grouped_attention = grouped
        X.BACKENDS.update(saved)
        cost.by_collective = dict(cost.by_collective)


__all__ = ["OpCost", "count_ops", "distinct_bytes", "tree_bytes"]
