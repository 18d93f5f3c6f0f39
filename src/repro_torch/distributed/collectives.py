"""Collectives (the port's ``repro.distributed.collectives``).

Two parts.  The mesh collectives of the sharded step
(``distributed/spmd.py``): all-gather, reduce-scatter and all-reduce over
the process group of one or more axes of a
:class:`~repro_torch.launch.mesh.RankMesh`, each an explicit call on that
group, and their autograd forms:

  * :func:`gather` — all-gather along a dim; its backward reduce-scatters
    (``grad="reduce_scatter"``: the ranks used the gathered tensor for
    distinct work, as FSDP's gathered weights or a gathered sequence) or
    takes this rank's slice (``grad="slice"``: the ranks computed the same
    thing from it);
  * :func:`scatter` — reduce-scatter along a dim; its backward all-gathers;
  * :func:`reduce` — all-reduce (Megatron's ``g``, a row-parallel
    output); its backward is the identity;
  * :func:`enter` — the identity (Megatron's ``f``, a column-parallel
    input); its backward all-reduces;
  * :func:`total` — all-reduce whose backward all-reduces too: a sum of
    partial terms (a norm's sum of squares over a split feature axis)
    that each rank then reads for its own part of the work;
  * :func:`split` — this rank's block of a replicated tensor; its
    backward all-gathers (every rank's gradient of the whole).

Each reports through :func:`note_collective` under the reference's HLO
op name with the operand bytes of one device, in the forward and the
backward alike.  On an abstract mesh (the dry-run's, on the ``meta``
device) they only make shapes.  Under ``gloo`` a CUDA tensor is staged
through host memory (:func:`_staged`, the one place that does it).

Then the distributed-optimization reduction across pods:

``compressed_crosspod_mean`` is the int8-quantized gradient reduction
across pods with error feedback: each pod quantizes ``g + err`` to int8
with one fp32 scale, keeps the quantization residual as its next ``err``,
and every pod's int8 blocks are summed back in fp32 and divided by the
pod count.  Wire bytes drop 4x against an fp32 all-reduce; the residual
carried to the next step keeps convergence unbiased in practice [Seide
et al. 2014; Karimireddy et al. 2019].

In the reference the pods are shards of a ``shard_map`` and the int8
blocks travel by ``all_gather``.  With a rank a pod (a ``RankMesh`` with a
``pod`` axis) so do the port's: each rank passes its own tree and the
codes and scales are all-gathered over the pod group.  With the pods as
streams in one process the function takes a list of per-pod gradient
trees and the gather is the list.  Neither package wires the reduction
into a training step: the class-sharded step reduces exactly
(``runtime.trainer.weighted_mean_epilogue``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

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


def _crosspod_mean_rank(g: torch.Tensor, err: torch.Tensor, mesh, axis: str):
    """One leaf on a rank: quantize ``g + err``, all-gather the int8 codes
    and the scales over the pod group, sum them in fp32, divide by the pod
    count (the reference's ``_crosspod_mean_one`` in its ``shard_map``)."""

    gf = g.float() + err
    q, scale = quantize_int8(gf)
    new_err = gf - dequantize_int8(q, scale)
    qs = all_gather(q[None], mesh, axis, 0)               # (n_pods, ...) int8 on the wire
    scales = all_gather(scale.reshape(1), mesh, axis, 0)  # (n_pods,) fp32
    mean = torch.tensordot(scales, qs.float(), dims=([0], [0]))
    return (mean / mesh.size(axis)).to(g.dtype), new_err


def compressed_crosspod_mean(grads, err_trees, mesh=None, *, axis: str = "pod"):
    """Mean of per-pod gradient trees with an int8 wire format.

    With the pods as streams: ``grads`` is one tree per pod, each already
    reduced within its pod (a per-pod mean), ``err_trees`` the pods'
    error-feedback residuals (the same structure, fp32); returns
    ``(mean_grads, new_err_trees)``: one tree, the same on every pod, and
    one residual tree per pod.  On a ``RankMesh`` (a rank a pod) ``grads``
    and ``err_trees`` are this rank's own trees, as the reference's
    arguments are, and it returns the mean (the same on every rank) and
    this rank's new residual tree.  A ``mesh`` without the pod axis has
    one pod and passes its tree and residual through, as the reference
    does.
    """

    if hasattr(mesh, "coord"):
        if mesh.size(axis) == 1:
            return grads, err_trees
        flat_e = tree_leaves(err_trees)
        out = [_crosspod_mean_rank(g, e, mesh, axis) for g, e in zip(tree_leaves(grads), flat_e)]
        return (tree_unflatten(grads, [m for m, _ in out]),
                tree_unflatten(grads, [e for _, e in out]))
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


# ---------------------------------------------------------------------------
# Mesh collectives
# ---------------------------------------------------------------------------


def _staged(mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` as the backend takes it: contiguous, and in host memory when a
    CUDA tensor meets ``gloo`` (which reduces on the host)."""

    x = x.contiguous()
    if mesh.transport == "gloo" and x.is_cuda:
        return x.cpu()
    return x


def all_gather(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """Concatenate the ranks' ``x`` along ``dim`` over ``axes``, in the
    row-major order of the ranks' coordinates."""

    n = mesh.size(axes)
    if n == 1:
        return x
    note_collective("all-gather", x)
    shape = list(x.shape)
    shape[dim] *= n
    if mesh.is_abstract:
        return x.new_empty(shape)
    import torch.distributed as dist

    xs = _staged(mesh, x)
    out = xs.new_empty((n * x.shape[0],) + tuple(x.shape[1:]) if x.ndim else (n,))
    dist.all_gather_into_tensor(out, xs.reshape(-1) if not x.ndim else xs, group=mesh.group(axes))
    return out.to(x.device).reshape((n,) + tuple(x.shape)).movedim(0, dim).reshape(shape)


def reduce_scatter(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """Sum ``x`` over ``axes`` and keep this rank's block along ``dim``."""

    n = mesh.size(axes)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of a {tuple(x.shape)} tensor does not split {n} ways")
    note_collective("reduce-scatter", x)
    shape = list(x.shape)
    shape[dim] //= n
    if mesh.is_abstract:
        return x.new_empty(shape)
    import torch.distributed as dist

    xs = _staged(mesh, x.movedim(dim, 0))
    out = xs.new_empty((xs.shape[0] // n,) + tuple(xs.shape[1:]))
    dist.reduce_scatter_tensor(out, xs, group=mesh.group(axes))
    return out.to(x.device).movedim(0, dim).contiguous()


def all_reduce(x: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    """``x`` summed (``op="max"``: maxed) over ``axes``; a new tensor."""

    if mesh.size(axes) == 1:
        return x
    note_collective("all-reduce", x)
    if mesh.is_abstract:
        return x.new_empty(x.shape)
    import torch.distributed as dist

    xs = _staged(mesh, x)
    if xs is x:
        xs = x.clone()
    dist.all_reduce(xs, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                    group=mesh.group(axes))
    return xs.to(x.device)


def pod_values(value, mesh, axis: str = "pod") -> Optional[list]:
    """Every pod's ``value`` (a float from this rank's pod, or ``None``),
    in pod order, the same list on every rank: all-gathered over the pod
    group.  ``None`` when any pod gave ``None``."""

    x = torch.tensor([math.nan if value is None else float(value)], dtype=torch.float64,
                     device=mesh.device)
    out = all_gather(x, mesh, axis, 0).tolist()
    return None if any(math.isnan(v) for v in out) else out


def _digest(x: torch.Tensor) -> torch.Tensor:
    """Two int64 sums over a tensor's bits (the values reinterpreted as
    integers, and their squares, wrapping): equal tensors give equal
    digests."""

    bits = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.int8}[x.element_size()]
    v = x.detach().contiguous().reshape(-1).view(bits).to(torch.int64)
    return torch.stack([v.sum(), (v * v).sum()])


def check_replicas(tree, mesh, axis: str = "pod") -> None:
    """Raise unless every leaf of ``tree`` is bitwise the same on every rank
    of the ``axis`` group: each rank's digests of every leaf all-gathered
    and compared (a ``ValueError`` naming the first leaf that differs)."""

    leaves = tree_leaves(tree)
    mine = torch.stack([_digest(x) for x in leaves])
    every = all_gather(mine[None], mesh, axis, 0)
    for j in range(len(leaves)):
        if not bool((every[:, j] == every[0, j]).all()):
            raise ValueError(f"leaf {j} of {len(leaves)} differs between the ranks of {axis!r}: "
                             f"digests {every[:, j].tolist()}")


def local_block(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over ``axes`` (no
    communication)."""

    n = mesh.size(axes)
    if n == 1:
        return x
    c = x.shape[dim] // n
    return x.narrow(dim, mesh.index(axes) * c, c)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim, grad):
        ctx.args = (mesh, axes, dim, grad)
        return all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim, grad = ctx.args
        if grad == "slice":
            return local_block(g, mesh, axes, dim).contiguous(), None, None, None, None
        return reduce_scatter(g, mesh, axes, dim), None, None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return reduce_scatter(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        return all_gather(g, mesh, axes, dim), None, None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return all_reduce(g, mesh, axes), None, None


class _Total(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        mesh, axes = ctx.args
        return all_reduce(g, mesh, axes), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return local_block(x, mesh, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        mesh, axes, dim = ctx.args
        return all_gather(g, mesh, axes, dim), None, None, None


def _differentiable(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def gather(x, mesh, axes, dim: int, *, grad: str = "reduce_scatter"):
    """All-gather along ``dim``; the backward reduce-scatters, or with
    ``grad="slice"`` keeps this rank's block."""

    if mesh.size(axes) == 1:
        return x
    if not _differentiable(x):
        return all_gather(x, mesh, axes, dim)
    return _Gather.apply(x, mesh, axes, dim, grad)


def scatter(x, mesh, axes, dim: int):
    """Reduce-scatter along ``dim``; the backward all-gathers."""

    if mesh.size(axes) == 1:
        return x
    if not _differentiable(x):
        return reduce_scatter(x, mesh, axes, dim)
    return _Scatter.apply(x, mesh, axes, dim)


def reduce(x, mesh, axes):
    """All-reduce (sum); the backward is the identity."""

    if mesh.size(axes) == 1:
        return x
    if not _differentiable(x):
        return all_reduce(x, mesh, axes)
    return _Reduce.apply(x, mesh, axes)


def enter(x, mesh, axes):
    """The identity; the backward all-reduces."""

    if mesh.size(axes) == 1 or not _differentiable(x):
        return x
    return _Enter.apply(x, mesh, axes)


def total(x, mesh, axes):
    """All-reduce (sum) of partial terms; the backward all-reduces too."""

    if mesh.size(axes) == 1:
        return x
    if not _differentiable(x):
        return all_reduce(x, mesh, axes)
    return _Total.apply(x, mesh, axes)


def split(x, mesh, axes, dim: int):
    """This rank's block of a tensor replicated over ``axes``; the
    backward all-gathers."""

    if mesh.size(axes) == 1:
        return x
    if not _differentiable(x):
        return local_block(x, mesh, axes, dim)
    return _Split.apply(x, mesh, axes, dim)


__all__ = [
    "COLLECTIVE_OBSERVERS",
    "all_gather",
    "all_reduce",
    "check_replicas",
    "enter",
    "gather",
    "local_block",
    "reduce",
    "reduce_scatter",
    "scatter",
    "split",
    "total",
    "note_collective",
    "pod_values",
    "quantize_int8",
    "dequantize_int8",
    "compressed_crosspod_mean",
    "init_error_feedback",
]
