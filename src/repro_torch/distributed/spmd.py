"""The rank-local step of a (data, model) mesh: the port's stand-in for
GSPMD's partitioner.

The reference writes one global program and lets GSPMD partition it over
the mesh by the specs of ``distributed/sharding.py``.  The port runs one
process a rank, each holding its shards, and the models lay out their
activations and call the collectives of ``distributed/collectives.py``
themselves.  This module holds what they share:

  * :class:`Layout` — the mesh, the spec tree of the params (the
    reference's rules, indivisible dims replicated) and ``seq_shard``;
    read once when a step is built;
  * a sharded parameter tree is the params' own nested dict holding each
    rank's shard (:func:`shard_tree`, :func:`init_sharded`), beside its
    spec tree; :func:`gather_full` joins the shards back;
  * FSDP gather-on-use (:func:`use`): a weight's shard, already cast to
    bf16 (half the bytes, the same values), all-gathered over the dims its
    spec shards on ``data`` (and on ``model`` where the caller needs the
    whole of that dim); the backward reduce-scatters the gradient;
  * column- and row-parallel application (:func:`column`, :func:`row`)
    through ``ops.gemm`` at the rank-local shapes, the same as a plain
    bf16 product outside the funnel (:func:`plain`: Mamba2's projections
    and the MoE experts, plain products on one card too), and the region
    boundaries (:func:`tp_enter`, :func:`tp_exit`) between the residual
    stream's layout and a tensor-parallel region;
  * a norm over a feature axis split over ``model`` (:func:`rms_norm_split`)
    and the test for a dim the reference's ``_drop_indivisible`` left whole
    (:func:`splits_model`: whisper's 51,865-wide vocab is replicated);
  * the gradient step's reductions: :func:`sync_grads` sums the gradient
    of a leaf replicated over a dp axis over that axis, and
    :func:`global_norm` counts each leaf once.

The residual stream of a step is batch-sharded over the dp axes and, with
``seq_shard`` (Megatron's sequence parallelism, the reference's dry-run
setting) and a sequence the ``model`` axis divides, sequence-sharded
over ``model``; otherwise replicated over ``model``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import RankMesh
from repro_torch.optim import adamw as O


@dataclasses.dataclass(frozen=True, eq=False)
class Layout:
    """A sharded step's mesh, its params' spec tree and ``seq_shard``."""

    mesh: object
    specs: dict
    seq_shard: bool = False
    # Are the step's rows split over the dp axes?  A decode batch the dp
    # axes do not divide (a batch of 1) is replicated there.
    rows_split: bool = True

    @property
    def model(self) -> int:
        return self.mesh.shape.get("model", 1)

    @property
    def model_index(self) -> int:
        return self.mesh.coord("model")

    @property
    def dp(self):
        return SH.dp_axes(self.mesh)

    def _global_rows(self, b: int) -> int:
        return b * SH.axes_size(self.mesh, self.dp) if self.rows_split else b

    def seq_sharded(self, shape) -> bool:
        """Is a residual stream of this rank's ``(rows, positions, width)``
        sequence-sharded over ``model``, as the reference's
        ``constrain_batch`` pins it?"""

        b, s, d = shape
        spec = SH.constrain_batch(self.mesh, (self._global_rows(b), s, d),
                                  seq_shard=self.seq_shard)
        return spec is not None and spec[1] == "model"

    def context_parallel(self, b: int, s: int, cfg) -> bool:
        """Does attention over this rank's ``b`` rows of ``s`` positions
        take the context-parallel query split of the reference's
        ``constrain_qkv_context_parallel`` (``cfg.n_heads`` not divisible
        by ``model``, ``s`` divisible)?"""

        b = self._global_rows(b)
        kv = (b, s, cfg.n_kv_heads, cfg.d_head)
        return SH.constrain_qkv_context_parallel(self.mesh, (b, s, cfg.n_heads, cfg.d_head), kv,
                                                 kv, cfg.n_heads) is not None


def is_sharded(mesh) -> bool:
    """Does ``mesh`` take the sharded step (a rank mesh, abstract or not)?"""

    return isinstance(mesh, RankMesh)


def param_specs(params, mesh, *, fsdp: bool) -> dict:
    """The spec tree of a full-shape param tree (on ``meta`` is enough)."""

    return SH.shard_params(params, mesh, fsdp=fsdp)


def layer_specs(specs):
    """A stacked tree's specs without the leading (layer) dim."""

    return O.tree_map(lambda s: SH.P(*s[1:]), specs)


def _entries(spec, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def global_shape(shape, spec, mesh) -> tuple:
    return tuple(d * SH.axes_size(mesh, e) for d, e in zip(shape, _entries(spec, len(shape))))


def use(w: torch.Tensor, spec, lay: Layout, *, gather_model: bool = False,
        model_grad: str = "reduce_scatter") -> torch.Tensor:
    """The weight a rank computes with: its shard gathered over every dim
    its spec shards on a dp axis (FSDP; the backward reduce-scatters),
    and with ``gather_model`` over the ``model`` dims too (the backward as
    ``model_grad`` says: ``"reduce_scatter"`` when the model ranks use the
    whole weight for distinct work, ``"slice"`` when they compute the same
    thing).  The caller casts fp32 masters to bf16 first."""

    for dim, e in enumerate(_entries(spec, w.ndim)):
        for a in SH._axes(e):
            if a == "model" and not gather_model:
                continue
            w = C.gather(w, lay.mesh, a, dim, grad=model_grad if a == "model" else "reduce_scatter")
    return w


def splits_model(spec, dim: int) -> bool:
    """Does ``spec`` split ``dim`` over ``model``?"""

    return "model" in SH._axes(_entries(spec, dim + 1)[dim])


def require_model(spec, name: str, lay: Layout, dim: int) -> None:
    """The sharded step splits ``name`` over ``model`` on ``dim``; a spec
    that replicates it there (the dim is indivisible) is refused."""

    if lay.model > 1 and not splits_model(spec, dim):
        raise ValueError(f"{name}: dim {dim} is not split over model={lay.model} (its spec "
                         f"{spec!r}); the sharded step needs it divisible")


def column(x, w, spec, lay: Layout, b=None, b_spec=None, *, gather_model=False,
           model_grad="reduce_scatter"):
    """Column-parallel ``x · W (+ b)`` through ``ops.gemm``: this rank's
    output features (all of them with ``gather_model``)."""

    from repro_torch.kernels import ops

    kw = dict(gather_model=gather_model, model_grad=model_grad)
    if b is not None:
        b = use(b, b_spec, lay, **kw)
    return ops.linear(x, use(w, spec, lay, **kw), b)


def row(x, w, spec, lay: Layout, *, gather_model=False, model_grad="reduce_scatter",
        out_dtype=None):
    """Row-parallel ``x · W`` through ``ops.gemm`` on this rank's input
    features: a partial sum over ``model`` (the whole product with
    ``gather_model``), in ``out_dtype`` (the kernel's fp32 accumulator
    for a partial that :func:`tp_exit` reduces)."""

    from repro_torch.kernels import ops

    return ops.gemm(x, use(w, spec, lay, gather_model=gather_model, model_grad=model_grad),
                    out_dtype=out_dtype)


def plain(x, w, spec, lay: Layout, *, gather_model=False, model_grad="reduce_scatter"):
    """:func:`column` / :func:`row` as a plain bf16 product
    (``torch.matmul``, batched over leading dims), outside the GEMM funnel:
    the products the port keeps plain on one card."""

    w = use(w.to(torch.bfloat16), spec, lay, gather_model=gather_model, model_grad=model_grad)
    return torch.matmul(x.to(torch.bfloat16), w)


def rms_norm_split(x, w, lay: Layout, eps: float = 1e-5):
    """:func:`models.layers.rms_norm` over a last dim split over ``model``
    (this rank's features and their ``w``): the sum of squares is summed
    over ``model`` before the scale, its backward summed too."""

    xf = x.float()
    ss = C.total(torch.sum(xf * xf, dim=-1, keepdim=True), lay.mesh, "model")
    var = ss / (x.shape[-1] * lay.model)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def tp_enter(x, lay: Layout, seq: bool):
    """The residual stream into a tensor-parallel region, whole over
    ``model``: all-gathered along the sequence when it is sequence-sharded
    (``seq``; the backward reduce-scatters), else the identity whose
    backward all-reduces the partial input gradients."""

    if seq:
        return C.gather(x, lay.mesh, "model", 1)
    return C.enter(x, lay.mesh, "model")


def tp_exit(h, lay: Layout, seq: bool):
    """A region's partial sums over ``model`` (fp32: ``row(...,
    out_dtype=torch.float32)``) back to the residual layout, in bf16:
    reduce-scattered along the sequence (``seq``), else all-reduced, and
    rounded once, as one card rounds the whole sum (bf16 partials, each
    rounded on its rank, move the reduced hybrid's gradients by 3%)."""

    if seq:
        return C.scatter(h, lay.mesh, "model", 1).to(torch.bfloat16)
    return C.reduce(h, lay.mesh, "model").to(torch.bfloat16)


def norm_weight(w, lay: Layout, seq: bool):
    """A replicated norm weight applied to a sequence-sharded stream: its
    gradient is partial over ``model`` and all-reduced."""

    return C.enter(w, lay.mesh, "model") if seq else w


# ---------------------------------------------------------------------------
# Sharded trees
# ---------------------------------------------------------------------------


def map_specs(fn, tree, *spec_trees):
    """``fn(leaf, spec, ...)`` over a tree and spec trees of its structure."""

    if isinstance(tree, dict):
        return {k: map_specs(fn, v, *(s[k] for s in spec_trees)) for k, v in tree.items()}
    return fn(tree, *spec_trees)


def localize(tree, specs, mesh, full):
    """A tree of shards or of full tensors as this rank's shards: a leaf
    at its shard's shape is kept, one at its full shape (``full``'s leaf
    shape, e.g. a ``meta`` tree) is cut (a copy)."""

    def f(x, spec, ref):
        shape = tuple(ref.shape)
        if tuple(x.shape) == SH.local_shape(shape, spec, mesh):
            return x
        if tuple(x.shape) == shape:
            return SH.local_slice(x, spec, mesh).clone()
        raise ValueError(f"a {tuple(x.shape)} leaf is neither the {shape} tensor nor its "
                         f"{SH.local_shape(shape, spec, mesh)} shard under {spec!r}")

    return map_specs(f, tree, specs, full)


def shard_tree(tree, specs, mesh, *, device=None, requires_grad: Optional[bool] = None):
    """Each rank's shard of a full tree (tensors or numpy arrays): copies,
    so the full leaves can be freed; on ``device`` when given."""

    def f(x, spec):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(x)
        t = SH.local_slice(x, spec, mesh).to(device if device is not None else x.device,
                                             copy=True).contiguous()
        if requires_grad is not None and t.is_floating_point():
            t.requires_grad_(requires_grad)
        return t

    return map_specs(f, tree, specs)


def gather_full(tree, specs, mesh):
    """The full tensors of a sharded tree, on every rank (no autograd)."""

    def f(x, spec):
        x = x.detach()
        for dim, e in enumerate(_entries(spec, x.ndim)):
            for a in reversed(SH._axes(e)):
                x = C.all_gather(x, mesh, a, dim)
        return x

    return map_specs(f, tree, specs)


def init_sharded(init, generator, specs, mesh):
    """``init(generator, device)``'s tree as this rank's shards, built one
    leaf at a time:
    every leaf ``layers.dense_init`` / ``embed_init`` draws is cut to its
    shard as it is made and the full leaf freed, so the transient is one
    leaf, not the tree.  ``init`` draws the same numbers in the same order
    as an unsharded call: the shards are that tree's slices.  A run on the
    ``meta`` device first names each drawn leaf's path."""

    from repro_torch.models import layers as L

    made = []
    with L.init_placement(lambda w: made.append(w) or w):
        tree = init(None, "meta")
    order = {}

    def walk(node, path=()):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            order[id(node)] = path

    walk(tree)
    paths = [order.get(id(w)) for w in made]
    del made, tree
    it = iter(paths)

    def spec_at(path):
        node = specs
        for k in path:
            node = node[k]
        return node

    def place(w):
        path = next(it)
        if path is None:
            return w
        return SH.local_slice(w, spec_at(path), mesh).clone()

    with L.init_placement(place):
        tree = init(generator, mesh.device)
    placed = set(paths)

    def finish(node, spec, path=()):  # the leaves no init call drew (norms, biases)
        if isinstance(node, dict):
            return {k: finish(v, spec[k], path + (k,)) for k, v in node.items()}
        return node if path in placed else SH.local_slice(node, spec, mesh).clone()

    return finish(tree, specs)


def sync_grads(grads, specs, mesh):
    """Sum each gradient over the dp axes its leaf is replicated on (the
    ranks there saw different rows); an FSDP leaf's ``data`` sum already
    came from its gather's backward."""

    dp = SH.dp_axes(mesh) or ()

    def f(g, spec):
        used = {a for e in spec for a in SH._axes(e)}
        axes = tuple(a for a in dp if a not in used)
        return C.all_reduce(g, mesh, axes) if axes else g

    return map_specs(f, grads, specs)


def global_norm(tree, specs, mesh) -> torch.Tensor:
    """The global L2 norm of a sharded tree: each leaf's local sum of
    squares divided by its replication factor, all-reduced over the world,
    so a replicated leaf counts once."""

    leaves, spec_leaves = O.tree_leaves(tree), O.tree_leaves(specs)
    parts = []
    for x, spec in zip(leaves, spec_leaves):
        shards = 1
        for e in spec:
            shards *= SH.axes_size(mesh, e)
        parts.append(torch.sum(torch.square(x.float())) * (shards / mesh.world))
    total = C.all_reduce(torch.sum(torch.stack(parts)), mesh, tuple(mesh.axis_names))
    return torch.sqrt(total)


def dp_sum(x, mesh):
    """A per-rank loss term summed over the dp axes (no autograd)."""

    return C.all_reduce(x, mesh, SH.dp_axes(mesh))


__all__ = [
    "Layout",
    "column",
    "dp_sum",
    "gather_full",
    "global_norm",
    "global_shape",
    "init_sharded",
    "is_sharded",
    "layer_specs",
    "localize",
    "map_specs",
    "norm_weight",
    "param_specs",
    "plain",
    "require_model",
    "rms_norm_split",
    "row",
    "shard_tree",
    "splits_model",
    "sync_grads",
    "tp_enter",
    "tp_exit",
    "use",
]
