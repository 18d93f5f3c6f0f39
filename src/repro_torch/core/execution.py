"""Class-routed execution contexts: one ambient control tree per device class.

The port's counterpart of ``repro.core.execution``:

  * :class:`ExecutionContext` — a context manager binding one device
    class's :class:`~repro_torch.core.control_tree.ControlTree` as the
    ambient configuration.  Every :func:`repro_torch.kernels.ops.gemm`
    call underneath takes its backend and block shapes from it, so model
    code never threads ``config=``/``backend=`` by hand.
  * the **backend dispatch table** (:data:`BACKENDS`) — the one
    vocabulary of kernel implementations, tagged by op family.
  * :func:`resolve_block_config` — the ``$REPRO_TORCH_TUNING_CACHE`` entry
    for the class's Hopper spec when its kernel can hold it, else the
    analytical derivation under that spec.
  * :func:`class_sharded` — per-class programs in one step: each pod's
    shard runs under its own class's context, on its own CUDA stream.

Names against the reference's vocabulary:

  ============================  ===========================================
  port                          reference
  ============================  ===========================================
  ``matmul``                    ``xla`` (the framework's own matmul)
  ``cuda``                      ``pallas`` (``gemm_cuda``)
  ``cuda_lean``                 ``pallas_lean`` (``gemm_cuda_lean``)
  ``torch_ref`` / ``_lean``     ``pallas_interpret`` / ``pallas_lean_interpret``
  ``paged_attn_torch``          ``paged_attn_xla`` (the gather route)
  ``paged_attn_cuda``           ``paged_attn_pallas``
  ``flash_attn_torch``          ``chunked_attention`` (the portable path)
  ``flash_attn_cuda``           ``flash_attention`` (the Pallas kernel)
  ============================  ===========================================

The ``cuda`` entries launch their kernel for CUDA tensors and run the
kernel's plain PyTorch version for CPU tensors; the ``torch_ref`` twins
run the plain version on any device (the role the reference's
interpret-mode twins play).  ``flash_attn_cuda`` raises for CPU tensors:
the forward's CPU route is ``flash_attn_torch`` (``chunked_attention``),
which ``"auto"`` picks for them.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import TYPE_CHECKING, Callable, Literal, Optional, Sequence

import torch

from repro_torch.core.blocking import (
    H100,
    MIN_PIPELINE_STAGES,
    PIPELINE_STAGES,
    BlockConfig,
    HopperClassSpec,
    _round_up,
    derive_block_config,
    largest_tile,
    BK_ALIGN,
    BM_TILES,
    BN_TILES,
)

if TYPE_CHECKING:  # control_tree imports Backend from here; keep it one-way.
    from repro_torch.core.control_tree import ControlTree

# ---------------------------------------------------------------------------
# Backend dispatch table (the one backend vocabulary)
# ---------------------------------------------------------------------------

Backend = Literal["matmul", "cuda", "cuda_lean", "torch_ref", "torch_ref_lean"]


def _matmul_gemm(a2, b, config, out_dtype):
    # Like the reference's XLA entry: an fp32 output accumulates and
    # returns fp32; otherwise the product comes back in the compute dtype.
    if out_dtype == torch.float32:
        return torch.matmul(a2.float(), b.float())
    return torch.matmul(a2, b).to(out_dtype)


def _cuda_gemm(a2, b, config, out_dtype):
    from repro_torch.kernels.gemm import gemm_cuda

    return gemm_cuda(a2, b, config, out_dtype=out_dtype)


def _torch_ref_gemm(a2, b, config, out_dtype):
    from repro_torch.kernels.gemm import gemm_plain

    return gemm_plain(a2, b, config, out_dtype=out_dtype)


def _cuda_lean_gemm(a2, b, config, out_dtype):
    from repro_torch.kernels.gemm import gemm_cuda_lean

    return gemm_cuda_lean(a2, b, config, out_dtype=out_dtype)


def _torch_ref_lean_gemm(a2, b, config, out_dtype):
    from repro_torch.kernels.gemm import gemm_lean_plain

    return gemm_lean_plain(a2, b, config, out_dtype=out_dtype)


def _paged_attn_torch(q, pages_k, pages_v, page_table, pos):
    from repro_torch.kernels.paged_attention import paged_attention_torch

    return paged_attention_torch(q, pages_k, pages_v, page_table, pos)


def _paged_attn_cuda(q, pages_k, pages_v, page_table, pos):
    from repro_torch.kernels.paged_attention import paged_attention_cuda

    return paged_attention_cuda(q, pages_k, pages_v, page_table, pos)


def _flash_attn_torch(q, k, v, causal, window, scale):
    from repro_torch.models.layers import chunked_attention

    return chunked_attention(q, k, v, causal=causal, window=window, scale=scale)


def _flash_attn_cuda(q, k, v, causal, window, scale):
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    return flash_attention_cuda(q, k, v, causal=causal, window=window, scale=scale)


# name -> kernel callable.  GEMM entries take ``(a2, b, config,
# out_dtype)``; paged-attention entries take ``(q, pages_k, pages_v,
# page_table, pos)``; full-sequence attention entries take ``(q, k, v,
# causal, window, scale)`` — :data:`BACKEND_OPS` tags each name with its
# family and the dispatch funnels validate the tag.
BACKENDS: dict[str, Callable] = {
    "matmul": _matmul_gemm,
    "cuda": _cuda_gemm,
    "torch_ref": _torch_ref_gemm,
    "cuda_lean": _cuda_lean_gemm,
    "torch_ref_lean": _torch_ref_lean_gemm,
    "paged_attn_torch": _paged_attn_torch,
    "paged_attn_cuda": _paged_attn_cuda,
    "flash_attn_torch": _flash_attn_torch,
    "flash_attn_cuda": _flash_attn_cuda,
}

# name -> op family ("gemm" | "paged_attn" | "flash_attn").
BACKEND_OPS: dict[str, str] = {
    "matmul": "gemm",
    "cuda": "gemm",
    "torch_ref": "gemm",
    "cuda_lean": "gemm",
    "torch_ref_lean": "gemm",
    "paged_attn_torch": "paged_attn",
    "paged_attn_cuda": "paged_attn",
    "flash_attn_torch": "flash_attn",
    "flash_attn_cuda": "flash_attn",
}


def backend_op(name: str) -> str:
    """The op family of a dispatch-table entry (validating the name)."""

    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r}")
    return BACKEND_OPS[name]


# Kernel backend -> its plain PyTorch twin (identity for entries that are
# plain PyTorch already).  The CPU parity tests walk BACKENDS through this
# map, so every new table entry must be registered here.
PLAIN_TWIN: dict[str, str] = {
    "matmul": "matmul",
    "cuda": "torch_ref",
    "torch_ref": "torch_ref",
    "cuda_lean": "torch_ref_lean",
    "torch_ref_lean": "torch_ref_lean",
    "paged_attn_torch": "paged_attn_torch",
    "paged_attn_cuda": "paged_attn_torch",
    "flash_attn_torch": "flash_attn_torch",
    "flash_attn_cuda": "flash_attn_torch",
}

# Pipelined backend -> the shared-memory-lean variant of the same family.
LEAN_VARIANTS: dict[str, str] = {
    "cuda": "cuda_lean",
    "torch_ref": "torch_ref_lean",
}

# Backends whose kernels stage one A/B pair at a time (``stages=1``).
_LEAN_BACKENDS = frozenset(LEAN_VARIANTS.values())


def plain_twin(name: str) -> str:
    """The plain PyTorch twin of a backend (validating both names)."""

    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r}")
    twin = PLAIN_TWIN.get(name)
    if twin is None or twin not in BACKENDS:
        raise ValueError(
            f"backend {name!r} has no plain twin registered in PLAIN_TWIN"
        )
    return twin


def backend_stages(name: str) -> int:
    """Depth of the TMA staging ring this backend's kernel uses:
    ``PIPELINE_STAGES`` for the pipelined kernel, 1 for the lean variant.
    Decides which shared-memory model governs block feasibility."""

    return 1 if name in _LEAN_BACKENDS else PIPELINE_STAGES


def min_stages(stages: int) -> int:
    """The ring a block must fit to run on a kernel of ``stages``: one
    stage for the lean kernel, ``MIN_PIPELINE_STAGES`` for the pipelined
    one (``kernels/gemm.ring_depth`` shortens its ring to what fits)."""

    return 1 if stages == 1 else MIN_PIPELINE_STAGES


def align_backend_family(variant: str, requested: str) -> str:
    """Map a recorded kernel variant onto ``requested``'s family: a tree
    built on the plain versions runs the variant's plain twin, a kernel
    tree the kernel (a plain name that leaked into a cache maps back)."""

    if PLAIN_TWIN[requested] == requested:
        return plain_twin(variant)
    return {twin: name for name, twin in PLAIN_TWIN.items()
            if BACKEND_OPS[name] == "gemm" and name != twin}.get(variant, variant)


def backend_vocabulary() -> frozenset[str]:
    """Every backend token the port accepts anywhere: the dispatch-table
    names plus the ``"auto"`` request.  The static analyzer's drift check
    (``repro_torch.analysis``, RPR005) is keyed off this, so its
    vocabulary can never diverge from the live registry."""

    return frozenset(BACKENDS) | {"auto"}


def validate_registry() -> list[str]:
    """Statically verify the dispatch tables' closure invariants.

    Returns human-readable violations (empty == healthy): ``BACKENDS`` and
    ``BACKEND_OPS`` agree; ``PLAIN_TWIN`` covers every entry, stays in the
    op family and is idempotent; ``LEAN_VARIANTS`` maps pipelined entries
    to one-stage entries of the same family; ``GEMM_KERNELS`` names only
    kernel (non-twin) GEMM entries.
    """

    problems: list[str] = []
    known_ops = {"gemm", "paged_attn", "flash_attn"}
    if set(BACKENDS) != set(BACKEND_OPS):
        problems.append(
            f"BACKENDS/BACKEND_OPS disagree: "
            f"{sorted(set(BACKENDS) ^ set(BACKEND_OPS))}"
        )
    for name, op in BACKEND_OPS.items():
        if op not in known_ops:
            problems.append(f"BACKEND_OPS[{name!r}] = {op!r} is not a known op family")
    if set(PLAIN_TWIN) != set(BACKENDS):
        problems.append(
            f"PLAIN_TWIN does not cover BACKENDS exactly: "
            f"{sorted(set(PLAIN_TWIN) ^ set(BACKENDS))}"
        )
    for name, twin in PLAIN_TWIN.items():
        if twin not in BACKENDS:
            problems.append(f"PLAIN_TWIN[{name!r}] = {twin!r} not in BACKENDS")
            continue
        if BACKEND_OPS.get(name) != BACKEND_OPS.get(twin):
            problems.append(f"PLAIN_TWIN[{name!r}] = {twin!r} crosses op families")
        if PLAIN_TWIN.get(twin) != twin:
            problems.append(f"plain twin {twin!r} (of {name!r}) is not its own twin")
    for name, lean in LEAN_VARIANTS.items():
        if name not in BACKENDS or lean not in BACKENDS:
            problems.append(f"LEAN_VARIANTS {name!r} -> {lean!r} not in BACKENDS")
            continue
        if BACKEND_OPS[name] != BACKEND_OPS[lean]:
            problems.append(f"LEAN_VARIANTS {name!r} -> {lean!r} crosses op families")
        if backend_stages(name) < 2 or backend_stages(lean) != 1:
            problems.append(
                f"LEAN_VARIANTS {name!r} -> {lean!r} must map a pipelined "
                "entry to a one-stage one"
            )
    from repro_torch.kernels.gemm import GEMM_KERNELS

    for name in GEMM_KERNELS:
        if name not in BACKENDS:
            problems.append(f"GEMM_KERNELS entry {name!r} not in BACKENDS")
        elif BACKEND_OPS[name] != "gemm":
            problems.append(f"GEMM_KERNELS entry {name!r} is not a GEMM backend")
        elif PLAIN_TWIN[name] == name:
            problems.append(
                f"GEMM_KERNELS entry {name!r} is a plain twin — the variant "
                "registry holds kernels only"
            )
    return problems


def on_cuda() -> bool:
    """The auto-probe: is there a CUDA card?"""

    return torch.cuda.is_available()


def resolve_backend(name: str) -> str:
    """Collapse a GEMM ``"auto"`` to a concrete table entry; validate the rest."""

    if name == "auto":
        return "cuda" if on_cuda() else "matmul"
    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r}")
    if BACKEND_OPS[name] != "gemm":
        raise ValueError(
            f"backend {name!r} is a {BACKEND_OPS[name]!r} kernel, not a GEMM"
        )
    return name


def resolve_paged_attn_backend(name: str) -> str:
    """Collapse a paged-attention ``"auto"``; validate the op family."""

    if name == "auto":
        return "paged_attn_cuda" if on_cuda() else "paged_attn_torch"
    if backend_op(name) != "paged_attn":
        raise ValueError(
            f"backend {name!r} is a {BACKEND_OPS[name]!r} kernel, not a "
            f"paged-attention kernel"
        )
    return name


def resolve_flash_attn_backend(name: str, device) -> str:
    """Collapse a full-sequence attention ``"auto"`` by where the tensors
    lie (the kernel for CUDA tensors, ``chunked_attention`` for CPU ones);
    validate the op family."""

    if name == "auto":
        return "flash_attn_cuda" if torch.device(device).type == "cuda" else "flash_attn_torch"
    if backend_op(name) != "flash_attn":
        raise ValueError(
            f"backend {name!r} is a {BACKEND_OPS[name]!r} kernel, not a "
            f"full-sequence attention kernel"
        )
    return name


def dispatch_gemm(a2, b, *, config=None, backend: str = "auto", out_dtype=None):
    """Route a 2-D GEMM through the backend table (the kernels' funnel)."""

    out_dtype = out_dtype or a2.dtype
    return BACKENDS[resolve_backend(backend)](a2, b, config, out_dtype)


def dispatch_paged_attention(
    q, pages_k, pages_v, page_table, pos, *, backend: str = "auto"
):
    """Route a paged decode-attention call through the backend table."""

    return BACKENDS[resolve_paged_attn_backend(backend)](
        q, pages_k, pages_v, page_table, pos
    )


def dispatch_flash_attention(
    q, k, v, *, causal: bool = True, window=None, scale=None, backend: str = "auto"
):
    """Route a full-sequence (prefill / scoring) attention call through the
    backend table."""

    return BACKENDS[resolve_flash_attn_backend(backend, q.device)](q, k, v, causal, window, scale)


# ---------------------------------------------------------------------------
# Block-config resolution: the tuning cache, else the analytical derivation
# ---------------------------------------------------------------------------

_DTYPE_NAMES = {1: "int8", 2: "bfloat16", 4: "float32"}


def dtype_name_for_bytes(dtype_bytes: int) -> str:
    return _DTYPE_NAMES.get(dtype_bytes, f"bytes{dtype_bytes}")


def tuned_block_config(
    m: int,
    k: int,
    n: int,
    *,
    spec: Optional[HopperClassSpec] = None,
    dtype_name: str = "bfloat16",
    dtype_bytes: int = 2,
) -> Optional[BlockConfig]:
    """The ``$REPRO_TORCH_TUNING_CACHE`` entry for this (spec, dtype,
    shape), or None.  ``spec=None`` reads the spec name from
    ``$REPRO_TORCH_TUNING_SPEC`` (default ``h100``)."""

    from repro_torch.tuning.cache import cached_block_config

    return cached_block_config(
        m, k, n, dtype_name, dtype_bytes,
        spec_name=spec.name if spec is not None else None,
    )


def tuned_kernel_backend(
    m: int,
    k: int,
    n: int,
    *,
    spec: Optional[HopperClassSpec] = None,
    dtype_name: str = "bfloat16",
) -> Optional[str]:
    """The kernel variant the tuner recorded for this entry, or None when
    the entry records none (or a name that is not a GEMM entry)."""

    from repro_torch.tuning.cache import cached_kernel_backend

    name = cached_kernel_backend(
        m, k, n, dtype_name, spec_name=spec.name if spec is not None else None
    )
    return name if BACKEND_OPS.get(name) == "gemm" else None


def _usable_tuned(
    m: int,
    k: int,
    n: int,
    *,
    spec: Optional[HopperClassSpec],
    dtype_name: str,
    dtype_bytes: int,
    stages: int,
) -> Optional[BlockConfig]:
    """The tuned entry if a kernel with a ``stages``-deep ring can run it.

    A pipelined consumer (``stages > 1``) never takes an entry recorded for
    the lean kernel, nor one that does not fit its shortest ring in the
    class's shared memory; any entry that fits one stage suits the lean
    kernel.
    """

    cfg = tuned_block_config(
        m, k, n, spec=spec, dtype_name=dtype_name, dtype_bytes=dtype_bytes
    )
    if cfg is None:
        return None
    if stages > 1:
        recorded = tuned_kernel_backend(m, k, n, spec=spec, dtype_name=dtype_name)
        if recorded is not None and backend_stages(recorded) == 1:
            return None
    if spec is not None and not cfg.fits(spec, stages=min_stages(stages)):
        return None
    return cfg


def resolve_block_config(
    m: int,
    k: int,
    n: int,
    *,
    spec: Optional[HopperClassSpec] = None,
    dtype_name: str = "bfloat16",
    dtype_bytes: int = 2,
    stages: int = PIPELINE_STAGES,
) -> tuple[BlockConfig, str]:
    """``(config, source)``: the tuned entry on a usable cache hit (source
    ``"tuned"``), else the analytical derivation under ``spec`` for a
    kernel with a ``stages``-deep ring (``"analytical"``).

    A hit reaches a consumer only if its kernel can hold it: an entry
    recorded for the lean kernel, or one that does not fit the pipelined
    kernel's ring, never reaches the pipelined kernel (``_usable_tuned``).
    """

    cfg = _usable_tuned(m, k, n, spec=spec, dtype_name=dtype_name,
                        dtype_bytes=dtype_bytes, stages=stages)
    if cfg is not None:
        return cfg, "tuned"
    return (
        derive_block_config(
            m, k, n, spec=spec or H100, dtype_bytes=dtype_bytes, stages=stages
        ),
        "analytical",
    )


# ---------------------------------------------------------------------------
# The execution context itself
# ---------------------------------------------------------------------------


def _same_bucket(a: tuple[int, int, int], b: tuple[int, int, int]) -> bool:
    """Do two problem shapes round up to the same aligned dims?

    Uses the tuning cache's own bucket function, so block reuse can never
    drift from the cache keys.
    """

    from repro_torch.tuning.cache import _bucket

    return all(_bucket(x) == _bucket(y) for x, y in zip(a, b))


_ACTIVE: contextvars.ContextVar[Optional["ExecutionContext"]] = contextvars.ContextVar(
    "repro_torch_execution_context", default=None
)
# LIFO of reset tokens for the enters made in the current thread/task, so
# one shared context object may be entered concurrently everywhere.
_TOKENS: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "repro_torch_execution_tokens", default=()
)


@dataclasses.dataclass
class ExecutionContext:
    """Ambient per-device-class execution configuration (a context manager).

    Binds one class's control tree: ``ops.gemm`` calls under it take their
    backend from ``tree.backend`` and resolve their block shapes per call
    shape under ``tree.spec``.  ``tree.block`` is the canonical-shape
    config carrying the Section-5.3 shared-panel structure; calls in its
    shape bucket reuse it, others take the class's tuned entry or
    re-derive for the class.
    """

    device_class: str
    tree: "ControlTree"

    def __enter__(self) -> "ExecutionContext":
        token = _ACTIVE.set(self)
        _TOKENS.set(_TOKENS.get() + (token,))
        return self

    def __exit__(self, *exc) -> bool:
        stack = _TOKENS.get()
        _TOKENS.set(stack[:-1])
        _ACTIVE.reset(stack[-1])
        return False

    @property
    def spec(self) -> HopperClassSpec:
        return self.tree.spec

    def backend(self) -> str:
        """The concrete dispatch-table entry this context routes to."""

        return resolve_backend(self.tree.backend)

    def block_config(
        self, m: int, k: int, n: int, dtype_name: str, dtype_bytes: int
    ) -> BlockConfig:
        """Per-call-shape block config for this class (tuned or analytical).

        Hand-built trees (no ``problem_shape``) are authoritative: their
        block is used on every call, clamped to the call's tile-rounded
        dims, re-labelled to the call's operand bytes when that still
        fits.  Mesh-built trees reuse ``tree.block`` for calls in the
        bucket they were built for on a dtype match; otherwise a tuned
        cache entry for this class's spec at the call's dtype wins if the
        tree's kernel can hold it (under a Loop-3 tree, in the tree's
        bucket, only if it keeps the shared ``bk``, the rule
        ``build_control_trees`` enforces); then the re-labelled
        ``tree.block`` (in its bucket, if it fits); then a derivation under
        this class's spec and the tree kernel's ring depth.
        """

        tree = self.tree
        stages = backend_stages(self.backend())
        hand_built = tree.problem_shape is None
        align = tree.spec.align

        def _clamp(blk: BlockConfig) -> BlockConfig:
            pad = lambda d: max(align, _round_up(d, align))  # noqa: E731
            return dataclasses.replace(
                blk,
                bm=min(blk.bm, largest_tile(BM_TILES, pad(m))),
                bk=min(blk.bk, max(BK_ALIGN, _round_up(k, BK_ALIGN))),
                bn=min(blk.bn, largest_tile(BN_TILES, pad(n))),
            )

        reuse = hand_built or _same_bucket((m, k, n), tree.problem_shape)
        if reuse and tree.block.dtype_bytes == dtype_bytes:
            return _clamp(tree.block) if hand_built else tree.block
        relabeled = dataclasses.replace(tree.block, dtype_bytes=dtype_bytes) if reuse else None
        if hand_built and relabeled.fits(tree.spec, stages=stages):
            return _clamp(relabeled)
        tuned = _usable_tuned(m, k, n, spec=tree.spec, dtype_name=dtype_name,
                              dtype_bytes=dtype_bytes, stages=stages)
        if tuned is not None and (
            not reuse or tree.coarse_loop != "rows" or tuned.bk == tree.block.bk
        ):
            return tuned
        if reuse and not hand_built and relabeled.fits(tree.spec, stages=stages):
            return relabeled
        return derive_block_config(
            m, k, n, spec=tree.spec, dtype_bytes=dtype_bytes, stages=stages
        )


def current_context() -> Optional[ExecutionContext]:
    """The innermost active context, or None (→ pre-context defaults)."""

    return _ACTIVE.get()


# ---------------------------------------------------------------------------
# Per-class programs within one step (a rank a pod, or a stream a pod)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardProvenance:
    """Which class's control tree governs one pod shard (paper §5.3)."""

    pod: int
    device_class: str
    spec: str
    backend: str
    block_source: str  # "tuned" | "analytical" — the tree's provenance
    block: BlockConfig


@dataclasses.dataclass(eq=False)
class ClassShardedFn:
    """A callable wrapping ``fn`` so each pod shard runs its own class's
    program, plus the per-shard provenance (for assertions / telemetry).

    ``trace_log`` records which contexts ran a branch: one entry per
    class and input signature (the tensors' shapes and dtypes), the first
    time that branch runs it — where the reference's ``jit`` traces once
    per signature and appends on each retrace.
    """

    fn: Callable
    provenance: tuple[ShardProvenance, ...]
    trace_log: list
    mixed: bool  # False on the single-class fallback (one context, no pods)
    pod: Optional[int] = None  # this rank's pod when the pods are ranks

    def __call__(self, *args):
        return self.fn(*args)


@dataclasses.dataclass(frozen=True)
class PodRanks:
    """The pod axis of a mesh of ranks, as :func:`class_sharded` hands it
    to an epilogue: the axis ``name`` and the ``mesh`` whose group over it
    the epilogue's collectives (``distributed.collectives``) take."""

    name: str
    mesh: object


def _signature(tree) -> tuple:
    if isinstance(tree, dict):
        return tuple((k, _signature(tree[k])) for k in sorted(tree))
    if isinstance(tree, (tuple, list)):
        return tuple(_signature(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype)
    return ()


def _tensor_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tensor_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _tensor_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def class_sharded(
    fn: Callable,
    *,
    mesh,
    contexts: Sequence[ExecutionContext],
    pod_class: Sequence[int],
    in_specs,
    out_specs,
    axis: str = "pod",
    epilogue: Optional[Callable] = None,
) -> ClassShardedFn:
    """CA-SAS within one step: per-class programs, one per pod shard.

    The paper's §5.3/§5.4 schemes run *different* control trees on the big
    and LITTLE clusters simultaneously inside one GEMM.  The reference
    does it with a ``shard_map`` over the mesh's pod axis and a
    ``lax.switch`` on each shard's class index, a device a pod.  The port
    has two realisations, by the mesh (``launch.mesh.resolve_pods`` picks
    one):

    * **A rank a pod** (a :class:`~repro_torch.launch.mesh.RankMesh` with
      a ``pod`` axis: ``torch.distributed`` ranks, each on its own card
      under ``nccl``, or sharing one over ``gloo``).  The rank's pod is
      ``mesh.coord(axis)``; it takes its pod's view of every argument by
      ``in_specs`` (``distributed.sharding.pod_view``) and runs ``fn``
      once, under ``contexts[pod_class[pod]]``.  ``epilogue(out,
      shard_args, axis)`` then runs on this rank's output with ``axis`` a
      :class:`PodRanks` — the one place cross-pod collectives run, as in
      the reference's ``shard_map`` body.  Without one the outputs are
      all-gathered over the pod group by ``out_specs``
      (``sharding.gather_pods``).  Pods wider than one rank (``data`` or
      ``model`` above 1) replicate their pod's program over their ranks,
      the reference's fully manual default, and the epilogue reduces over
      ``pod`` only.  The pods' programs run at once, on their own cards;
      each rank holds its own copy of what is replicated (the weights).
      ``auto`` takes this route only where every rank has a card.
    * **A stream a pod** (a :class:`~repro_torch.launch.mesh.PodMesh`: one
      process on one card).  The wrapper splits every argument by
      ``in_specs`` into per-pod views (``sharding.split_pods``: no
      copies, so the params and the paged arena are shared, not
      duplicated), then issues each pod's shard in turn, under its own
      class's :class:`ExecutionContext`, on that pod's stream.  Each pod's
      stream first waits on the caller's stream (the inputs were written
      there), and the caller's stream waits on every pod's before
      anything is read or reduced; the inputs stay alive until that join,
      and every output tensor is marked as used on the caller's stream
      (``record_stream``), so the allocator reuses no pod's block under
      pending work.  On the CPU the pods have no streams and run in turn.
      ``epilogue(outs, shard_args, axis)`` runs after the join, on the
      caller's stream, over the per-pod outputs and arguments (lists)
      with ``axis`` the axis name; without one the outputs are joined by
      ``out_specs`` (``sharding.stitch_pods``).  ``on`` takes this route
      in one process.

    Either way every ``ops.gemm`` in pod *i* resolves class(*i*)'s blocks
    and kernel at the shard's own shape; each pod's program is a
    ``class_sharded.pod`` span (on its stream, or its rank) and the
    epilogue a ``class_sharded.epilogue`` span.  ``contexts`` is ordered by class
    index; ``pod_class[i]`` is the class index of pod ``i``
    (``distributed.sharding.pod_class_specs``).  With a single class the
    fallback activates the one context around ``fn`` — no pods, bitwise
    the single-context path — and calls ``epilogue(out, args, None)``.

    ``fn`` must itself do no cross-pod work.  The reference's
    ``compat_shard_map`` (a shim over a ``jax`` keyword renamed between
    versions) and its partial-``auto`` axes (GSPMD inside a manual
    ``shard_map``) have no counterpart here.
    """

    from repro_torch.distributed import sharding as SH
    from repro_torch.observability import trace as obs

    contexts = list(contexts)
    if not contexts:
        raise ValueError("need at least one execution context")
    pod_class = tuple(int(c) for c in pod_class)
    if any(c < 0 or c >= len(contexts) for c in pod_class):
        raise ValueError(
            f"pod_class {pod_class} out of range for {len(contexts)} classes"
        )
    provenance = tuple(
        ShardProvenance(
            pod=i,
            device_class=contexts[c].device_class,
            spec=contexts[c].spec.name,
            backend=contexts[c].backend(),
            block_source=contexts[c].tree.block_source,
            block=contexts[c].tree.block,
        )
        for i, c in enumerate(pod_class)
    )
    trace_log: list = []
    seen: set = set()

    def note(ctx: ExecutionContext, args, mixed: bool):
        key = (ctx.device_class, _signature(args))
        if key in seen:
            return
        seen.add(key)
        trace_log.append((ctx.device_class, ctx.tree.block_source))
        obs.instant(
            "execution.trace", cat="execution", mixed=mixed,
            device_class=ctx.device_class, backend=ctx.backend(),
            block_source=ctx.tree.block_source,
        )

    def pod_span(pod: int, shard_args):
        """The ``class_sharded.pod`` span of ``pod``'s program, on its
        stream (its rows: the leading size of its first split leaf)."""

        split = [a for a, spec in zip(shard_args, in_specs) if spec is not None]
        leaves = _tensor_leaves(split)
        prov = provenance[pod]
        return obs.span("class_sharded.pod", cat="execution", pod=pod,
                        device_class=prov.device_class, backend=prov.backend,
                        rows=int(leaves[0].shape[0]) if leaves else 0)

    if len(contexts) == 1:
        # Single-class fallback: the one context governs the whole program.
        ctx = contexts[0]

        def single(*args):
            with ctx:
                note(ctx, args, mixed=False)
                out = fn(*args)
            if epilogue is not None:
                out = epilogue(out, args, None)
            return out

        return ClassShardedFn(
            fn=single, provenance=provenance, trace_log=trace_log, mixed=False
        )

    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no {axis!r} axis; axes={mesh.axis_names}")
    if mesh.shape[axis] != len(pod_class):
        raise ValueError(
            f"pod_class covers {len(pod_class)} pods but mesh axis "
            f"{axis!r} has size {mesh.shape[axis]}"
        )
    n_pods = len(pod_class)

    if hasattr(mesh, "coord"):  # a RankMesh: this rank runs its own pod
        pod = mesh.coord(axis)
        ctx = contexts[pod_class[pod]]
        group = PodRanks(axis, mesh)

        def ranked(*args):
            shard_args = SH.pod_view(args, in_specs, n_pods, pod)
            with ctx:
                note(ctx, shard_args, mixed=True)
                with pod_span(pod, shard_args):
                    out = fn(*shard_args)
            if epilogue is not None:
                with obs.span("class_sharded.epilogue", cat="execution"):
                    return epilogue(out, shard_args, group)
            return SH.gather_pods(out, out_specs, mesh)

        return ClassShardedFn(
            fn=ranked, provenance=provenance, trace_log=trace_log, mixed=True, pod=pod
        )

    def wrapped(*args):
        views: dict = {}
        shards = SH.split_pods(args, in_specs, n_pods, views)
        streams = mesh.pod_streams()
        caller = torch.cuda.current_stream(mesh.device) if streams[0] is not None else None
        for s in streams:
            if s is not None:
                s.wait_stream(caller)
        outs = []
        for pod, (stream, c, shard_args) in enumerate(zip(streams, pod_class, shards)):
            ctx = contexts[c]
            with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext(), ctx:
                note(ctx, shard_args, mixed=True)
                with pod_span(pod, shard_args):
                    outs.append(fn(*shard_args))
        if caller is not None:
            for s in streams:
                caller.wait_stream(s)
            for t in _tensor_leaves(outs):
                t.record_stream(caller)
        if epilogue is not None:
            with obs.span("class_sharded.epilogue", cat="execution"):
                return epilogue(outs, shards, axis)
        return SH.stitch_pods(outs, out_specs, views)

    return ClassShardedFn(
        fn=wrapped, provenance=provenance, trace_log=trace_log, mixed=True
    )


def context_for_tree(tree: "ControlTree") -> ExecutionContext:
    """Wrap an existing control tree (e.g. one of ``build_control_trees``)."""

    return ExecutionContext(device_class=tree.device_class, tree=tree)


def default_context(
    *,
    spec: Optional[HopperClassSpec] = None,
    shape: tuple[int, int, int] = (1024, 1024, 1024),
    backend: str = "auto",
    device_class: Optional[str] = None,
) -> ExecutionContext:
    """A single-class context for homogeneous runs."""

    from repro_torch.core.control_tree import build_control_trees

    spec = spec or H100
    name = device_class or spec.name
    trees = build_control_trees({name: spec}, *shape, backend=resolve_backend(backend))
    return ExecutionContext(device_class=name, tree=trees[name])


__all__ = [
    "Backend",
    "BACKENDS",
    "BACKEND_OPS",
    "PLAIN_TWIN",
    "LEAN_VARIANTS",
    "ClassShardedFn",
    "ExecutionContext",
    "PodRanks",
    "ShardProvenance",
    "align_backend_family",
    "backend_op",
    "backend_stages",
    "backend_vocabulary",
    "class_sharded",
    "context_for_tree",
    "current_context",
    "default_context",
    "dispatch_flash_attention",
    "dispatch_gemm",
    "dispatch_paged_attention",
    "dtype_name_for_bytes",
    "min_stages",
    "on_cuda",
    "plain_twin",
    "resolve_backend",
    "resolve_block_config",
    "resolve_flash_attn_backend",
    "resolve_paged_attn_backend",
    "tuned_block_config",
    "tuned_kernel_backend",
    "validate_registry",
]
