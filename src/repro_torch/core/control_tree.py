"""Control trees: per-device-class execution configuration.

The port's counterpart of ``repro.core.control_tree``.  BLIS drives every
operation from a recursive *control tree* (paper Section 5.1); the paper
duplicates it per core class (Section 5.3) so fast and slow cores run
with different cache parameters and, potentially, different
micro-kernels.  A :class:`ControlTree` carries, per device class, the
CUDA :class:`~repro_torch.core.blocking.BlockConfig`, the coarse/fine loop
choice, and the kernel selection (a name in
:data:`repro_torch.core.execution.BACKENDS`).

:func:`build_control_trees` reproduces the Section 5.3 dependency on
Hopper's shared memory: under Loop 3 (``coarse_loop="rows"``) the staged
B panel is shared, forcing a common ``bk``; a class whose shared memory
cannot hold the shared panel in the pipelined ring keeps the full panel
on the one-stage lean kernel when that fits, instead of shrinking ``bm``
(which stops at the 64-row wgmma floor).  Each class's block first
consults the ``$REPRO_TORCH_TUNING_CACHE`` entry for *its own* spec (the
paper's per-class empirical optimum), falling back to the analytical
derivation; ``block_source`` records which won.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Mapping, Optional

from repro_torch.core import blocking as B
from repro_torch.core import execution as X
from repro_torch.core.execution import Backend  # one backend vocabulary (re-export)

CoarseLoop = Literal["cols", "rows"]  # paper's Loop 1 (j_c/n) vs Loop 3 (i_c/m)
FineLoop = Literal["loop4", "loop5", "both"]


@dataclasses.dataclass(frozen=True)
class ControlTree:
    """Execution configuration for one device class."""

    device_class: str
    block: B.BlockConfig
    coarse_loop: CoarseLoop = "rows"
    fine_loop: FineLoop = "loop4"
    backend: Backend = "matmul"
    # Class spec used to derive `block`; kept for re-derivation.
    spec: B.HopperClassSpec = B.H100
    # Provenance of `block`: "tuned" (a cache hit for this class's spec) or
    # "analytical" (the derivation / shared-panel re-derivation).
    block_source: str = "analytical"
    # (m, k, n) the tree was built for; execution contexts reuse `block`
    # verbatim for calls in the same tile-aligned shape bucket.
    problem_shape: Optional[tuple[int, int, int]] = None


def build_control_trees(
    specs: Mapping[str, B.HopperClassSpec],
    m: int,
    k: int,
    n: int,
    *,
    coarse_loop: CoarseLoop = "rows",
    fine_loop: FineLoop = "loop4",
    backend: Backend = "matmul",
    cache_aware: bool = True,
    dtype_bytes: int = 2,
) -> dict[str, ControlTree]:
    """One control tree per device class (paper Sections 5.1/5.3).

    With ``cache_aware=False`` every class reuses the *first* class's block
    config — the single-control-tree baseline (plain SAS/DAS).  With
    ``cache_aware=True`` each class derives its own config; under Loop 3
    (``coarse_loop == "rows"``) ``bk`` is forced to the first class's value
    and each other class re-derives the largest ``bm`` its shared memory
    holds at that ``bk`` — the structure of the paper's
    ``k_c = 952 -> m_c = 32`` adjustment.  When ``backend`` has a lean
    variant (``execution.LEAN_VARIANTS``), a class whose lean (one-stage)
    ring holds a larger panel than its pipelined ring (or the only panel
    that fits, when the pipelined ring cannot hold even the 64-row floor)
    keeps that panel on the lean kernel.

    Each class's block resolves through :func:`repro_torch.core.execution.resolve_block_config`: the
    active cache entry for that class's spec wins, and a recorded kernel
    variant (``cuda_lean``) selects that kernel for the class (mapped onto
    ``backend``'s family; ``matmul`` trees stay ``matmul``).  Under the
    shared-B-panel constraint a tuned entry is honoured only if it keeps
    the shared ``bk``; with ``cache_aware=False`` every class mirrors the
    first class's configuration, its recorded variant included.
    """

    names = list(specs)
    if not names:
        raise ValueError("need at least one device class")
    first = names[0]
    dtype_name = X.dtype_name_for_bytes(dtype_bytes)
    lean_backend = X.LEAN_VARIANTS.get(backend)  # None for matmul / lean itself
    stages = X.backend_stages(backend)

    def _recorded_variant(spec: B.HopperClassSpec) -> str:
        """Backend for a tuned entry: the recorded variant in ``backend``'s
        family; matmul trees stay matmul."""

        if backend == "matmul":  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
            return backend
        recorded = X.tuned_kernel_backend(m, k, n, spec=spec, dtype_name=dtype_name)
        if recorded is None or recorded == "matmul":
            return backend
        return X.align_backend_family(recorded, backend)

    def _resolve(spec: B.HopperClassSpec) -> tuple[B.BlockConfig, str]:
        # Resolve under the ring of the kernel the tree will name: an entry
        # recorded for the lean kernel pairs with the lean backend, so its
        # one-stage-only block stays acceptable here.
        return X.resolve_block_config(
            m, k, n, spec=spec, dtype_name=dtype_name, dtype_bytes=dtype_bytes,
            stages=X.backend_stages(_recorded_variant(spec)),
        )

    base, base_src = _resolve(specs[first])
    trees: dict[str, ControlTree] = {}
    for name in names:
        class_backend = backend
        if not cache_aware or name == first:
            blk, src = base, base_src
            if src == "tuned":
                # Always the first class's variant: with cache_aware=False
                # every class mirrors the first class wholesale.
                class_backend = _recorded_variant(specs[first])
        elif coarse_loop == "rows":
            tuned = X.tuned_block_config(m, k, n, spec=specs[name], dtype_name=dtype_name,
                                         dtype_bytes=dtype_bytes)
            if tuned is not None and tuned.bk == base.bk:
                blk, src = tuned, "tuned"
                class_backend = _recorded_variant(specs[name])
            else:
                src = "analytical"
                blk = _rederive_bm(specs[name], base, dtype_bytes, stages=stages)
                if lean_backend is not None:
                    lean_blk = _rederive_bm(specs[name], base, dtype_bytes, stages=1)
                    # The lean kernel keeps the wider panel — or the only
                    # one that fits, once bm is at the wgmma floor.
                    if (lean_blk.fits(specs[name], stages=1), lean_blk.bm) > (
                            blk.fits(specs[name], stages=stages), blk.bm):
                        blk, class_backend = lean_blk, lean_backend
        else:
            # Independent panels (Loop 1): fully independent resolution.
            blk, src = _resolve(specs[name])
            if src == "tuned":
                class_backend = _recorded_variant(specs[name])
        trees[name] = ControlTree(
            device_class=name,
            block=blk,
            coarse_loop=coarse_loop,
            fine_loop=fine_loop,
            backend=class_backend,
            spec=specs[name],
            block_source=src,
            problem_shape=(m, k, n),
        )
    return trees


def _rederive_bm(
    spec: B.HopperClassSpec,
    base: B.BlockConfig,
    dtype_bytes: int,
    *,
    stages: int = B.PIPELINE_STAGES,
) -> B.BlockConfig:
    """The largest ``bm`` (halving from the anchor's, down to the smallest
    compiled tile) whose ring fits this class's shared memory at the shared
    ``(bk, bn)``; the floor when none does."""

    bk, bn = base.bk, base.bn
    bm = base.bm
    floor = min(B.BM_TILES)
    while bm > floor:
        cfg = B.BlockConfig(bm=bm, bk=bk, bn=bn, dtype_bytes=dtype_bytes)
        if cfg.fits(spec, stages=stages):
            break
        bm //= 2
    return B.BlockConfig(bm=max(bm, floor), bk=bk, bn=bn, dtype_bytes=dtype_bytes)


__all__ = ["ControlTree", "build_control_trees", "CoarseLoop", "FineLoop", "Backend"]
