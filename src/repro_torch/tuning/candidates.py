"""Candidate ``BlockConfig`` enumeration for the empirical search.

The port's ``repro.tuning.candidates``.  The paper searches the (m_c, k_c)
plane in two stages, a coarse sweep and a refinement around the winner
(Section 3.3 / Figure 4).  On Hopper the search space is the set of blocks
the CUDA GEMM is compiled for (``kernels.gemm.compiled_tile``: ``bm`` in
``BM_TILES``, ``bn`` in ``BN_TILES``, ``bk`` whole 64-value swizzle rows up
to ``MAX_BK``; the reference's power-of-two ladder aligned to the 128-lane
MXU names blocks the kernel cannot launch), no larger than the problem
rounded up to its alignment (``kernels.gemm.validate_block_config``), and
fitting the class's shared memory under its kernel's ring: two stages at
least for the pipelined ``cuda`` kernel (``kernels.gemm.ring_depth``), one
for ``cuda_lean``.  The analytical optimum of :func:`derive_block_config`
is always candidate 0, so the search can only match or beat it.
"""

from __future__ import annotations

import collections.abc
import dataclasses
from typing import Iterable, Optional

from repro_torch.core import blocking as B
from repro_torch.core.blocking import (
    BK_ALIGN,
    BM_TILES,
    BN_TILES,
    MAX_BK,
    PIPELINE_STAGES,
    BlockConfig,
    HopperClassSpec,
    derive_block_config,
)
from repro_torch.core.execution import backend_stages, min_stages


class _Specs(collections.abc.Mapping):
    """Named class specs addressable from the CLI / cache keys.

    Resolved through :func:`~repro_torch.core.blocking.hopper_spec` (the
    card's shared memory and SM count when a card is present), the same
    objects :func:`repro_torch.core.asymmetric.biglittle_classes` gives its
    classes, so tuned entries and calibration agree on what a name means.
    Read on use, not at import.
    """

    _LITTLE = {B.H100.name: False, B.H100_LITTLE.name: True}

    def __getitem__(self, name: str) -> HopperClassSpec:
        return B.hopper_spec(little=self._LITTLE[name])

    def __iter__(self):
        return iter(self._LITTLE)

    def __len__(self) -> int:
        return len(self._LITTLE)


SPECS: collections.abc.Mapping = _Specs()


def get_spec(name: str) -> HopperClassSpec:
    try:
        return SPECS[name]
    except KeyError:
        raise KeyError(f"unknown core spec {name!r}; known: {sorted(SPECS)}") from None


def analytical_config(
    m: int,
    k: int,
    n: int,
    *,
    spec: HopperClassSpec = B.H100,
    dtype_bytes: int = 2,
    stages: int = PIPELINE_STAGES,
) -> BlockConfig:
    """The model-derived default (the search's baseline and seed).

    ``stages=1`` seeds the lean kernel's search: the one-stage model admits
    wider panels.
    """

    return derive_block_config(m, k, n, spec=spec, dtype_bytes=dtype_bytes, stages=stages)


def launchable(cfg: BlockConfig, m: int, k: int, n: int) -> bool:
    """Do the kernels accept ``cfg`` for this problem (their own checks)?"""

    from repro_torch.kernels.gemm import compiled_tile, validate_block_config

    if not compiled_tile(cfg):
        return False
    try:
        validate_block_config(m, k, n, cfg)
    except ValueError:
        return False
    return True


def feasible(cfg: BlockConfig, spec: HopperClassSpec, stages: int = PIPELINE_STAGES) -> bool:
    """Does ``cfg`` fit the class's shared memory under the ring of the
    kernel with ``stages`` (at least two stages for the pipelined one)?"""

    return cfg.fits(spec, stages=min_stages(stages))


def neighborhood(
    cfg: BlockConfig,
    *,
    spec: HopperClassSpec = B.H100,
    stages: int = PIPELINE_STAGES,
    shape: Optional[tuple[int, int, int]] = None,
) -> list[BlockConfig]:
    """One-step refinements around ``cfg`` (the paper's fine sweep).

    Each of bm and bn moves to the next compiled tile either side, bk by
    one swizzle row either side and by 2x; only launchable (for ``shape``,
    when given) and feasible results are kept.
    """

    def steps(base: int, tiles) -> list[int]:
        if tiles is None:
            return [base - BK_ALIGN, base + BK_ALIGN, base // 2, base * 2]
        i = tiles.index(base)
        return [tiles[j] for j in (i - 1, i + 1) if 0 <= j < len(tiles)]

    out = []
    for dim, tiles in (("bm", BM_TILES), ("bn", BN_TILES), ("bk", None)):
        for nxt in steps(getattr(cfg, dim), tiles):
            cand = dataclasses.replace(cfg, **{dim: nxt})
            ok = launchable(cand, *shape) if shape else launchable(cand, 1 << 30, 1 << 30, 1 << 30)
            if ok and feasible(cand, spec, stages) and cand not in out:
                out.append(cand)
    return out


def enumerate_candidates(
    m: int,
    k: int,
    n: int,
    *,
    spec: HopperClassSpec = B.H100,
    dtype_bytes: int = 2,
    extra: Optional[Iterable[BlockConfig]] = None,
    stages: int = PIPELINE_STAGES,
) -> list[BlockConfig]:
    """The deduplicated feasible candidate set for one GEMM shape.

    Every compiled tile shape the kernels accept for this problem and that
    fits the class's shared memory under the kernel's ring (``feasible``),
    plus ``extra``.  Deterministic order: the analytical optimum first,
    then ascending ``(bm, bk, bn)``.
    """

    seed = analytical_config(m, k, n, spec=spec, dtype_bytes=dtype_bytes, stages=stages)
    pool = [BlockConfig(bm=bm, bk=bk, bn=bn, dtype_bytes=dtype_bytes)
            for bm in BM_TILES for bn in BN_TILES for bk in range(BK_ALIGN, MAX_BK + 1, BK_ALIGN)]
    pool += list(extra or ())
    out = [seed]
    for cand in sorted(pool, key=lambda c: (c.bm, c.bk, c.bn)):
        if cand not in out and launchable(cand, m, k, n) and feasible(cand, spec, stages):
            out.append(cand)
    return out


# ---------------------------------------------------------------------------
# Micro-kernel variants as a search dimension (paper §5.3)
# ---------------------------------------------------------------------------

# The kernel variants the search enumerates by default: every entry of the
# variant registry (the pipelined kernel and the one-stage lean kernel).
# The plain twins and "matmul" are dispatch entries, not search points.
def _kernel_backends() -> tuple[str, ...]:
    from repro_torch.kernels.gemm import GEMM_KERNELS

    return tuple(GEMM_KERNELS)


KERNEL_BACKENDS: tuple[str, ...] = _kernel_backends()


@dataclasses.dataclass(frozen=True)
class KernelCandidate:
    """One search point: a block config *and* the kernel variant to run it.

    The lean variant's one-stage ring admits (bm, bk, bn) panels the
    pipelined kernel cannot hold, so the variant dimension widens the
    feasible set.
    """

    cfg: BlockConfig
    backend: str = "cuda"

    @property
    def key(self) -> tuple[int, int, int, str]:
        return (self.cfg.bm, self.cfg.bk, self.cfg.bn, self.backend)


def enumerate_kernel_candidates(
    m: int,
    k: int,
    n: int,
    *,
    spec: HopperClassSpec = B.H100,
    dtype_bytes: int = 2,
    backends: Iterable[str] = KERNEL_BACKENDS,
    **kwargs,
) -> list[KernelCandidate]:
    """The (config, variant) candidate set for one GEMM shape.

    Per variant, configs are enumerated under *that kernel's* ring
    (``execution.backend_stages``); duplicates of (bm, bk, bn, backend)
    are dropped.  Order: each variant's analytical seed first (the default
    variant leading), then the merged grids.
    """

    from repro_torch.kernels.gemm import GEMM_KERNELS

    backends = list(backends)
    for b in backends:
        if b not in GEMM_KERNELS:
            raise ValueError(
                f"unknown kernel backend {b!r}; searchable variants: "
                f"{sorted(GEMM_KERNELS)}"
            )
    per_backend = [
        (b, enumerate_candidates(m, k, n, spec=spec, dtype_bytes=dtype_bytes,
                                 stages=backend_stages(b), **kwargs))
        for b in backends
    ]
    # Seeds first (search_shape treats candidate #0 as the baseline).
    out: list[KernelCandidate] = []
    for cands in ([c[:1] for _, c in per_backend], [c[1:] for _, c in per_backend]):
        for b, cfgs in zip(backends, cands):
            for cfg in cfgs:
                cand = KernelCandidate(cfg=cfg, backend=b)
                if cand not in out:
                    out.append(cand)
    return out


__all__ = [
    "KERNEL_BACKENDS",
    "SPECS",
    "KernelCandidate",
    "analytical_config",
    "enumerate_candidates",
    "enumerate_kernel_candidates",
    "feasible",
    "get_spec",
    "launchable",
    "neighborhood",
]
