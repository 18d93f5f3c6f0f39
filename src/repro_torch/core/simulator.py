"""Calibrated big.LITTLE GEMM simulator (paper validation layer).

This container has one CPU core and no Exynos 5422, so the paper's
experiments cannot be re-run directly.  Instead, this module implements a
discrete-event simulator of the paper's platform whose *only* calibration
inputs are the paper's own single-cluster measurements (Section 3.4) and
cache parameters (Section 3.3):

  * Cortex-A15 cluster: +2.8 GFLOPS per core for cores 1–3, +1.4 for the
    4th → 9.6 GFLOPS peak.
  * Cortex-A7 cluster: ≈2.4 GFLOPS peak with 4 cores.
  * (m_c, k_c): A15 (152, 952); A7 (80, 352); shared-k_c A7 m_c = 32.
  * Architecture-oblivious configs run the LITTLE cluster with the A15's
    parameters, whose A_c panel (152·952·8 B ≈ 1.16 MiB) overflows the A7's
    512 KiB L2 — modelled as a throughput penalty.

Everything else — SSS's ≈40 % of A15-only peak, the SAS optimum at ratio
5–6, CA-SAS's advantage at overloaded ratios, CA-DAS beating every static
variant — must *emerge* from the scheduling model.  Those derived claims
are asserted in ``tests/test_simulator.py`` and reported in EXPERIMENTS.md.

The schedulers exercised here are the same production partitioners from
:mod:`repro.core.schedule` that drive the TPU asymmetric training step —
the simulator is how we show they reproduce the paper before pointing them
at pods.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import blocking as B
from repro_torch.core import schedule as S

DTYPE_BYTES = 8  # paper uses IEEE double precision


@dataclasses.dataclass(frozen=True)
class ClusterModel:
    """One cluster, calibrated from the paper's Section 3 measurements."""

    name: str
    n_cores: int
    # Cumulative GFLOPS with 1..n cores active (Section 3.4).
    cum_gflops: tuple[float, ...]
    cache: B.CacheHierarchy
    blocking: B.GotoBlocking
    # Power model (W): cluster static + per-core active; waiting threads
    # poll (paper Section 5.2.2: "idle but active, polling") at a fraction
    # of active power.
    p_static: float
    p_core: float
    poll_frac: float = 0.8

    def rate(self, n_cores: int) -> float:
        return self.cum_gflops[min(n_cores, self.n_cores) - 1] * 1e9

    def power_model(
        self, n_cores: Optional[int] = None, effective_rate: Optional[float] = None
    ) -> B.PowerModel:
        """The spec-level :class:`~repro.core.blocking.PowerModel` equivalent
        of this cluster's Exynos constants.

        ``idle_w`` is the cluster static draw; the per-core active power
        becomes a per-FLOP term at ``effective_rate`` (achieved FLOP/s,
        default the calibrated :meth:`rate` for ``n_cores``).  By
        construction, energy scored through the returned model equals the
        simulator's :func:`_energy` accounting for this cluster (less the
        shared ``P_BASE`` board term) whenever the workload runs at
        ``effective_rate`` — the cross-check tested in
        ``tests/test_energy.py``.
        """

        nc = self.n_cores if n_cores is None else int(n_cores)
        rate = self.rate(nc) if effective_rate is None else float(effective_rate)
        if rate <= 0:
            raise ValueError("effective_rate must be positive")
        return B.PowerModel(
            idle_w=self.p_static,
            flop_j=nc * self.p_core / rate,
            byte_j=0.0,
            poll_frac=self.poll_frac,
        )


A15 = ClusterModel(
    name="cortex-a15",
    n_cores=4,
    cum_gflops=(2.8, 5.6, 8.2, 9.6),
    cache=B.CORTEX_A15,
    blocking=B.PAPER_A15,
    p_static=0.50,
    p_core=0.75,
)
A7 = ClusterModel(
    name="cortex-a7",
    n_cores=4,
    cum_gflops=(0.65, 1.25, 1.85, 2.4),
    cache=B.CORTEX_A7,
    blocking=B.PAPER_A7,
    p_static=0.05,
    p_core=0.08,
)
P_BASE = 0.35  # DRAM + board (paper instruments DRAM/GPU sensors separately)

# Throughput penalty when a cluster runs with blocking parameters whose A_c
# panel overflows its L2 (architecture-oblivious configuration, Section 4).
MISFIT_L2_PENALTY = 0.80
MISFIT_L1_PENALTY = 0.90
GRAB_OVERHEAD_S = 20e-6  # Section 5.4 critical section
BARRIER_S = 5e-6

EXYNOS_5422 = (A15, A7)


@dataclasses.dataclass
class SimResult:
    strategy: str
    r: int
    gflops: float
    makespan_s: float
    energy_j: float
    gflops_per_w: float
    sizes: tuple[int, ...]      # units (rows/cols) per cluster
    busy_s: tuple[float, ...]


# ---------------------------------------------------------------------------
# Effective cluster throughput
# ---------------------------------------------------------------------------


def _size_ramp(r: int) -> float:
    """Performance ramp with problem size (paper Figure 5 saturates ~r≥3k)."""

    return r / (r + 256.0)


def _config_penalty(cluster: ClusterModel, cfg: B.GotoBlocking) -> float:
    pen = 1.0
    if cfg.a_panel_bytes(DTYPE_BYTES) > cluster.cache.l2_bytes * cluster.cache.l2_fill / 0.6 * 1.0:
        # A_c overflowing the usable L2 (architecture-oblivious config).
        pen *= MISFIT_L2_PENALTY
    if cfg.b_micropanel_bytes(DTYPE_BYTES) > cluster.cache.l1_bytes:
        pen *= MISFIT_L1_PENALTY
    return pen


def _fine_grain_eff(cluster: ClusterModel, cfg: B.GotoBlocking, fine: str, n_cores: int) -> float:
    """Load-balance efficiency of the intra-cluster loop (Sections 3.1, 5.3.1).

    Loop 4 partitions ``n_c / n_r`` micro-kernel columns (hundreds —
    plenty); Loop 5 partitions ``m_c / m_r`` rows (tens — scarce, the
    paper's stated reason Loop 4 wins).
    """

    par = (cfg.nc // cfg.nr) if fine == "loop4" else max(1, cfg.mc // cfg.mr)
    return par / (n_cores * math.ceil(par / n_cores))


def _cluster_rate(
    cluster: ClusterModel,
    cfg: B.GotoBlocking,
    *,
    r: int,
    fine: str = "loop4",
    n_cores: Optional[int] = None,
) -> float:
    n = n_cores if n_cores is not None else cluster.n_cores
    return (
        cluster.rate(n)
        * _size_ramp(r)
        * _config_penalty(cluster, cfg)
        * _fine_grain_eff(cluster, cfg, fine, n)
    )


# ---------------------------------------------------------------------------
# Energy
# ---------------------------------------------------------------------------


def _energy(
    clusters: Sequence[ClusterModel],
    busy: Sequence[float],
    active_cores: Sequence[int],
    makespan: float,
) -> float:
    e = P_BASE * makespan
    for cl, b, nc in zip(clusters, busy, active_cores):
        e += cl.p_static * makespan
        if nc > 0:
            wait = makespan - b
            e += nc * (cl.p_core * b + cl.poll_frac * cl.p_core * wait)
    return e


# ---------------------------------------------------------------------------
# Scenarios
# ---------------------------------------------------------------------------


def simulate_single_cluster(
    r: int,
    cluster: ClusterModel,
    n_cores: int,
    *,
    fine: str = "loop4",
    clusters: Sequence[ClusterModel] = EXYNOS_5422,
) -> SimResult:
    """One cluster in isolation (paper Section 3.4 / Figure 5)."""

    flops = 2.0 * r**3
    rate = _cluster_rate(cluster, cluster.blocking, r=r, fine=fine, n_cores=n_cores)
    t = flops / rate
    busy = [t if cl is cluster else 0.0 for cl in clusters]
    cores = [n_cores if cl is cluster else 0 for cl in clusters]
    e = _energy(clusters, busy, cores, t)
    return SimResult(
        strategy=f"{cluster.name}-x{n_cores}",
        r=r,
        gflops=flops / t / 1e9,
        makespan_s=t,
        energy_j=e,
        gflops_per_w=flops / 1e9 / e,
        sizes=tuple(r if cl is cluster else 0 for cl in clusters),
        busy_s=tuple(busy),
    )


def ideal_gflops(r: int, clusters: Sequence[ClusterModel] = EXYNOS_5422) -> float:
    """The paper's 'Ideal' line: sum of isolated cluster peaks."""

    return sum(
        simulate_single_cluster(r, cl, cl.n_cores, clusters=clusters).gflops
        for cl in clusters
    )


def _configs_for(
    clusters: Sequence[ClusterModel], cache_aware: bool, coarse: str
) -> list[B.GotoBlocking]:
    """Per-cluster blocking parameters (control trees, Sections 5.1/5.3)."""

    if not cache_aware:
        # Single control tree: everyone runs the fast cluster's parameters.
        return [clusters[0].blocking for _ in clusters]
    if coarse == "loop3":
        # Shared B_c panel forces a common k_c; re-derive m_c for others
        # (the paper's k_c=952 → A7 m_c=32).
        kc = clusters[0].blocking.kc
        out = [clusters[0].blocking]
        for cl in clusters[1:]:
            d = B.derive_goto_blocking(cl.cache, shared_kc=kc)
            out.append(d)
        return out
    return [cl.blocking for cl in clusters]


def simulate_static(
    r: int,
    *,
    ratio: float = 1.0,
    cache_aware: bool = False,
    coarse: str = "loop1",
    fine: str = "loop4",
    clusters: Sequence[ClusterModel] = EXYNOS_5422,
) -> SimResult:
    """SSS (ratio=1, cache_aware=False), SAS, and CA-SAS (Sections 4, 5.2, 5.3)."""

    cfgs = _configs_for(clusters, cache_aware, coarse)
    # Units: columns for Loop 1, rows for Loop 3; flops per unit = 2 r^2.
    table = S.sas_partition(r, ratios=[ratio, 1.0][: len(clusters)])
    sizes = table.sizes()
    rates = [
        _cluster_rate(cl, cfg, r=r, fine=fine) for cl, cfg in zip(clusters, cfgs)
    ]
    times = [s * 2.0 * r * r / rt for s, rt in zip(sizes, rates)]
    makespan = max(times) + BARRIER_S
    flops = 2.0 * r**3
    cores = [cl.n_cores for cl in clusters]
    e = _energy(clusters, times, cores, makespan)
    name = "sss" if (ratio == 1.0 and not cache_aware) else ("ca-sas" if cache_aware else "sas")
    return SimResult(
        strategy=f"{name}(ratio={ratio},{coarse},{fine})",
        r=r,
        gflops=flops / makespan / 1e9,
        makespan_s=makespan,
        energy_j=e,
        gflops_per_w=flops / 1e9 / e,
        sizes=tuple(sizes),
        busy_s=tuple(times),
    )


def simulate_dynamic(
    r: int,
    *,
    cache_aware: bool = True,
    fine: str = "loop4",
    clusters: Sequence[ClusterModel] = EXYNOS_5422,
) -> SimResult:
    """DAS / CA-DAS: dynamic Loop-3 chunking (Section 5.4).

    Chunk stride is each cluster's own ``m_c`` (CA-DAS, two control trees)
    or the fast cluster's ``m_c`` for everyone (DAS, single tree).  The
    coarse loop is Loop 3 per the paper (n_c = 4096 is too coarse to
    distribute dynamically).
    """

    cfgs = _configs_for(clusters, cache_aware, "loop3")
    rates_flops = [
        _cluster_rate(cl, cfg, r=r, fine=fine) for cl, cfg in zip(clusters, cfgs)
    ]
    unit_flops = 2.0 * r * r  # one row of C
    res = S.das_schedule(
        r,
        rates=[rf / unit_flops for rf in rates_flops],
        strides=[cfg.mc for cfg in cfgs],
        grab_overhead=GRAB_OVERHEAD_S,
    )
    flops = 2.0 * r**3
    cores = [cl.n_cores for cl in clusters]
    e = _energy(clusters, res.busy, cores, res.makespan)
    name = "ca-das" if cache_aware else "das"
    return SimResult(
        strategy=f"{name}(loop3,{fine})",
        r=r,
        gflops=flops / res.makespan / 1e9,
        makespan_s=res.makespan,
        energy_j=e,
        gflops_per_w=flops / 1e9 / e,
        sizes=tuple(res.sizes()),
        busy_s=tuple(res.busy),
    )


def sweep_ratio(
    r: int,
    ratios: Sequence[float] = (1, 2, 3, 4, 5, 6, 7),
    **kw,
) -> list[SimResult]:
    return [simulate_static(r, ratio=float(x), **kw) for x in ratios]


__all__ = [
    "ClusterModel",
    "SimResult",
    "A15",
    "A7",
    "EXYNOS_5422",
    "simulate_single_cluster",
    "simulate_static",
    "simulate_dynamic",
    "sweep_ratio",
    "ideal_gflops",
]
