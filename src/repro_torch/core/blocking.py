"""Shared-memory/register-aware GEMM blocking configuration for Hopper.

The port's counterpart of ``repro.core.blocking``.  The paper's Section
3.3 derivation (``derive_goto_blocking`` and the ``PAPER_*`` optima) is
carried over verbatim; the accelerator derivation is rebuilt for an
NVIDIA H100 instead of a TPU core:

  * the fast memory a block's staged A/B tiles live in is the SM's
    shared memory (232,448 bytes a block can claim), not 16 MiB of VMEM;
    TMA writes the tiles in the 128-byte swizzle that ``wgmma`` reads
    without bank conflicts, so a stage is exactly its A and B tiles plus
    a full and an empty ``mbarrier``, with no padding;
  * the fp32 accumulator lives in the registers of the consumer
    warpgroups (one per 64 rows of the tile), so it is checked against a
    per-thread register budget instead of the fast-memory budget;
  * the Pallas pipeline's double-buffered BlockSpec staging becomes a
    ``stages``-deep TMA ring (``PIPELINE_STAGES`` = 4 for the pipelined
    kernel, 1 for the lean kernel), in depth slices ``bk`` that are whole
    64-value swizzle rows;
  * blocks run in parallel on 132 SMs instead of in order on one core,
    so the derivation first fills one wave of SMs with output tiles and
    only then maximizes arithmetic intensity.

Block shapes therefore differ from the reference's; what carries over is
the structure: a shared ``bk`` under Loop 3, a lean micro-kernel for the
class whose fast memory cannot hold the shared panel pipelined, and the
rejection of blocks larger than the (tile-rounded) problem.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

# ---------------------------------------------------------------------------
# Hardware descriptions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CacheHierarchy:
    """A classical cache hierarchy (paper's target)."""

    name: str
    l1_bytes: int
    l2_bytes: int
    l3_bytes: int = 0  # Exynos 5422 has no L3
    line_bytes: int = 64
    # Fraction of each level the GEMM working set may claim.  The remainder
    # is reserved for the C micro-tile, stack, and streaming interference —
    # mirroring how the paper's empirical optima sit below full capacity.
    l1_fill: float = 0.95
    l2_fill: float = 0.60


@dataclasses.dataclass(frozen=True)
class PowerModel:
    """Per-device-class power model: idle + per-FLOP + per-byte terms.

    The structure mirrors the calibrated big.LITTLE simulator
    (``repro.core.simulator.ClusterModel.p_static / p_core / poll_frac``):
    a static floor drawn whenever the device is powered, an activity term
    proportional to work executed, and a polling fraction for the
    busy-wait-while-idle state the paper measures on the Cortex-A15
    (spinning cores burn ~80% of active power).  ``gated_w`` is the draw
    of a *parked* device (power-gated / hot-unplugged, the mechanism of
    the energy-aware AMP follow-on work) — 0 by default.

    :meth:`repro.core.simulator.ClusterModel.power_model` derives an
    instance from the Exynos constants so the two models cross-check.
    """

    idle_w: float
    flop_j: float            # joules per FLOP when active
    byte_j: float = 0.0      # joules per HBM byte moved
    poll_frac: float = 0.8   # fraction of active-over-idle power while polling
    gated_w: float = 0.0     # draw when parked (power-gated)

    def active_w(self, flops_per_s: float, bytes_per_s: float = 0.0) -> float:
        """Modeled draw while executing at the given rates."""
        return self.idle_w + self.flop_j * flops_per_s + self.byte_j * bytes_per_s

    def poll_w(self, flops_per_s: float, bytes_per_s: float = 0.0) -> float:
        """Modeled draw while busy-waiting (powered but starved of work)."""
        over = self.active_w(flops_per_s, bytes_per_s) - self.idle_w
        return self.idle_w + self.poll_frac * over

    def energy_j(self, time_s: float, flops: float, bytes_moved: float = 0.0) -> float:
        """Joules for a unit of work taking ``time_s`` wall seconds."""
        return self.idle_w * time_s + self.flop_j * flops + self.byte_j * bytes_moved


# Modeled power constants for the two classes.  The same structure as the
# reference's TPU pair: the big class draws more per unit of time, the
# little class is cheaper per unit of work.  Modeled, not measured.
# The energy objective's efficiency order (``AsymmetricMesh.
# pods_by_efficiency``: active watts per unit of ``rel_throughput``) rests
# on a thin margin: little 45 + 2e-13 x 494.5e12 + 1e-11 x 1.675e12 =
# 160.7 W over 0.25 = 642.6 W a unit, big 90 + 494.5 + 67.0 = 651.5 W a
# unit, 1.4% apart.  Retuning any of these constants (or the little
# class's 0.25) can swap the order, and with it which pod the energy
# objective parks.
HOPPER_POWER = PowerModel(idle_w=90.0, flop_j=5.0e-13, byte_j=2.0e-11)
HOPPER_LITTLE_POWER = PowerModel(idle_w=45.0, flop_j=2.0e-13, byte_j=1.0e-11)


@dataclasses.dataclass(frozen=True)
class HopperClassSpec:
    """One device class on a Hopper card, as the blocking derivation sees it.

    The static defaults are the H100 SXM data sheet's; :func:`hopper_spec`
    replaces the shared-memory size and SM count with the values
    ``torch.cuda.get_device_properties`` reports when a card is present.
    """

    name: str = "h100"
    smem_bytes: int = 232_448          # dynamic shared memory a block may claim
    n_sm: int = 132
    regs_per_thread: int = 255
    regs_per_sm: int = 65_536
    # The GEMM kernel's largest block: two consumer warpgroups (bm = 128)
    # and one producer warpgroup.
    threads_per_block: int = 384
    # fp32 accumulators a consumer thread may hold: a 64 x 256 wgmma tile
    # over 128 threads (the consumers raise their share to 232 registers).
    acc_regs_per_thread: int = 128
    align: int = 16                    # M/N alignment of the derivation's shape buckets
    peak_flops: float = 989e12         # dense bf16 tensor-core peak
    hbm_bw: float = 3.35e12
    # Fraction of shared memory the A/B ring may claim (the rest is left
    # to the driver's per-block reservation).
    smem_fill: float = 0.9
    power: PowerModel = HOPPER_POWER


# Paper's platform (Section 3.2): per-core L1d 32 KiB; L2 shared per
# cluster — 2 MiB for the Cortex-A15 quad, 512 KiB for the Cortex-A7 quad.
CORTEX_A15 = CacheHierarchy("cortex-a15", l1_bytes=32 * 1024, l2_bytes=2 * 1024 * 1024)
CORTEX_A7 = CacheHierarchy("cortex-a7", l1_bytes=32 * 1024, l2_bytes=512 * 1024)

H100 = HopperClassSpec()

# The modeled little class on the same card, related to H100 as the
# reference's TPU_LITTLE is to TPU_V5E: half the shared-memory budget,
# half the peak FLOP/s and half the bandwidth.
H100_LITTLE = HopperClassSpec(
    name="h100-little",
    smem_bytes=H100.smem_bytes // 2,
    peak_flops=H100.peak_flops / 2,
    hbm_bw=H100.hbm_bw / 2,
    power=HOPPER_LITTLE_POWER,
)


@functools.lru_cache(maxsize=None)
def hopper_spec(little: bool = False, device=None) -> HopperClassSpec:
    """The class spec with shared memory and SM count read from the card.

    Falls back to the static H100 copy when no card is present (the CPU
    tests).  The little class keeps its halving relative to the card.
    Memoised, so the device classes and the tuner's ``SPECS`` hold one
    object per class.
    """

    import torch

    base = H100_LITTLE if little else H100
    if not torch.cuda.is_available():
        return base
    props = torch.cuda.get_device_properties(device or 0)
    smem = int(getattr(props, "shared_memory_per_block_optin", H100.smem_bytes))
    return dataclasses.replace(
        base,
        smem_bytes=smem // 2 if little else smem,
        n_sm=int(props.multi_processor_count),
    )


# ---------------------------------------------------------------------------
# Block configurations
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GotoBlocking:
    """The paper's five BLIS parameters for one core class."""

    mc: int
    kc: int
    nc: int
    mr: int = 4
    nr: int = 4

    def a_panel_bytes(self, dtype_bytes: int = 8) -> int:
        return self.mc * self.kc * dtype_bytes

    def b_micropanel_bytes(self, dtype_bytes: int = 8) -> int:
        return self.kc * self.nr * dtype_bytes


# Output-tile shapes the CUDA GEMM kernel is compiled for (one template
# instance per pair): bm is one or two 64-row wgmma warpgroups; bn a wgmma
# width (32 and 64 keep the decode step's M = 12 tiles filling the SMs).
BM_TILES = (64, 128)
BN_TILES = (32, 64, 128, 256)
# ``bk`` is a runtime multiple of one 128-byte swizzle row of bf16.
BK_ALIGN = 64
MAX_BK = 256
# A full and an empty mbarrier (8 bytes each) guard every stage of the ring.
BARRIER_BYTES = 16
# Ring depth of the pipelined kernel: with four stages the producer's loads
# run three stages ahead of the products, with two only one.  Every block
# derived for the pipelined kernel fits four stages; a wider block derived
# under the lean model runs the deepest ring of at least two that fits
# (``kernels/gemm.ring_depth``).  ``chip_smoke.py`` phase 1 times the ring
# against the one-stage kernel at the forward's shapes.
PIPELINE_STAGES = 4
# The shallowest ring the pipelined kernel runs a block with: a tuned block
# for it must fit two stages (a block that fits one stage only is the lean
# kernel's).
MIN_PIPELINE_STAGES = 2
WARPGROUP = 128       # threads of one warpgroup
WGMMA_M = 64          # rows of one wgmma tile, one consumer warpgroup


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """CUDA GEMM block shapes (the Hopper analogue of ``GotoBlocking``).

    Each block owns a ``bm x bn`` output tile, accumulated in the fp32
    registers of ``bm / 64`` consumer warpgroups, and streams K in ``bk``
    slices: a ``bm x bk`` A tile and a ``bk x bn`` B tile per stage of a
    TMA ring in shared memory.
    """

    bm: int
    bk: int
    bn: int
    dtype_bytes: int = 2          # bf16 operands
    acc_bytes: int = 4            # fp32 accumulator

    def smem_bytes(self, stages: int = PIPELINE_STAGES) -> int:
        """Shared memory of the staging ring: ``stages x (A + B)`` swizzled
        tiles and each stage's two barriers.  ``stages=1`` is the lean
        kernel (``gemm_cuda_lean``), which stages one A/B pair at a time —
        half the footprint, so larger (bm, bn) panels fit."""

        a = self.bm * self.bk * self.dtype_bytes
        b = self.bk * self.bn * self.dtype_bytes
        return stages * (a + b + BARRIER_BYTES)

    def consumer_warpgroups(self) -> int:
        return -(-self.bm // WGMMA_M)

    def threads(self) -> int:
        """Threads of the kernel's block: the consumers and one producer
        warpgroup."""

        return WARPGROUP * (self.consumer_warpgroups() + 1)

    def acc_regs_per_thread(self) -> int:
        """fp32 accumulator registers each consumer thread holds: its
        warpgroup's 64 x bn share of the tile over 128 threads."""

        return -(-self.bm * self.bn * self.acc_bytes // (4 * WARPGROUP * self.consumer_warpgroups()))

    def fits(self, spec: HopperClassSpec = H100, *, stages: int = PIPELINE_STAGES) -> bool:
        return (
            self.smem_bytes(stages) <= spec.smem_bytes * spec.smem_fill
            and self.acc_regs_per_thread() <= spec.acc_regs_per_thread
            and self.threads() <= spec.threads_per_block
        )

    def arithmetic_intensity(self) -> float:
        """FLOPs per device-memory byte staged for one (bm, bn) tile step."""
        flops = 2.0 * self.bm * self.bn * self.bk
        bytes_moved = (self.bm * self.bk + self.bk * self.bn) * self.dtype_bytes
        return flops / bytes_moved


# ---------------------------------------------------------------------------
# Paper derivation (CPU caches)
# ---------------------------------------------------------------------------


def derive_goto_blocking(
    cache: CacheHierarchy,
    *,
    dtype_bytes: int = 8,
    mr: int = 4,
    nr: int = 4,
    kc_cap: Optional[int] = None,
    shared_kc: Optional[int] = None,
) -> GotoBlocking:
    """Analytic (m_c, k_c, n_c) for a cache hierarchy, per paper Section 3.3.

    * ``k_c``: the B micro-panel ``k_c x n_r`` must stream from L1 —
      ``k_c * n_r * dtype_bytes <= l1_fill * l1_bytes``.
    * ``m_c``: the A macro-panel ``m_c x k_c`` must reside in L2 —
      ``m_c * k_c * dtype_bytes <= l2_fill * l2_bytes``.
    * ``n_c``: bounded by L3 when present, otherwise the paper's 4096.

    ``shared_kc`` reproduces the Section 5.3 constraint: when Loop 3 is the
    inter-cluster loop the ``B_c`` buffer is shared, forcing a common
    ``k_c`` across classes and a re-derived (smaller) ``m_c`` for the class
    whose L2 cannot hold ``m_c x k_c`` at the shared ``k_c``.
    """

    if shared_kc is not None:
        kc = shared_kc
    else:
        kc = int(cache.l1_fill * cache.l1_bytes / (nr * dtype_bytes))
        # Keep a multiple of 8 like BLIS does for vector-friendly strides.
        kc = max(8, (kc // 8) * 8)
        if kc_cap is not None:
            kc = min(kc, kc_cap)

    mc = int(cache.l2_fill * cache.l2_bytes / (kc * dtype_bytes))
    mc = max(mr, (mc // mr) * mr)
    # Degenerate hierarchies (L2 ≈ L1): the m_c >= m_r floor can overflow
    # L2 — give k_c back until the minimal m_r-row panel fits.
    if shared_kc is None:
        while mc * kc * dtype_bytes > cache.l2_bytes and kc > 8:
            kc = max(8, ((kc // 2) // 8) * 8)
            mc = max(mr, (int(cache.l2_fill * cache.l2_bytes / (kc * dtype_bytes)) // mr) * mr)

    if cache.l3_bytes:
        nc = int(0.5 * cache.l3_bytes / (kc * dtype_bytes))
        nc = max(nr, (nc // nr) * nr)
    else:
        nc = 4096  # paper: "n_c plays a minor role ... set to 4096"
    return GotoBlocking(mc=mc, kc=kc, nc=nc, mr=mr, nr=nr)


# The paper's empirically-determined optima (Section 3.3 / Figure 4),
# recorded for validation and used verbatim by the calibrated simulator.
PAPER_A15 = GotoBlocking(mc=152, kc=952, nc=4096)
PAPER_A7 = GotoBlocking(mc=80, kc=352, nc=4096)
# Section 5.3: shared k_c = 952 (Loop-3 coarse partitioning) forces the
# Cortex-A7 macro-panel down to m_c = 32.
PAPER_A7_SHARED_KC = GotoBlocking(mc=32, kc=952, nc=4096)


# ---------------------------------------------------------------------------
# Hopper derivation (shared memory + registers)
# ---------------------------------------------------------------------------


def _round_down(x: int, mult: int) -> int:
    return max(mult, (x // mult) * mult)


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def largest_tile(choices, limit: int) -> int:
    """The largest compiled tile size ``<= limit`` (the smallest if none)."""

    fit = [c for c in choices if c <= limit]
    return max(fit) if fit else min(choices)


# Memoised: the serving path calls it for every GEMM, and the search costs
# 16-34 us a call on the host of an H100 machine, 4.1 ms over a decode step
# of internlm2-1.8b (``python -m repro_torch.launch.profile_decode``).
@functools.lru_cache(maxsize=4096)
def derive_block_config(
    m: int,
    k: int,
    n: int,
    *,
    spec: HopperClassSpec = H100,
    dtype_bytes: int = 2,
    max_bk: int = MAX_BK,
    stages: int = PIPELINE_STAGES,
) -> BlockConfig:
    """Pick ``(bm, bk, bn)`` for the CUDA GEMM kernels of one class.

    The reference's rule — the largest resident panel maximizes the
    arithmetic intensity of every staged byte — holds within a block, but
    Hopper blocks run side by side: a tile so large that the grid leaves
    SMs idle loses more than its intensity wins.  So candidates are ranked
    by ``(min(tiles, n_sm), intensity, -smem)``: first fill one wave of
    SMs, then maximize intensity, then prefer the smaller footprint.

    ``bm``/``bn`` come from the compiled tile sets, clamped to the
    tile-rounded problem; ``bm x bn`` must keep its fp32 accumulator
    within the consumer threads' register budget; ``bk`` is the largest
    depth, in whole swizzle rows of ``BK_ALIGN`` values, whose
    ``stages``-deep ring fits the class's shared memory (``stages=1``
    derives for the lean kernel: the same budget admits a deeper or wider
    panel).
    """

    budget = int(spec.smem_bytes * spec.smem_fill)
    align = spec.align
    pm = _round_up(m, align)
    pn = _round_up(n, align)
    pk = _round_up(min(k, max_bk), BK_ALIGN)

    best: Optional[BlockConfig] = None
    best_key = None
    bms = [t for t in BM_TILES if t <= pm] or [min(BM_TILES)]
    bns = [t for t in BN_TILES if t <= pn] or [min(BN_TILES)]
    for bm in reversed(bms):
        for bn in reversed(bns):
            per_k = stages * (bm + bn) * dtype_bytes
            fixed = stages * BARRIER_BYTES
            if fixed + per_k * BK_ALIGN > budget:
                continue
            bk = _round_down(min(pk, (budget - fixed) // per_k), BK_ALIGN)
            cfg = BlockConfig(bm=bm, bk=bk, bn=bn, dtype_bytes=dtype_bytes)
            if not cfg.fits(spec, stages=stages):
                continue
            tiles = -(-m // bm) * -(-n // bn)
            key = (min(tiles, spec.n_sm), cfg.arithmetic_intensity(),
                   -cfg.smem_bytes(stages))
            if best_key is None or key > best_key:
                best, best_key = cfg, key
    assert best is not None, "no feasible block config — shared memory budget too small"
    return best


def pad_to_blocks(m: int, k: int, n: int, cfg: BlockConfig) -> tuple[int, int, int]:
    """Problem dims rounded up to whole blocks (the grid's extent)."""

    return (_round_up(m, cfg.bm), _round_up(k, cfg.bk), _round_up(n, cfg.bn))


__all__ = [
    "BARRIER_BYTES",
    "BK_ALIGN",
    "BM_TILES",
    "BN_TILES",
    "MAX_BK",
    "MIN_PIPELINE_STAGES",
    "PIPELINE_STAGES",
    "WARPGROUP",
    "WGMMA_M",
    "CacheHierarchy",
    "HopperClassSpec",
    "GotoBlocking",
    "BlockConfig",
    "PowerModel",
    "CORTEX_A15",
    "CORTEX_A7",
    "H100",
    "H100_LITTLE",
    "PAPER_A15",
    "PAPER_A7",
    "PAPER_A7_SHARED_KC",
    "derive_goto_blocking",
    "derive_block_config",
    "hopper_spec",
    "largest_tile",
    "pad_to_blocks",
]
