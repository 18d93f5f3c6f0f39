"""Candidate scoring: a roofline cost model and the card's own clock.

The port's ``repro.tuning.measure``.  Two interchangeable backends score a
``BlockConfig`` for one GEMM shape:

  * ``cost-model`` — a deterministic seconds estimate priced on the class
    spec (``peak_flops``, ``hbm_bw``, ``n_sm``): the grid's CTAs run in
    waves over the SMs, each SM with its share of the peak and of the
    bandwidth, plus a per-K-step overhead.  Pure Python; what the tests
    run and what the two-stage search prefilters with.
  * ``wallclock`` — the device time of the real kernel
    (``gemm_cuda``/``gemm_cuda_lean``) from CUDA events, the calls queued
    behind a device-side spin so the card, not the host's enqueue rate,
    sets the time.  On the CPU it times the kernel's plain version (the
    counterpart of the reference's interpret mode).

The cost model charges what the analytical derivation cannot see: padding
(a block bigger than the problem pays for zeros), SMs left idle by a grid
smaller than one wave (what separates the decode step's M = 12 blocks),
and per-step overhead.  The pipelined kernel overlaps its loads with the
tensor cores (``max(compute, memory)``); the one-stage lean kernel waits
for every load (``compute + memory``).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional, Sequence

from repro_torch.core.blocking import H100, BlockConfig, HopperClassSpec, PowerModel, pad_to_blocks
from repro_torch.core.execution import backend_stages
from repro_torch.core.schedule import validate_objective

# Fixed cost per K step of a CTA (a full/empty mbarrier round trip and the
# wgmma issue): a few hundred cycles.  Only needs to rank thousands of
# tiny steps below tens of large ones.
GRID_STEP_OVERHEAD_S = 2e-7

MEASURE_BACKEND_NAMES: tuple[str, ...] = ("cost-model", "wallclock")

# Device-side spin before the timed calls: long enough for the host to
# enqueue them all (tens of microseconds a call at decode shapes), so the
# start event fires with the queue already full.  Cycles at 2 GHz, the
# card's highest clock; a slower clock only lengthens the spin.
_CLOCK_HZ = 2e9


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    """Roofline terms for one (shape, config, variant) cell."""

    cfg: BlockConfig
    compute_s: float
    memory_s: float
    overhead_s: float
    grid: tuple[int, int, int]
    kernel_backend: str = "cuda"
    waves: int = 1
    flops: float = 0.0
    hbm_bytes: float = 0.0
    power: Optional[PowerModel] = None

    @property
    def time_s(self) -> float:
        """The pipelined ring hides loads under the tensor cores (``max``);
        the one-stage lean kernel waits for each load (``sum``)."""

        if backend_stages(self.kernel_backend) > 1:
            return max(self.compute_s, self.memory_s) + self.overhead_s
        return self.compute_s + self.memory_s + self.overhead_s

    @property
    def bottleneck(self) -> str:
        return "compute" if self.compute_s >= self.memory_s else "memory"

    @property
    def energy_j(self) -> float:
        if self.power is None:
            raise ValueError("CostBreakdown has no power model attached")
        return self.power.energy_j(self.time_s, self.flops, self.hbm_bytes)

    @property
    def edp(self) -> float:
        return self.energy_j * self.time_s

    def score(self, objective: str = "perf") -> float:
        validate_objective(objective)
        if objective == "perf":
            return self.time_s
        if objective == "energy":
            return self.energy_j
        return self.edp


def cost_breakdown(
    m: int,
    k: int,
    n: int,
    cfg: BlockConfig,
    *,
    spec: HopperClassSpec = H100,
    kernel_backend: str = "cuda",
) -> CostBreakdown:
    """Deterministic roofline estimate of one blocked-GEMM launch.

    Each CTA owns a ``bm x bn`` tile and streams its A rows and B columns
    over K (so A is re-read once per column of tiles, B once per row),
    then writes its tile.  TMA reads no bytes for rows or columns past the
    problem's edge, so a CTA's bytes count at most the problem's rows and
    columns, while the tensor cores compute the whole padded tile.  The
    ``gm x gn`` CTAs run in ``ceil(gm·gn / n_sm)`` waves; within a wave
    every SM gets ``1/n_sm`` of the peak and of the bandwidth, so a grid of
    fewer CTAs than SMs leaves the rest idle.
    """

    pm, pk, pn = pad_to_blocks(m, k, n, cfg)
    gm, gn, gk = pm // cfg.bm, pn // cfg.bn, pk // cfg.bk
    tiles = gm * gn
    waves = -(-tiles // spec.n_sm)
    rows, cols = min(cfg.bm, m), min(cfg.bn, n)
    cta_flops = 2.0 * cfg.bm * cfg.bn * pk
    cta_bytes = ((rows + cols) * k + rows * cols) * cfg.dtype_bytes
    return CostBreakdown(
        cfg=cfg,
        compute_s=waves * cta_flops * spec.n_sm / spec.peak_flops,
        memory_s=waves * cta_bytes * spec.n_sm / spec.hbm_bw,
        overhead_s=waves * gk * GRID_STEP_OVERHEAD_S,
        grid=(gm, gn, gk),
        kernel_backend=kernel_backend,
        waves=waves,
        flops=tiles * cta_flops,
        hbm_bytes=float(tiles * cta_bytes),
        power=spec.power,
    )


def cost_model_time(
    m: int, k: int, n: int, cfg: BlockConfig, *,
    spec: HopperClassSpec = H100, kernel_backend: str = "cuda",
) -> float:
    """Scalar objective (seconds) of the cost-model backend."""

    return cost_breakdown(m, k, n, cfg, spec=spec, kernel_backend=kernel_backend).time_s


def cost_model_score(
    m: int, k: int, n: int, cfg: BlockConfig, *,
    spec: HopperClassSpec = H100, kernel_backend: str = "cuda", objective: str = "perf",
) -> float:
    """Seconds (``perf``), modeled joules (``energy``) or J·s (``edp``)."""

    return cost_breakdown(
        m, k, n, cfg, spec=spec, kernel_backend=kernel_backend
    ).score(objective)


def device_seconds(calls: Sequence[Callable[[], object]], *, rounds: int = 3) -> float:
    """Median device seconds of one call, on the current CUDA device.

    Each round waits for the card, queues a spin on it, then records a
    start event, every call of ``calls`` and an end event while the spin
    runs, so the events bracket the kernels back to back and not the
    host's enqueue.  The spin lasts twice the host time the calls took
    to enqueue in a first, untimed round.
    """

    import torch

    calls[0]()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for fn in calls:
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin = int(2 * host_s * _CLOCK_HZ) + 10_000
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    per_call = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        torch.cuda._sleep(spin)
        start.record()
        for fn in calls:
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / 1e3 / len(calls))
    per_call.sort()
    return per_call[len(per_call) // 2]


def _device(device):
    """``device``, or the card when one is present and none was named."""

    import torch

    return torch.device(device or ("cuda" if torch.cuda.is_available() else "cpu"))


def wallclock_time(
    m: int,
    k: int,
    n: int,
    cfg: BlockConfig,
    *,
    dtype=None,
    device=None,
    reps: int = 10,
    warmup: int = 1,
    kernel_backend: str = "cuda",
) -> float:
    """Seconds of one call of the kernel variant ``kernel_backend``.

    On a CUDA device (the default when a card is present): the kernel's
    device time (:func:`device_seconds`) over ``reps`` calls or more, its B
    operand cycled over enough copies (up to 64) to exceed the 50 MB L2, so
    each call finds its weights cold, as a decode step does.
    The CUDA GEMM takes bf16 operands only, so any other dtype raises.
    On the CPU: the median host seconds of the kernel's plain version.
    """

    import torch

    from repro_torch.core.execution import plain_twin, BACKENDS
    from repro_torch.kernels.gemm import GEMM_KERNELS
    from repro_torch.runtime.serving import resolve_device

    if kernel_backend not in GEMM_KERNELS:
        raise ValueError(
            f"wallclock cannot time kernel backend {kernel_backend!r}; "
            f"known: {sorted(GEMM_KERNELS)}"
        )
    device = _device(device)
    dtype = dtype or (torch.bfloat16 if cfg.dtype_bytes == 2 else torch.float32)
    if device.type == "cuda" and dtype != torch.bfloat16:
        raise TypeError(
            f"wallclock on the card times the CUDA GEMM, which takes bf16 operands, "
            f"not {dtype}; tune f32 with --backend cost-model"
        )
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((m, k), generator=gen, device=device).to(dtype)
    copies = 1
    if device.type == "cuda":
        copies = min(64, math.ceil(128e6 / max(1, k * n * 2)))
    bs = [(torch.randn((k, n), generator=gen, device=device) / math.sqrt(k)).to(dtype)
          for _ in range(copies)]

    if device.type == "cuda":
        kernel = GEMM_KERNELS[kernel_backend]
        calls = [lambda b=bs[i % copies]: kernel(a, b, cfg) for i in range(max(reps, copies))]
        with torch.cuda.device(device):
            return device_seconds(calls)

    plain = BACKENDS[plain_twin(kernel_backend)]
    for _ in range(warmup):
        plain(a, bs[0], cfg, dtype)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        plain(a, bs[0], cfg, dtype)
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def make_backend(
    name: str,
    *,
    spec: HopperClassSpec = H100,
    dtype=None,
    objective: str = "perf",
    device=None,
) -> Callable[..., float]:
    """Resolve a backend name to a ``(m, k, n, cfg) -> score`` scorer.

    Scorers also accept ``kernel_backend=``.  Only the cost model can
    price energy (a clock measures seconds, not joules), so ``wallclock``
    with a non-``perf`` objective raises.
    """

    validate_objective(objective)
    if name == "cost-model":
        return lambda m, k, n, cfg, kernel_backend="cuda": cost_model_score(
            m, k, n, cfg, spec=spec, kernel_backend=kernel_backend, objective=objective,
        )
    if name == "wallclock":
        if objective != "perf":
            raise ValueError(
                f"wallclock backend cannot score objective {objective!r}; "
                "the clock measures seconds, not joules — use cost-model"
            )
        from repro_torch.runtime.serving import resolve_device

        device = resolve_device(_device(device))
        return lambda m, k, n, cfg, kernel_backend="cuda": wallclock_time(
            m, k, n, cfg, dtype=dtype, device=device, kernel_backend=kernel_backend
        )
    raise ValueError(f"unknown measure backend {name!r} (cost-model|wallclock)")


__all__ = [
    "GRID_STEP_OVERHEAD_S",
    "MEASURE_BACKEND_NAMES",
    "CostBreakdown",
    "cost_breakdown",
    "cost_model_score",
    "cost_model_time",
    "device_seconds",
    "make_backend",
    "wallclock_time",
]
