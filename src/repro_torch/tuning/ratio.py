"""Per-class throughput-ratio calibration (paper Section 5.2.2).

The port's ``repro.tuning.ratio``.  On one H100 the little class is a
modeled spec on the same card, so a wallclock ratio between the classes
comes from per-class measurements (``measurements=``), which the serving
engine's step-time probe supplies.

The paper exposes the big:LITTLE work ratio as a knob, sweeps it (Figure
7), and picks the value where the clusters finish together.  Here the same
calibration is produced two ways:

  * :func:`calibrate_class_ratios` — *measure* each device class: score a
    probe GEMM on each class's core spec with a tuning backend (cost-model
    by default, wallclock on hardware) using that class's tuned or
    analytical block config, then normalize aggregate class throughput to
    the fastest.  This replaces the hand-typed ``rel_throughput`` numbers
    in :mod:`repro_torch.core.asymmetric`.
  * :func:`sweep_ratio_knob` — reproduce the paper's explicit knob sweep
    on the calibrated big.LITTLE *simulator* (:mod:`repro_torch.core.simulator`)
    and return the GFLOPS-optimal ratio, validating that the measured
    calibration lands where the sweep's optimum sits.

The result feeds ``AsymmetricMesh.from_calibration(...)`` and thereby the
``DynamicScheduler``'s ``init_ratios`` — a calibrated starting point that
the between-steps feedback then refines online.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.core import simulator as SIM
from repro_torch.core.blocking import BlockConfig
from repro_torch.tuning.candidates import analytical_config
from repro_torch.tuning.measure import cost_model_time, wallclock_time


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Calibrated per-class relative throughput (fastest class == 1.0)."""

    class_names: tuple[str, ...]
    ratios: tuple[float, ...]          # per-chip, normalized to max
    probe_shape: tuple[int, int, int]
    backend: str
    times_s: tuple[float, ...]         # per-class probe time (one chip)

    @property
    def init_ratios(self) -> list[float]:
        return list(self.ratios)

    def knob(self) -> float:
        """The paper's scalar big:LITTLE ratio (fast rate / slow rate)."""

        return max(self.ratios) / min(self.ratios)


@dataclasses.dataclass(frozen=True)
class ClassMeasurement:
    """One class's measured work: ``units`` completed in ``seconds``.

    The wallclock feed for :func:`calibrate_class_ratios`: per-pod step
    times (rows or tokens per step), e.g. the step-time probe's per-class
    seconds (``StepTimeProbe.last_measured`` over ``probe_shape[0]`` rows),
    timed under each class's execution context on the card.
    """

    name: str
    units: float
    seconds: float

    @property
    def rate(self) -> float:
        return self.units / self.seconds


def _ratios_from_measurements(
    classes: Sequence, measurements: Sequence[ClassMeasurement]
) -> tuple[list[float], list[float]]:
    """Per-chip ratios (and raw seconds) from measured per-pod step times."""

    by_name = {m.name: m for m in measurements}
    missing = [c.name for c in classes if c.name not in by_name]
    if missing:
        raise ValueError(f"measurements missing classes {missing}")
    # rel_throughput is per *chip*: divide the pod rate by its chip count
    # so a big pod does not look fast merely by being wide.
    rates = [
        by_name[c.name].rate / max(1, getattr(c, "chips_per_pod", 1)) for c in classes
    ]
    top = max(rates)
    return [r / top for r in rates], [by_name[c.name].seconds for c in classes]


def calibrate_class_ratios(
    classes: Sequence,
    *,
    probe_shape: tuple[int, int, int] = (1024, 1024, 1024),
    backend: str = "cost-model",
    dtype_bytes: int = 2,
    configs: Optional[Sequence[BlockConfig]] = None,
    measurements: Optional[Sequence[ClassMeasurement]] = None,
) -> Calibration:
    """Measure per-class throughput ratios on a probe GEMM.

    ``classes`` are :class:`repro_torch.core.asymmetric.DeviceClass` instances
    (anything with ``.name`` and ``.spec``).  Each class is probed with its
    *own* block config — pass ``configs`` to use tuned entries, otherwise
    each class gets its analytical derivation (the "two control trees" of
    Section 5.3 applied to calibration itself).

    ``measurements`` short-circuits the probe entirely: pass per-class
    :class:`ClassMeasurement` records (per-pod step times, e.g. the
    probe's) and the ratios come straight from them — the only way
    ``backend="wallclock"`` can calibrate *heterogeneous* class specs,
    since one card cannot time two different chips.
    """

    m, k, n = probe_shape
    if measurements is not None:
        ratios, secs = _ratios_from_measurements(classes, measurements)
        return Calibration(
            class_names=tuple(c.name for c in classes),
            ratios=tuple(ratios),
            probe_shape=probe_shape,
            backend=backend,
            times_s=tuple(secs),
        )
    if backend == "wallclock" and len({c.spec.name for c in classes}) > 1:
        # Wall-clock timing runs every probe on *this* card: it can only
        # distinguish block-config effects, not the classes' different
        # hardware, so heterogeneous specs would calibrate to ~1:1 and
        # overload the slow class.  Measure each class under its own
        # context and feed the times back via ``measurements=``
        # (ClassMeasurement records, e.g. the step-time probe's), or use
        # the cost model.
        raise ValueError(
            "wallclock calibration cannot compare heterogeneous core specs "
            "on one host; use backend='cost-model' or pass per-pod measured "
            "step times via measurements=[ClassMeasurement(...), ...]"
        )
    times = []
    for i, cls in enumerate(classes):
        spec = cls.spec
        cfg = configs[i] if configs is not None else analytical_config(
            m, k, n, spec=spec, dtype_bytes=dtype_bytes
        )
        if backend == "cost-model":
            t = cost_model_time(m, k, n, cfg, spec=spec)
        elif backend == "wallclock":
            t = wallclock_time(m, k, n, cfg)
        else:
            raise ValueError(f"unknown calibration backend {backend!r}")
        times.append(t)
    rates = [1.0 / t for t in times]
    top = max(rates)
    return Calibration(
        class_names=tuple(c.name for c in classes),
        ratios=tuple(r / top for r in rates),
        probe_shape=probe_shape,
        backend=backend,
        times_s=tuple(times),
    )


def sweep_ratio_knob(
    r: int = 4096,
    ratios: Sequence[float] = (1, 2, 3, 4, 5, 6, 7),
    *,
    cache_aware: bool = True,
    clusters: Sequence[SIM.ClusterModel] = SIM.EXYNOS_5422,
) -> tuple[float, list[SIM.SimResult]]:
    """Paper Figure 7: sweep the static ratio knob, return the optimum.

    Runs the calibrated big.LITTLE simulator over candidate ratios and
    returns ``(best_ratio, all_results)`` where best maximizes GFLOPS.
    """

    results = [
        SIM.simulate_static(r, ratio=float(x), cache_aware=cache_aware, clusters=clusters)
        for x in ratios
    ]
    best = max(zip(ratios, results), key=lambda p: p[1].gflops)
    return float(best[0]), results


__all__ = [
    "Calibration",
    "ClassMeasurement",
    "calibrate_class_ratios",
    "sweep_ratio_knob",
]
