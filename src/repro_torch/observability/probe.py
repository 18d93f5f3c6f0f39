"""Measured per-pod step times: the probe that closes the DAS loop.

The port's ``repro.observability.probe``.  One step of the engine's
single program yields one wall time, so per-pod attribution needs a
measurement: :class:`StepTimeProbe` periodically times a probe GEMM under
each class's execution context (the class's own control tree picks its
kernel and block shapes, so the measurement is that class's per-row
cost) and between refreshes reports

    ``times[pod] = units[pod] * row_seconds[class(pod)]``

for the units the engine actually ran on each pod.  Under
``DynamicScheduler.observe`` the rate then reduces to ``1 / s_c``: pure
class speed, independent of occupancy.

On the card the default workload is a bf16 GEMM on the engine's device
through ``ops.gemm``, so the class's tree launches its own kernel
(``gemm_cuda`` for big, ``gemm_cuda_lean`` for little), timed on the
device with CUDA events (``tuning.measure.device_seconds``).  On the CPU
the class's tree runs what it names there, timed on the host clock.

The probe is the engine's default ``pod_time_hook`` but stays inert
(returns ``None``; calibration frozen, zero work) until observability is
enabled.  Pass ``always=True`` to measure regardless.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

from repro_torch.observability import metrics as MET
from repro_torch.observability import trace as T

_ROW_SECONDS = MET.gauge(
    "probe_row_seconds",
    "Measured per-row step cost of one device class (last refresh)",
    labels=("device_class",),
)
_REFRESHES = MET.counter(
    "probe_refreshes_total", "Probe re-measurement rounds performed"
)


class StepTimeProbe:
    """``ServingEngine(pod_time_hook=...)`` implementation on measured time.

    Parameters
    ----------
    asym : the engine's :class:`~repro_torch.core.asymmetric.AsymmetricMesh`
        (its per-class execution contexts are what get timed).
    probe_shape : the GEMM the default workload times under each class's
        context; rows (``m``) are the per-row normalizer.  The serving
        engine sizes K and N to its model's width, so the ring has the
        model's K steps to hide.
    interval : steps between re-measurements.
    reps : timed calls per class (the device time is their median round;
        on the host, the median call).
    workloads : optional ``{class_name: zero-arg callable}`` timed in place
        of the probe GEMM (still under the class's context, on the host
        clock, still normalized by ``probe_shape[0]`` rows).
    always : measure even while observability is disabled.
    device : where the default workload's operands live (the engine's
        device); default the card when one is present.
    """

    def __init__(
        self,
        asym,
        *,
        probe_shape: tuple[int, int, int] = (128, 128, 128),
        interval: int = 64,
        reps: int = 2,
        workloads: Optional[dict[str, Callable[[], object]]] = None,
        always: bool = False,
        device=None,
    ):
        import torch

        self.asym = asym
        self.probe_shape = tuple(probe_shape)
        self.interval = max(1, int(interval))
        self.reps = max(1, int(reps))
        self.workloads = dict(workloads) if workloads else None
        self.always = bool(always)
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)
        self._pod_class = asym.pod_class_indices()
        self._row_seconds: Optional[list[float]] = None  # per class index
        self.last_measured: dict[str, float] = {}
        self.refreshes = 0
        self._operands = None

    def active(self) -> bool:
        return self.always or T.enabled()

    def _default_workload(self) -> Callable[[], object]:
        import torch

        from repro_torch.kernels import ops

        if self._operands is None:
            m, k, n = self.probe_shape
            gen = torch.Generator(device=self.device).manual_seed(0)
            a = torch.randn((m, k), generator=gen, device=self.device).to(torch.bfloat16)
            b = (torch.randn((k, n), generator=gen, device=self.device) / k ** 0.5).to(torch.bfloat16)
            self._operands = (a, b)
        a, b = self._operands
        return lambda: ops.gemm(a, b)

    def _seconds(self, work: Callable[[], object], on_card: bool) -> float:
        if on_card:
            from repro_torch.tuning.measure import device_seconds

            return device_seconds([work] * self.reps)
        work()  # warm-up: first-call cost is not step cost
        times = []
        for _ in range(self.reps):
            t0 = time.perf_counter()
            work()
            times.append(time.perf_counter() - t0)
        times.sort()
        return times[len(times) // 2]

    def refresh(self) -> list[float]:
        """Re-measure every class's per-row cost; returns the new table."""

        with T.span("probe.refresh", cat="probe", shape=list(self.probe_shape)):
            rows = max(1, self.probe_shape[0])
            out = []
            for c in self.asym.classes:
                custom = self.workloads.get(c.name) if self.workloads else None
                with self.asym.execution_context(c.name, shape=self.probe_shape):
                    sec = self._seconds(
                        custom or self._default_workload(),
                        on_card=custom is None and self.device.type == "cuda",
                    )
                out.append(sec / rows)
                self.last_measured[c.name] = sec
                _ROW_SECONDS.labels(device_class=c.name).set(sec / rows)
        self._row_seconds = out
        self.refreshes += 1
        _REFRESHES.inc()
        T.instant(
            "probe.measured", cat="probe",
            row_seconds={c.name: out[i] for i, c in enumerate(self.asym.classes)},
        )
        return out

    def __call__(
        self, step: int, pod_units: Optional[Sequence[int]] = None
    ) -> Optional[list[float]]:
        """Per-pod seconds for this step, or ``None`` while inactive.

        ``pod_units`` is the per-pod active unit count the engine ran
        (rows / slots); omitted, each pod is charged one unit.
        """

        if not self.active():
            return None
        if self._row_seconds is None or step % self.interval == 0:
            self.refresh()
        if pod_units is None:
            pod_units = [1] * len(self._pod_class)
        return [
            float(u) * self._row_seconds[self._pod_class[pod]]
            for pod, u in enumerate(pod_units)
        ]


__all__ = ["StepTimeProbe"]
