"""Telemetry for the port: spans, metrics, the step-time probe.

The port's counterpart of ``repro.observability``; ``metrics`` and
``report`` are copies of the reference's modules (only their import lines
differ), ``trace`` keeps the reference's names and records and adds span
ids, device time and the profiler's clock, ``probe`` times each class's
own CUDA kernel on the card.

  * :mod:`repro_torch.observability.trace` — nested spans over a bounded
    event buffer, exported as Chrome-trace/Perfetto JSON; each span's
    device time on its stream; while a ``torch.profiler`` session records,
    a range in its trace and a list read by ``profiled_spans()``.
  * :mod:`repro_torch.observability.metrics` — labeled counters, gauges
    and histograms with Prometheus text exposition and a JSON snapshot.
  * :mod:`repro_torch.observability.probe` — the measured per-pod
    step-time probe, the serving engine's default ``pod_time_hook``.

Everything is off by default and the disabled path is one ``None`` check
per site (a span's, and one profiler-flag check).  Enable with :func:`enable` (or ``repro_torch.launch.serve
--trace/--metrics``) and summarize with ``python -m
repro_torch.observability.report``.
"""

from repro_torch.observability import metrics  # noqa: F401
from repro_torch.observability.metrics import REGISTRY  # noqa: F401
from repro_torch.observability.trace import (  # noqa: F401
    disable,
    enable,
    enabled,
    get_buffer,
)

__all__ = ["enable", "disable", "enabled", "get_buffer", "metrics", "REGISTRY"]
