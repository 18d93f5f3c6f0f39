"""The arithmetic of the readers that take the program's own spans.

The program records a span for each layer it crosses (``trainer.step``,
``trainer.optimizer``, ``class_sharded.pod``, ``model.prefill``, ...);
while the benchmark's profiler traces the units, those spans go to a list
that ``repro_torch.observability.trace.profiled_spans()`` returns after
the trace.  Each span has an ``id``, its ``parent``'s id, ``host_s`` (its
host seconds) and ``device_s`` (its hold on its CUDA stream, None where
unresolved or on the CPU).

Every function here returns None where it finds nothing to read: the
program has no ``profiled_spans`` (an older program), no span of the
names was recorded, or one of them has no ``device_s``.  A share is
never 0 for want of spans.
"""

from __future__ import annotations


def program_spans():
    """The program's spans of the newest profiler session, or None where
    the program does not record them."""

    try:
        from repro_torch.observability import trace
    except ImportError:
        return None
    read = getattr(trace, "profiled_spans", None)
    return list(read()) if callable(read) else None


def _named(spans, name: str):
    """The spans called ``name``, or None where there are none or one has
    no device time."""

    out = [s for s in spans or () if s.name == name]
    if not out or any(s.device_s is None for s in out):
        return None
    return out


def ratio(spans, num: tuple, den: tuple):
    """``100 · Σ num / Σ den``, each a ``(span name, "host_s" |
    "device_s")``, %."""

    a, b = _named(spans, num[0]), _named(spans, den[0])
    if a is None or b is None:
        return None
    top = sum(getattr(s, num[1]) for s in a)
    bottom = sum(getattr(s, den[1]) for s in b)
    return 100.0 * top / bottom if bottom > 0 else None


def balance(spans, part: str = "class_sharded.pod", whole: str = "trainer.step"):
    """``100 · Σ min / Σ max`` over the ``whole`` spans of the device
    seconds of their ``part`` spans (each grouped under its nearest
    ``whole`` ancestor); wholes with fewer than two parts are left out."""

    parts = _named(spans, part)
    if parts is None:
        return None
    by_id = {s.id: s for s in spans}
    groups = {}
    for s in parts:
        up = by_id.get(s.parent)
        while up is not None and up.name != whole:
            up = by_id.get(up.parent)
        if up is not None:
            groups.setdefault(up.id, []).append(s.device_s)
    groups = [g for g in groups.values() if len(g) > 1]
    low, high = sum(min(g) for g in groups), sum(max(g) for g in groups)
    return 100.0 * low / high if high > 0 else None


def span_mfu(spans, units, peaks, name: str = "model.prefill"):
    """The traced units' model FLOPs over the ``name`` spans' device
    seconds at the bf16 peak, %."""

    got = _named(spans, name)
    flops = sum(u.get("model_flops", 0) for u in units or ())
    if got is None or not flops:
        return None
    seconds = sum(s.device_s for s in got)
    return 100.0 * flops / (seconds * peaks["bf16_flops"]) if seconds > 0 else None


def traced_units(run) -> list:
    return (run.get("trace") or {}).get("units") or []
