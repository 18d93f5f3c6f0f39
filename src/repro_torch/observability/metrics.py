"""Labeled counters/gauges/histograms with Prometheus text exposition.

A deliberately small, dependency-free registry (no prometheus_client in
the image, and the scrape side of a fleet only needs the text format):

  * families are registered once by name (re-registration with the same
    kind/labels returns the existing family — instrumented modules can
    declare their metrics idempotently at call sites),
  * ``family.labels(k=v)`` materializes one child per label-value tuple,
  * :meth:`MetricsRegistry.exposition` renders the Prometheus text
    format (``# HELP``/``# TYPE``, escaped label values, histogram
    ``_bucket``/``_sum``/``_count`` with cumulative ``le`` buckets),
  * :meth:`MetricsRegistry.snapshot` returns the same state as a
    JSON-serializable dict keyed by metric name (what ``launch/serve.py
    --metrics`` writes and the CI smoke greps).

Updates are float arithmetic under one registry lock — host-side and
cheap relative to anything this repo times — but instrumentation sites
in hot loops still gate on ``trace.enabled()`` so the observability-off
path stays free.
"""

from __future__ import annotations

import re
import threading
from typing import Optional, Sequence

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Step/candidate wall times land between ~100µs (tiny CPU probe GEMMs)
# and tens of seconds (compiles); the default grid covers that span.
DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _labels_str(names: Sequence[str], values: Sequence[str], extra: str = "") -> str:
    parts = [f'{n}="{_escape_label(str(v))}"' for n, v in zip(names, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up, got {amount}")
        self.value += amount


class _Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.value -= amount


class _Histogram:
    __slots__ = ("uppers", "counts", "sum", "count")

    def __init__(self, buckets: Sequence[float]):
        self.uppers = tuple(sorted(float(b) for b in buckets)) + (float("inf"),)
        self.counts = [0] * len(self.uppers)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.sum += v
        self.count += 1
        for i, ub in enumerate(self.uppers):
            if v <= ub:
                self.counts[i] += 1
                break

    def cumulative(self) -> list[int]:
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out


class MetricFamily:
    """One named metric and its per-label-value children."""

    def __init__(self, registry: "MetricsRegistry", kind: str, name: str,
                 help: str, label_names: tuple[str, ...],
                 buckets: Optional[Sequence[float]] = None):
        self.kind = kind
        self.name = name
        self.help = help
        self.label_names = label_names
        self._buckets = tuple(buckets) if buckets is not None else DEFAULT_BUCKETS
        self._registry = registry
        self._children: dict[tuple, object] = {}

    def _make_child(self):
        if self.kind == "counter":
            return _Counter()
        if self.kind == "gauge":
            return _Gauge()
        return _Histogram(self._buckets)

    def labels(self, **kv):
        if set(kv) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, got {sorted(kv)}"
            )
        key = tuple(str(kv[n]) for n in self.label_names)
        with self._registry._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child()
        return child

    def _default(self):
        if self.label_names:
            raise ValueError(f"{self.name} is labeled; call .labels(...) first")
        return self.labels()

    # Unlabeled convenience: family acts as its own single child.
    def inc(self, amount: float = 1.0):
        self._default().inc(amount)

    def set(self, v: float):
        self._default().set(v)

    def dec(self, amount: float = 1.0):
        self._default().dec(amount)

    def observe(self, v: float):
        self._default().observe(v)

    def samples(self) -> list[tuple[tuple, object]]:
        with self._registry._lock:
            return sorted(self._children.items())


class MetricsRegistry:
    def __init__(self):
        self._families: dict[str, MetricFamily] = {}
        self._lock = threading.Lock()

    def _register(self, kind: str, name: str, help: str,
                  labels: Sequence[str], buckets=None) -> MetricFamily:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        label_names = tuple(labels)
        for ln in label_names:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.label_names != label_names:
                    raise ValueError(
                        f"metric {name!r} already registered as {fam.kind}"
                        f"{fam.label_names}, cannot re-register as {kind}{label_names}"
                    )
                return fam
            fam = MetricFamily(self, kind, name, help, label_names, buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "", labels: Sequence[str] = ()) -> MetricFamily:
        return self._register("counter", name, help, labels)

    def gauge(self, name: str, help: str = "", labels: Sequence[str] = ()) -> MetricFamily:
        return self._register("gauge", name, help, labels)

    def histogram(self, name: str, help: str = "", labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> MetricFamily:
        return self._register("histogram", name, help, labels, buckets)

    def reset(self) -> None:
        """Drop all families (tests)."""

        with self._lock:
            self._families.clear()

    # -- output -----------------------------------------------------------

    def exposition(self) -> str:
        """Prometheus text exposition format (0.0.4)."""

        lines = []
        for name in sorted(self._families):
            fam = self._families[name]
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for key, child in fam.samples():
                if fam.kind == "histogram":
                    cum = child.cumulative()
                    for ub, c in zip(child.uppers, cum):
                        le = f'le="{_fmt(ub)}"'
                        lines.append(
                            f"{name}_bucket"
                            f"{_labels_str(fam.label_names, key, le)} {c}"
                        )
                    ls = _labels_str(fam.label_names, key)
                    lines.append(f"{name}_sum{ls} {_fmt(child.sum)}")
                    lines.append(f"{name}_count{ls} {child.count}")
                else:
                    ls = _labels_str(fam.label_names, key)
                    lines.append(f"{name}{ls} {_fmt(child.value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-serializable state, keyed by metric name."""

        out = {}
        for name in sorted(self._families):
            fam = self._families[name]
            samples = []
            for key, child in fam.samples():
                labels = dict(zip(fam.label_names, key))
                if fam.kind == "histogram":
                    samples.append({
                        "labels": labels,
                        "count": child.count,
                        "sum": child.sum,
                        "buckets": {
                            _fmt(ub): c
                            for ub, c in zip(child.uppers, child.cumulative())
                        },
                    })
                else:
                    samples.append({"labels": labels, "value": child.value})
            out[name] = {"kind": fam.kind, "help": fam.help, "samples": samples}
        return out


# The process-wide registry every instrumented module shares.
REGISTRY = MetricsRegistry()


def counter(name: str, help: str = "", labels: Sequence[str] = ()) -> MetricFamily:
    return REGISTRY.counter(name, help, labels)


def gauge(name: str, help: str = "", labels: Sequence[str] = ()) -> MetricFamily:
    return REGISTRY.gauge(name, help, labels)


def histogram(name: str, help: str = "", labels: Sequence[str] = (),
              buckets: Optional[Sequence[float]] = None) -> MetricFamily:
    return REGISTRY.histogram(name, help, labels, buckets)


__all__ = [
    "DEFAULT_BUCKETS",
    "MetricFamily",
    "MetricsRegistry",
    "REGISTRY",
    "counter",
    "gauge",
    "histogram",
]
