"""Trace spans over a bounded in-memory buffer, Chrome-trace exportable.

The span API mirrors :class:`repro.core.execution.ExecutionContext`'s
contextvar discipline: the active-span stack lives in a ``ContextVar``
holding an immutable tuple, so concurrent threads (each thread starts
from the default empty stack) and interleaved asyncio tasks (each task
runs in a copied context) nest and restore independently, and ``with``
semantics make exit exception-safe (a failing span is recorded with its
error class rather than leaked).

Recording is cheap and lock-bounded: events append to a fixed-capacity
deque (oldest events drop, counted in ``dropped``) and nothing here
imports jax or numpy — the disabled fast path is a single module-global
``None`` check, which is what lets hot loops call :func:`complete`
unconditionally.

Two export formats:

  * :meth:`TraceBuffer.save` — the native ``{"version", "events"}`` JSON
    the ``python -m repro.observability.report`` CLI summarizes,
  * :meth:`TraceBuffer.chrome_trace` — the Chrome ``traceEvents`` JSON
    (load in ``chrome://tracing`` or Perfetto); complete spans nest by
    time containment per thread, instants render as marks, counters as
    tracks.

Span ``args`` carry the scheduling provenance the repo's assertions
already speak: ``device_class``, ``backend``, ``block_source``.
"""

from __future__ import annotations

import collections
import contextvars
import dataclasses
import os
import threading
import time
from typing import Any, Optional

from repro_torch.util.atomic import atomic_write_json

DEFAULT_CAPACITY = 65536


@dataclasses.dataclass
class TraceEvent:
    """One recorded event; ``ts``/``dur`` are seconds on the buffer's
    ``perf_counter`` clock, relative to the buffer's epoch."""

    name: str
    cat: str
    ph: str                      # "X" complete | "i" instant | "C" counter
    ts: float
    dur: float
    tid: int
    parent: Optional[str]
    args: dict


class TraceBuffer:
    """Bounded, thread-safe event sink (oldest events evict, counted)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.epoch = time.perf_counter()
        self.dropped = 0
        self._events: collections.deque = collections.deque(maxlen=self.capacity)
        self._lock = threading.Lock()

    def add(self, ev: TraceEvent) -> None:
        with self._lock:
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._events.append(ev)

    @property
    def events(self) -> list[TraceEvent]:
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        return len(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    # -- export -----------------------------------------------------------

    def to_dict(self) -> dict:
        """Native format: everything the report CLI needs, lossless."""

        return {
            "version": 1,
            "clock": "perf_counter",
            "capacity": self.capacity,
            "dropped": self.dropped,
            "events": [dataclasses.asdict(ev) for ev in self.events],
        }

    def save(self, path: str) -> str:
        # Atomic + durable (shared helper): a crash mid-save — which is
        # exactly when a trace matters most — must never leave a torn
        # file for the post-mortem report to choke on.
        return atomic_write_json(
            path, self.to_dict(), indent=1, sort_keys=True, default=str
        )

    def chrome_trace(self) -> dict:
        """Chrome ``traceEvents`` JSON (times in microseconds)."""

        pid = os.getpid()
        out = []
        for ev in self.events:
            rec: dict[str, Any] = {
                "name": ev.name,
                "cat": ev.cat,
                "ph": ev.ph,
                "ts": round(max(ev.ts, 0.0) * 1e6, 3),
                "pid": pid,
                "tid": ev.tid,
                "args": dict(ev.args),
            }
            if ev.ph == "X":
                rec["dur"] = round(ev.dur * 1e6, 3)
            if ev.ph == "i":
                rec["s"] = "t"  # thread-scoped instant mark
            if ev.parent:
                rec["args"]["parent"] = ev.parent
            out.append(rec)
        return {
            "traceEvents": out,
            "displayTimeUnit": "ms",
            "otherData": {"clock": "perf_counter", "dropped": self.dropped},
        }

    def export_chrome_trace(self, path: str) -> str:
        return atomic_write_json(
            path, self.chrome_trace(), indent=1, sort_keys=False, default=str
        )


# -- module state (the one switch) ------------------------------------------

_BUFFER: Optional[TraceBuffer] = None

# Active-span stack: immutable tuple in a ContextVar, exactly the token
# discipline of ExecutionContext — per-thread defaults and per-task
# context copies give threads and asyncio tasks independent stacks.
_STACK: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "repro_trace_spans", default=()
)


def enable(capacity: int = DEFAULT_CAPACITY) -> TraceBuffer:
    """Turn tracing on (idempotent: an existing buffer is kept)."""

    global _BUFFER
    if _BUFFER is None:
        _BUFFER = TraceBuffer(capacity)
    return _BUFFER


def disable() -> Optional[TraceBuffer]:
    """Turn tracing off; returns the detached buffer (for export)."""

    global _BUFFER
    buf, _BUFFER = _BUFFER, None
    return buf


def enabled() -> bool:
    return _BUFFER is not None


def get_buffer() -> Optional[TraceBuffer]:
    return _BUFFER


# -- recording ---------------------------------------------------------------


def complete(name: str, t0: float, dur: float, *, cat: str = "span", **args) -> None:
    """Record an already-measured interval (``t0`` = ``perf_counter`` at
    start).  The hot-loop API: callers that already time themselves
    (engine step, trainer step) record post hoc with zero control-flow
    change; disabled cost is this ``None`` check."""

    buf = _BUFFER
    if buf is None:
        return
    stack = _STACK.get()
    buf.add(
        TraceEvent(
            name=name,
            cat=cat,
            ph="X",
            ts=t0 - buf.epoch,
            dur=dur,
            tid=threading.get_ident(),
            parent=stack[-1].name if stack else None,
            args=args,
        )
    )


def instant(name: str, *, cat: str = "span", **args) -> None:
    """Record a point event (e.g. a rebalance) if tracing is on."""

    buf = _BUFFER
    if buf is None:
        return
    stack = _STACK.get()
    buf.add(
        TraceEvent(
            name=name,
            cat=cat,
            ph="i",
            ts=time.perf_counter() - buf.epoch,
            dur=0.0,
            tid=threading.get_ident(),
            parent=stack[-1].name if stack else None,
            args=args,
        )
    )


def counter(name: str, *, cat: str = "metric", **values) -> None:
    """Record a Chrome counter-track sample (numeric values only)."""

    buf = _BUFFER
    if buf is None:
        return
    buf.add(
        TraceEvent(
            name=name,
            cat=cat,
            ph="C",
            ts=time.perf_counter() - buf.epoch,
            dur=0.0,
            tid=threading.get_ident(),
            parent=None,
            args=values,
        )
    )


class _NoopSpan:
    """Returned by :func:`span` while tracing is off: zero state, reusable."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def tag(self, **kw):
        return self


_NOOP = _NoopSpan()


class Span:
    """One timed region; create via :func:`span`, use as a context manager.

    Entering pushes onto the contextvar stack (so children see their
    parent); exiting pops, measures the duration, and records — tagged
    with the exception class if the body raised.  A span object is
    single-use.
    """

    __slots__ = ("name", "cat", "args", "_t0")

    def __init__(self, name: str, cat: str, args: dict):
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = 0.0

    def tag(self, **kw) -> "Span":
        """Attach tags after creation (e.g. results known mid-span)."""

        self.args.update(kw)
        return self

    def __enter__(self) -> "Span":
        _STACK.set(_STACK.get() + (self,))
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur = time.perf_counter() - self._t0
        stack = _STACK.get()
        if stack and stack[-1] is self:
            _STACK.set(stack[:-1])
        else:  # misnested exit: drop self wherever it sits, keep the rest
            _STACK.set(tuple(s for s in stack if s is not self))
        buf = _BUFFER
        if buf is not None:
            args = dict(self.args)
            if exc_type is not None:
                args["error"] = exc_type.__name__
            outer = _STACK.get()
            buf.add(
                TraceEvent(
                    name=self.name,
                    cat=self.cat,
                    ph="X",
                    ts=self._t0 - buf.epoch,
                    dur=dur,
                    tid=threading.get_ident(),
                    parent=outer[-1].name if outer else None,
                    args=args,
                )
            )
        return False


def span(name: str, *, cat: str = "span", **args):
    """A context manager timing its body (no-op while tracing is off)."""

    if _BUFFER is None:
        return _NOOP
    return Span(name, cat, args)


def current_span() -> Optional[Span]:
    """The innermost active span of this thread/task, if any."""

    stack = _STACK.get()
    return stack[-1] if stack else None


__all__ = [
    "DEFAULT_CAPACITY",
    "TraceEvent",
    "TraceBuffer",
    "Span",
    "enable",
    "disable",
    "enabled",
    "get_buffer",
    "span",
    "complete",
    "instant",
    "counter",
    "current_span",
]
