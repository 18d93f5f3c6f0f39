"""Trace spans over a bounded in-memory buffer, Chrome-trace exportable,
and on the clock of a ``torch.profiler`` session.

The span API mirrors :class:`repro_torch.core.execution.ExecutionContext`'s
contextvar discipline: the active-span stack lives in a ``ContextVar``
holding an immutable tuple, so concurrent threads (each thread starts
from the default empty stack) and interleaved asyncio tasks (each task
runs in a copied context) nest and restore independently, and ``with``
semantics make exit exception-safe (a failing span is recorded with its
error class rather than leaked).

Every event has an integer ``id``; ``parent`` is the enclosing span's id
and ``parent_name`` its name.  A span keeps its host seconds (``dur``,
also ``host_s``) and, where CUDA is initialised, its ``device_s``: the
time between two timing events recorded on the current stream at entry
and at exit, the span's hold on that stream (device idle inside it
included).  ``device_s`` is resolved only once the stream has passed the
exit event (``TraceEvent.resolve``, which queries and never waits); on
the CPU it stays None.

Spans are live while :func:`enable` holds a buffer, and while a
``torch.profiler`` session records.  Under a session each span also opens
a function-scope profiler range (``_RecordFunctionFast``, a CPU event
that is not a user annotation, so the profiler mirrors no device event
for it) for the length of its body: the span's interval lands in the
session's trace beside the kernels, on their clock.  Those spans go to a
per-session list, read after the session by :func:`profiled_spans`; a
session's list starts with its first span after the profiler was last
seen off (by a span or by :func:`profiled_spans`).  A session does not
turn tracing on: once it stops, spans are no-ops again unless
:func:`enable` was called.

Recording is cheap and lock-bounded: events append to a fixed-capacity
deque (oldest events drop, counted in ``dropped``) and nothing here
imports jax or numpy — the disabled fast path is a module-global
``None`` check and one profiler-flag check, which is what lets hot loops
call :func:`span` unconditionally.  Tags are shapes and names: reading a
device value into one would synchronise the host.

Two export formats:

  * :meth:`TraceBuffer.save` — the native ``{"version", "events"}`` JSON
    the ``python -m repro_torch.observability.report`` CLI summarizes,
  * :meth:`TraceBuffer.chrome_trace` — the Chrome ``traceEvents`` JSON
    (load in ``chrome://tracing`` or Perfetto); complete spans nest by
    time containment per thread, instants render as marks, counters as
    tracks; a span's args carry ``device_ms`` where it is known.

Span ``args`` carry the scheduling provenance the repo's assertions
already speak: ``device_class``, ``backend``, ``block_source``.
"""

from __future__ import annotations

import collections
import contextvars
import dataclasses
import itertools
import os
import threading
import time
from typing import Any, Optional

import torch

from repro_torch.util.atomic import atomic_write_json

DEFAULT_CAPACITY = 65536

_profiling = getattr(torch._C._autograd, "_profiler_enabled", None) or (lambda: False)
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None)
_IDS = itertools.count(1)


@dataclasses.dataclass
class TraceEvent:
    """One recorded event; ``ts``/``dur`` are seconds on the buffer's
    ``perf_counter`` clock, relative to the buffer's epoch (a profiled
    span's: to its session's first span).  ``parent`` is the enclosing
    span's ``id``, ``parent_name`` its name; ``device_s`` the span's time
    on its stream, None until resolved and on the CPU."""

    name: str
    cat: str
    ph: str                      # "X" complete | "i" instant | "C" counter
    ts: float
    dur: float
    tid: int
    parent: Optional[int]
    args: dict
    id: int = 0
    parent_name: Optional[str] = None
    device_s: Optional[float] = None

    _marks = None                # (start, end) CUDA events until resolved

    @property
    def host_s(self) -> float:
        return self.dur

    def resolve(self) -> "TraceEvent":
        """Fill ``device_s`` if the stream has passed the exit event
        (a query: never waits)."""

        marks = self._marks
        if marks is not None and marks[1].query():
            self.device_s = marks[0].elapsed_time(marks[1]) / 1e3
            self._marks = None
        return self


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
            out = list(self._events)
        return [ev.resolve() for ev in out]

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
            if ev.parent_name:
                rec["args"]["parent"] = ev.parent_name
            if ev.device_s is not None:
                rec["args"]["device_ms"] = round(ev.device_s * 1e3, 6)
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

# The spans of the newest profiler session: the list, its epoch, and
# whether the session is still the one the list belongs to.
_PROFILED: list = []
_PROFILED_EPOCH = 0.0
_PROFILED_OPEN = False


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


def profiled_spans() -> list[TraceEvent]:
    """The spans recorded while the newest ``torch.profiler`` session ran,
    in the order they ended, each resolved as far as its stream has run
    (synchronise first for every ``device_s``).  Read after the session
    ends; the next session's first span starts a new list."""

    global _PROFILED_OPEN
    if not _profiling():
        _PROFILED_OPEN = False
    return [ev.resolve() for ev in list(_PROFILED)]


def _open_session() -> None:
    """Start the running session's list and epoch on its first span."""

    global _PROFILED, _PROFILED_EPOCH, _PROFILED_OPEN
    if not _PROFILED_OPEN:
        _PROFILED, _PROFILED_EPOCH, _PROFILED_OPEN = [], time.perf_counter(), True


def _device_mark():
    """A timing event recorded on the current stream, where CUDA runs."""

    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


# -- recording ---------------------------------------------------------------


def _parent(stack) -> tuple:
    return (stack[-1].id, stack[-1].name) if stack else (None, None)


def complete(name: str, t0: float, dur: float, *, cat: str = "span", **args) -> None:
    """Record an already-measured interval (``t0`` = ``perf_counter`` at
    start).  The hot-loop API: callers that already time themselves
    (engine step) record post hoc with zero control-flow change; disabled
    cost is this ``None`` check."""

    buf = _BUFFER
    if buf is None:
        return
    parent, parent_name = _parent(_STACK.get())
    buf.add(
        TraceEvent(
            name=name,
            cat=cat,
            ph="X",
            ts=t0 - buf.epoch,
            dur=dur,
            tid=threading.get_ident(),
            parent=parent,
            args=args,
            id=next(_IDS),
            parent_name=parent_name,
        )
    )


def instant(name: str, *, cat: str = "span", **args) -> None:
    """Record a point event (e.g. a rebalance) if tracing is on."""

    buf = _BUFFER
    if buf is None:
        return
    parent, parent_name = _parent(_STACK.get())
    buf.add(
        TraceEvent(
            name=name,
            cat=cat,
            ph="i",
            ts=time.perf_counter() - buf.epoch,
            dur=0.0,
            tid=threading.get_ident(),
            parent=parent,
            args=args,
            id=next(_IDS),
            parent_name=parent_name,
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
            id=next(_IDS),
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

    Entering takes an id, pushes onto the contextvar stack (so children
    see their parent), opens the profiler range while a session records
    and marks the current stream; exiting marks the stream again, closes
    the range, pops, measures the host duration, and records — tagged with
    the exception class if the body raised — to the buffer and, when the
    profiler recorded it, to the session's list.  A span object is
    single-use.
    """

    __slots__ = ("name", "cat", "args", "id", "_t0", "_parent", "_profiled", "_range", "_mark")

    def __init__(self, name: str, cat: str, args: dict):
        self.name = name
        self.cat = cat
        self.args = args
        self.id = next(_IDS)
        self._t0 = 0.0
        self._parent = (None, None)
        self._profiled = False
        self._range = None
        self._mark = None

    def tag(self, **kw) -> "Span":
        """Attach tags after creation (e.g. results known mid-span)."""

        self.args.update(kw)
        return self

    def __enter__(self) -> "Span":
        global _PROFILED_OPEN
        stack = _STACK.get()
        self._parent = _parent(stack)
        _STACK.set(stack + (self,))
        self._profiled = _profiling()
        if self._profiled:
            _open_session()
            if _RANGE is not None:
                self._range = _RANGE(self.name)
                self._range.__enter__()
        else:
            _PROFILED_OPEN = False
        self._mark = _device_mark()
        self._t0 = time.perf_counter()
        return self

    def _event(self, epoch: float, dur: float, args: dict, marks) -> TraceEvent:
        ev = TraceEvent(
            name=self.name,
            cat=self.cat,
            ph="X",
            ts=self._t0 - epoch,
            dur=dur,
            tid=threading.get_ident(),
            parent=self._parent[0],
            args=args,
            id=self.id,
            parent_name=self._parent[1],
        )
        ev._marks = marks
        return ev

    def __exit__(self, exc_type, exc, tb) -> bool:
        end = _device_mark() if self._mark is not None else None
        dur = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(None, None, None)
        stack = _STACK.get()
        if stack and stack[-1] is self:
            _STACK.set(stack[:-1])
        else:  # misnested exit: drop self wherever it sits, keep the rest
            _STACK.set(tuple(s for s in stack if s is not self))
        args = dict(self.args)
        if exc_type is not None:
            args["error"] = exc_type.__name__
        marks = (self._mark, end) if end is not None else None
        buf = _BUFFER
        if buf is not None:
            buf.add(self._event(buf.epoch, dur, args, marks))
        if self._profiled:
            _PROFILED.append(self._event(_PROFILED_EPOCH, dur, dict(args), marks))
        return False


def live() -> bool:
    """Does a span record now (tracing on, or a profiler session)?  The
    two flag checks of :func:`span`, for callers whose tags or brackets
    cost something to make."""

    return _BUFFER is not None or _profiling()


def span(name: str, *, cat: str = "span", **args):
    """A context manager timing its body (no-op while tracing is off and
    no profiler session records)."""

    if _BUFFER is None and not _profiling():
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
    "live",
    "get_buffer",
    "profiled_spans",
    "span",
    "complete",
    "instant",
    "counter",
    "current_span",
]
