"""Deterministic fault injection for the serving fleet.

The fleet's fault tolerance is tested, not hoped for: a :class:`FaultPlan`
schedules named faults at exact fleet ticks, so every failure scenario is
a seed away and every test is reproducible bit-for-bit.  Fault *points*
are a closed vocabulary (:data:`FAULT_POINTS`) guarded by the static
verifier (RPR006, the RPR005 backend-drift pattern) — a typo'd point name
in a test or the fleet loop is a lint error, not a silently-never-firing
fault.

Off is free, mirroring ``observability.trace``'s contract: with no plan
armed, the hot path is one module-global ``None`` check
(:func:`fault_active`).  Injection never touches jitted token
computation — every fault is a *control-flow* perturbation (skip a tick,
kill an engine, suppress admission, inflate an observed time), which is
what lets the fleet keep its exactness contract: greedy decode is a
deterministic function of the prompt, so a retried or migrated request
reproduces the exact tokens a fault-free run would have produced.

Fault semantics (enforced by the fleet loop, documented here because the
vocabulary lives here):

``engine_stall``
    The engine neither admits nor steps for ``duration`` ticks — a hung
    host or a GC pause.  In-flight work freezes and resumes.
``pod_death``
    Permanent engine loss from ``tick`` on — one SPMD step spans all of
    an engine's pods, so losing a pod kills the whole engine's program.
    Queued requests migrate; in-flight requests retry from scratch on
    survivors.
``admission_fail``
    ``admit()`` is suppressed for ``duration`` ticks — an allocator or
    pool failure.  Decode of already-admitted work continues.
``latency_spike``
    The engine runs normally but the per-tick time the fleet scheduler
    observes is multiplied by ``factor`` — thermal throttling as seen by
    the calibration loop; DAS sheds share without any correctness event.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
from typing import Iterable, Iterator, Optional, Sequence

FAULT_POINTS: dict[str, str] = {
    "engine_stall": "engine skips admission and decode for `duration` ticks",
    "pod_death": "permanent engine loss from `tick` on (SPMD program dies)",
    "admission_fail": "admit() suppressed for `duration` ticks",
    "latency_spike": "observed per-tick time multiplied by `factor`",
}


def validate_point(point: str) -> str:
    """Funnel for fault-point names; unknown names raise.

    Every runtime string that selects a fault point should pass through
    here (or appear as a literal the RPR006 lint can check).
    """

    if point not in FAULT_POINTS:
        raise ValueError(
            f"unknown fault point {point!r}; known: {sorted(FAULT_POINTS)}"
        )
    return point


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: ``point`` fires on ``engine`` at fleet ``tick``.

    ``duration`` covers ticks ``[tick, tick+duration)`` for transient
    points; ``pod_death`` is permanent and ignores it.  ``factor`` only
    matters for ``latency_spike``.
    """

    point: str
    engine: int
    tick: int
    duration: int = 1
    factor: float = 8.0

    def __post_init__(self):
        validate_point(self.point)
        if self.engine < 0:
            raise ValueError(f"engine must be >= 0, got {self.engine}")
        if self.tick < 0:
            raise ValueError(f"tick must be >= 0, got {self.tick}")
        if self.duration < 1:
            raise ValueError(f"duration must be >= 1, got {self.duration}")
        if not self.factor > 0:
            raise ValueError(f"factor must be > 0, got {self.factor}")

    def covers(self, tick: int) -> bool:
        if self.point == "pod_death":
            return tick >= self.tick
        return self.tick <= tick < self.tick + self.duration


class FaultPlan:
    """An immutable schedule of :class:`FaultEvent`\\ s.

    Arm with :func:`arm` (or the :func:`injected` context manager); the
    fleet consults :func:`fault_active` each tick.  Plans are data — the
    same plan against the same trace reproduces the same run exactly.
    """

    def __init__(self, events: Iterable[FaultEvent]):
        events = tuple(events)
        for ev in events:
            if not isinstance(ev, FaultEvent):
                raise TypeError(f"expected FaultEvent, got {type(ev).__name__}")
        self.events = tuple(
            sorted(events, key=lambda e: (e.tick, e.engine, e.point))
        )

    @classmethod
    def seeded(
        cls,
        seed: int,
        *,
        n_engines: int,
        horizon: int,
        n_events: int = 4,
        points: Optional[Sequence[str]] = None,
        keep_alive: bool = True,
    ) -> "FaultPlan":
        """A deterministic pseudo-random schedule (property-test fodder).

        ``keep_alive`` designates one engine that never receives a
        ``pod_death`` — the conservation property needs a survivor to
        drain onto.  Same ``seed`` and shape parameters ⇒ same plan.
        """

        if n_engines < 1:
            raise ValueError(f"n_engines must be >= 1, got {n_engines}")
        rng = random.Random(seed)
        pts = tuple(points) if points is not None else tuple(FAULT_POINTS)
        for p in pts:
            validate_point(p)
        survivor = rng.randrange(n_engines)
        events = []
        for _ in range(n_events):
            point = rng.choice(pts)
            engine = rng.randrange(n_engines)
            if point == "pod_death" and keep_alive and engine == survivor:
                if n_engines == 1:
                    continue  # sole engine is the survivor: drop the death
                engine = (engine + 1) % n_engines
            events.append(
                FaultEvent(
                    point=point,
                    engine=engine,
                    tick=rng.randrange(1, max(horizon, 2)),
                    duration=rng.randint(1, 3),
                    factor=float(rng.choice([4.0, 8.0, 16.0])),
                )
            )
        return cls(events)

    def active(self, point: str, engine: int, tick: int) -> Optional[FaultEvent]:
        """The event covering ``(point, engine, tick)``, or ``None``."""

        validate_point(point)
        for ev in self.events:
            if ev.point == point and ev.engine == engine and ev.covers(tick):
                return ev
        return None

    def __repr__(self):
        return f"FaultPlan({list(self.events)!r})"


# One module-global slot, mirroring trace._BUFFER: `_PLAN is None` is the
# entire disabled-path cost at every fault point.
_PLAN: Optional[FaultPlan] = None


def arm(plan: FaultPlan) -> FaultPlan:
    """Install ``plan`` as the active fault schedule."""

    global _PLAN
    if not isinstance(plan, FaultPlan):
        raise TypeError(f"expected FaultPlan, got {type(plan).__name__}")
    _PLAN = plan
    return plan


def disarm() -> Optional[FaultPlan]:
    """Remove the active plan (back to off-is-free); returns it."""

    global _PLAN
    plan, _PLAN = _PLAN, None
    return plan


def armed() -> bool:
    return _PLAN is not None


def fault_active(point: str, *, engine: int, tick: int) -> Optional[FaultEvent]:
    """The hot-path check: the covering event, or ``None``.

    With no plan armed this is a single module-global ``None`` test —
    the off-is-free contract the benchmarks gate.
    """

    plan = _PLAN
    if plan is None:
        return None
    return plan.active(point, engine, tick)


@contextlib.contextmanager
def injected(plan: FaultPlan) -> Iterator[FaultPlan]:
    """Arm ``plan`` for the duration of a ``with`` block, then disarm."""

    arm(plan)
    try:
        yield plan
    finally:
        disarm()


__all__ = [
    "FAULT_POINTS",
    "FaultEvent",
    "FaultPlan",
    "arm",
    "armed",
    "disarm",
    "fault_active",
    "injected",
    "validate_point",
]
