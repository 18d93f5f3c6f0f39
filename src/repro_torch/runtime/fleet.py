"""Fault-tolerant multi-engine fleet: the paper's scheduling story, one
level up.

A :class:`Fleet` fronts N :class:`~repro.runtime.serving.ServingEngine`\\ s
(possibly with *different* class mixes) behind one submit/stream API.
Engines play the role the paper gives cores: each engine's calibrated
tokens-per-second (:meth:`ServingEngine.calibrated_tps`) is its
``rel_throughput``, and the very same :class:`DynamicScheduler`
EMA/drift/hysteresis machinery (via :func:`~repro.core.schedule.fleet_scheduler`)
balances *requests* over engines the way it balances rows over pods —
routing by the shared largest-remainder
:func:`~repro.core.schedule.deficit_route`, re-deriving shares only past
the drift threshold, shedding load from an engine whose observed
per-tick times inflate (a fleet-level straggler).

Fault tolerance is by construction, not by after-the-fact recovery
heuristics:

* **Deterministic fault injection** — ``runtime.faults`` schedules named
  faults (engine stall, pod death, admission failure, latency spike) at
  exact ticks; the fleet consults :func:`faults.fault_active` at each
  fault point.  No plan armed ⇒ one module-global ``None`` check.
* **Health checks with hysteresis** — ``unhealthy_after`` consecutive
  bad ticks (stall / admission failure symptoms) route new work away
  and drain an engine's queue; ``healthy_after`` consecutive good ticks
  restore it.  The double threshold is the scheduler's rebalance
  hysteresis applied to liveness: a single hiccup must not thrash
  placement.
* **Queued-request migration** — *not-yet-admitted* requests move away
  from dead, unhealthy, parked, or saturated engines
  (:meth:`ServingEngine.withdraw` / :meth:`~ServingEngine.export_queued`
  roll back the engine router's counts).  Admitted work never migrates:
  a decode slot's tokens are already flowing, and exactness comes from
  letting them finish or retrying from scratch.
* **Deadlines with retry-and-backoff** — a request queued past its
  deadline migrates; a request in flight on a dying engine is
  re-submitted after an exponential backoff (``retry_backoff · 2^(k-1)``
  ticks).
* **Fleet-level parking** — under ``objective="energy"|"edp"`` the
  fleet drains and gates whole *engines* the load does not need,
  reusing PR 9's pod-parking protocol one level up: park the least
  energy-efficient engine while offered load fits the remaining
  capacity with hysteresis margin (``n_work ≤ remaining·(1−h)``,
  ``h`` = the scheduler's ``rebalance_threshold``), re-admit most
  efficient first, never park the most efficient or last engine.
  Parking only blocks new routing — in-flight work drains naturally.

**Exactness contract** (tested): every submitted request completes
*exactly once*, with tokens bit-identical to a fault-free single-engine
run — regardless of which engine served it, whether it was migrated
while queued, or whether it was retried after an engine death.  This
holds because greedy decode is a deterministic function of the prompt
(for row-local archs — the fleet does not change jitted programs), and
because faults only ever perturb *control flow*: which engine runs,
when it admits, what the scheduler observes.

The tick loop is cooperative and deterministic: :meth:`tick` runs one
scheduling round (faults → admit → step → observe → harvest → deadlines
→ retries → parking → migration) over every live engine.  ``async``
surfaces (:meth:`submit_async`, :meth:`stream`, :meth:`run_async`) wrap
the same loop for streaming clients.
"""

from __future__ import annotations

import asyncio
import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.schedule import deficit_route, fleet_scheduler
from repro_torch.observability import metrics as MET
from repro_torch.observability import trace as T
from repro_torch.runtime import faults
from repro_torch.runtime.serving import Request, ServingEngine

_M = None


def _metrics():
    """Fleet metric families, registered once on first enabled use."""

    global _M
    if _M is None:
        _M = {
            "engines_alive": MET.gauge(
                "fleet_engines_alive",
                "Engines alive (not killed), including parked ones"),
            "engines_parked": MET.gauge(
                "fleet_engines_parked",
                "Engines drained and gated by the energy objective"),
            "queue_depth": MET.gauge(
                "fleet_queue_depth", "Queued requests per engine",
                labels=("engine",)),
            "inflight": MET.gauge(
                "fleet_inflight", "Admitted in-flight requests per engine",
                labels=("engine",)),
            "migrations": MET.counter(
                "fleet_migrations_total",
                "Queued requests migrated between engines"),
            "retries": MET.counter(
                "fleet_retries_total",
                "Requests re-submitted after an engine failure"),
            "completions": MET.counter(
                "fleet_completions_total", "Requests completed by the fleet"),
        }
    return _M


@dataclasses.dataclass
class FleetStats:
    """Fleet-level counters; conservation must reconcile: ``submitted ==
    completed`` after a drained run, ``duplicate_completions == 0``
    always, and the migration/retry counters match their trace
    instants."""

    submitted: int = 0
    completed: int = 0
    duplicate_completions: int = 0   # structurally impossible; asserted 0
    migrated: int = 0                # queued-request moves between engines
    retries: int = 0                 # in-flight work re-submitted after a death
    deadline_requeues: int = 0       # migrations triggered by a deadline
    engine_kills: int = 0
    stalled_ticks: int = 0
    admission_faults: int = 0
    latency_spikes: int = 0
    engine_parks: int = 0
    engine_unparks: int = 0
    health_trips: int = 0            # healthy -> unhealthy transitions
    health_recoveries: int = 0
    ticks: int = 0

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class FleetCompletion:
    """A finished fleet request, with its placement history."""

    rid: int                  # fleet-level rid (submission order)
    tokens: np.ndarray        # (P + n_generated,) int32
    prompt_len: int
    engine: int               # engine that completed it
    stop: str                 # "budget" | "eos"
    attempts: int = 1         # placements that reached an engine (1 = no retry)
    migrations: int = 0       # queued-request moves before admission


@dataclasses.dataclass
class _Pending:
    """Fleet-side bookkeeping for one not-yet-completed request."""

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    deadline: Optional[int]   # absolute fleet tick, or None
    engine: int = -1          # current placement (-1 = unplaced)
    erid: int = -1            # rid on that engine
    attempts: int = 0
    migrations: int = 0
    retry_at: int = 0         # earliest tick for re-placement (backoff)


class Fleet:
    """N serving engines behind one submit/stream API.

    Parameters
    ----------
    engines : the serving engines (heterogeneous class mixes welcome).
    rel_throughput : per-engine calibrated tokens/s; defaults to each
        engine's :meth:`~ServingEngine.calibrated_tps`.
    powers : per-engine modeled active watts (for the energy/edp routing
        discount and parking order); defaults to the sum of each
        engine's per-pod active watts.
    objective : "perf" | "energy" | "edp" — non-perf objectives discount
        inefficient engines' routing shares and enable engine parking.
    ema, rebalance_threshold : forwarded to the fleet scheduler
        (hysteresis governs both share re-derivation and parking).
    unhealthy_after, healthy_after : health hysteresis in ticks.
    retry_backoff : base backoff (ticks) before retrying a request lost
        to an engine death; doubles per attempt.
    max_attempts : hard cap on placements per request (a request that
        cannot complete in this many placements raises — conservation
        failures must be loud).
    """

    def __init__(
        self,
        engines: Sequence[ServingEngine],
        *,
        rel_throughput: Optional[Sequence[float]] = None,
        powers: Optional[Sequence[float]] = None,
        objective: str = "perf",
        ema: float = 0.5,
        rebalance_threshold: float = 0.05,
        unhealthy_after: int = 2,
        healthy_after: int = 2,
        retry_backoff: int = 1,
        max_attempts: int = 8,
    ):
        engines = list(engines)
        if not engines:
            raise ValueError("need at least one engine")
        self.engines = engines
        self.n_engines = len(engines)
        if rel_throughput is None:
            rel_throughput = [e.calibrated_tps() for e in engines]
        self.rel_throughput = [float(r) for r in rel_throughput]
        if powers is None:
            powers = [float(sum(e.asym.pod_active_watts())) for e in engines]
        self.powers = [float(p) for p in powers]
        self.objective = objective
        self.scheduler = fleet_scheduler(
            self.rel_throughput,
            ema=ema,
            rebalance_threshold=rebalance_threshold,
            objective=objective,
            powers=self.powers,
        )
        self.unhealthy_after = int(unhealthy_after)
        self.healthy_after = int(healthy_after)
        self.retry_backoff = max(0, int(retry_backoff))
        self.max_attempts = int(max_attempts)

        self._routed = [0] * self.n_engines   # requests currently assigned
        self._alive = [True] * self.n_engines
        self._unhealthy = [False] * self.n_engines
        self._bad = [0] * self.n_engines      # consecutive bad ticks
        self._good = [0] * self.n_engines     # consecutive good ticks
        self._parked: set[int] = set()
        # frid bookkeeping: at most one live placement per fleet rid.
        self._pending: dict[int, _Pending] = {}
        self._rid_map: list[dict[int, int]] = [dict() for _ in engines]
        self._harvested = [len(e.completions) for e in engines]
        self._completed_rids: set[int] = set()
        self._done_events: dict[int, asyncio.Event] = {}
        self._next_rid = 0
        self._tick = 0
        self.completions: list[FleetCompletion] = []
        self.stats = FleetStats()

    # -- submission ----------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *, deadline: Optional[int] = None) -> int:
        """Queue one request fleet-wide; returns its fleet rid.

        ``deadline`` (ticks from now) bounds *queueing*: a request still
        unadmitted past it migrates to another engine.  Admitted work is
        never preempted — exactness over latency.
        """

        prompt = np.asarray(prompt, np.int32).reshape(-1)
        rid = self._next_rid
        self._next_rid += 1
        p = _Pending(
            rid=rid,
            prompt=prompt,
            max_new_tokens=int(max_new_tokens),
            deadline=None if deadline is None else self._tick + int(deadline),
        )
        self._pending[rid] = p
        self.stats.submitted += 1
        self._place(p)
        return rid

    def _candidates(self, exclude: frozenset = frozenset()) -> list[int]:
        """Routable engines, in degradation order: prefer healthy live
        unparked engines, fall back to parked/unhealthy ones (graceful
        degradation beats rejecting work), never a dead engine."""

        def pick(pred):
            return [
                i for i in range(self.n_engines)
                if self._alive[i] and i not in exclude and pred(i)
            ]

        cands = pick(lambda i: i not in self._parked and not self._unhealthy[i])
        if not cands:
            cands = pick(lambda i: not self._unhealthy[i])
        if not cands:
            cands = pick(lambda i: True)
        return cands

    def _routing_weights(self, cands: list[int]) -> list[float]:
        """Per-candidate shares from the scheduler's hysteresis-cached
        chunk table (re-derived only past the drift threshold — jitter in
        observed rates does not thrash routing), falling back to raw
        rates when the table gives every candidate a zero share."""

        resolution = max(sum(e.n_slots for e in self.engines), self.n_engines)
        sizes = self.scheduler.table(resolution).sizes()
        w = [float(sizes[i]) for i in cands]
        if sum(w) <= 0:
            w = [float(self.scheduler.rates[i]) for i in cands]
        return w

    def _place(self, p: _Pending, *, exclude: frozenset = frozenset()) -> int:
        """Route ``p`` onto an engine; returns the engine index."""

        cands = self._candidates(exclude)
        if not cands:
            raise RuntimeError("no live engine to route to")
        if p.attempts >= self.max_attempts:
            raise RuntimeError(
                f"request {p.rid} exceeded max_attempts={self.max_attempts}"
            )
        routed = [self._routed[i] for i in cands]
        e = cands[deficit_route(self._routing_weights(cands), routed)]
        erid = self.engines[e].submit(p.prompt, p.max_new_tokens)
        self._rid_map[e][erid] = p.rid
        self._routed[e] += 1
        p.engine, p.erid = e, erid
        p.attempts += 1
        return e

    def _can_migrate(self, p: _Pending) -> bool:
        """Optional migrations (deadline, park drain, saturation) skip
        rather than burn the last placement attempts — a request that has
        moved a lot stays queued where it is and completes there; only a
        *mandatory* re-place (engine death) may exhaust the cap and
        raise."""

        return p.attempts < self.max_attempts - 1

    def _withdraw(self, p: _Pending) -> Optional[Request]:
        """Pull ``p`` back out of its engine's queue (None if admitted)."""

        if p.engine < 0:
            return None
        req = self.engines[p.engine].withdraw(p.erid)
        if req is not None:
            self._rid_map[p.engine].pop(p.erid, None)
            self._routed[p.engine] -= 1
            p.engine, p.erid = -1, -1
        return req

    def _migrate(self, p: _Pending, src: int, reason: str) -> None:
        p.migrations += 1
        self.stats.migrated += 1
        dst = self._place(p, exclude=frozenset({src}))
        if T.enabled():
            _metrics()["migrations"].inc()
            T.instant(
                "fleet.migrate", cat="fleet",
                rid=p.rid, src=src, dst=dst, reason=reason,
            )

    # -- the tick loop -------------------------------------------------------

    def tick(self) -> int:
        """One cooperative scheduling round; returns tokens decoded.

        Order matters and is deterministic: faults gate each engine's
        admit/step, the scheduler observes the tick's per-engine
        progress on the modeled clock, completions are harvested
        (exactly-once bookkeeping), then the control actions — deadline
        requeues, backoff retries, parking, saturation migration — run
        on the post-step state.
        """

        self._tick += 1
        self.stats.ticks += 1
        t = self._tick
        produced = 0
        units = [0] * self.n_engines
        times = [0.0] * self.n_engines
        for e, eng in enumerate(self.engines):
            if not self._alive[e]:
                continue
            if faults.fault_active("pod_death", engine=e, tick=t) is not None:
                self._kill_engine(e)
                continue
            if faults.fault_active("engine_stall", engine=e, tick=t) is not None:
                self.stats.stalled_ticks += 1
                self._note_health(e, bad=True)
                continue
            blocked = faults.fault_active("admission_fail", engine=e, tick=t)
            if blocked is not None:
                self.stats.admission_faults += 1
            elif any(eng.queues):
                eng.admit()
            tok0, m0 = eng.stats.tokens, eng.stats.modeled_decode_s
            if (eng.slot_rid >= 0).any():
                produced += eng.step()
            units[e] = eng.stats.tokens - tok0
            dt = eng.stats.modeled_decode_s - m0
            spike = faults.fault_active("latency_spike", engine=e, tick=t)
            if spike is not None:
                # The engine ran fine; what degrades is the *observed*
                # time — DAS sheds share exactly as it would for a
                # thermally throttled core.  No correctness event.
                dt *= spike.factor
                self.stats.latency_spikes += 1
            times[e] = dt
            self._note_health(e, bad=blocked is not None)
        if any(u > 0 for u in units):
            # Engines-as-classes calibration on the modeled clock:
            # observe() skips zero-unit entries, EMAs the rest.
            self.scheduler.observe(units, times)
        self._harvest()
        self._check_deadlines()
        self._retry_due()
        self._update_parking()
        self._migrate_from_saturated()
        if T.enabled():
            self._record_tick_telemetry()
        return produced

    def _note_health(self, e: int, *, bad: bool) -> None:
        if bad:
            self._bad[e] += 1
            self._good[e] = 0
            if (
                not self._unhealthy[e]
                and self._bad[e] >= self.unhealthy_after
            ):
                self._unhealthy[e] = True
                self.stats.health_trips += 1
                if T.enabled():
                    T.instant(
                        "fleet.engine_unhealthy", cat="fleet",
                        engine=e, bad_ticks=self._bad[e],
                    )
        else:
            self._good[e] += 1
            self._bad[e] = 0
            if self._unhealthy[e] and self._good[e] >= self.healthy_after:
                self._unhealthy[e] = False
                self.stats.health_recoveries += 1
                if T.enabled():
                    T.instant(
                        "fleet.engine_recovered", cat="fleet",
                        engine=e, good_ticks=self._good[e],
                    )

    def _kill_engine(self, e: int) -> None:
        """Permanent engine loss: migrate its queue, retry its in-flight.

        One SPMD step spans all of an engine's pods, so a pod death
        takes the engine's whole program — there is no partial
        survival.  Queued requests (never admitted) migrate losslessly;
        in-flight requests lost mid-decode retry *from scratch* after a
        backoff — greedy decode is deterministic in the prompt, so the
        retry reproduces the exact tokens the lost decode would have.
        """

        self._alive[e] = False
        self._parked.discard(e)
        self._unhealthy[e] = False
        self.stats.engine_kills += 1
        eng = self.engines[e]
        migrated = retried = 0
        for req in eng.export_queued():
            rid = self._rid_map[e].pop(req.rid, None)
            if rid is None:
                continue
            p = self._pending[rid]
            self._routed[e] -= 1
            p.engine, p.erid = -1, -1
            self._migrate(p, e, reason="engine_kill")
            migrated += 1
        for erid, rid in list(self._rid_map[e].items()):
            del self._rid_map[e][erid]
            p = self._pending[rid]
            self._routed[e] -= 1
            p.engine, p.erid = -1, -1
            p.retry_at = self._tick + self.retry_backoff * (
                2 ** max(0, p.attempts - 1)
            )
            retried += 1
        if T.enabled():
            _metrics()["engines_alive"].set(sum(self._alive))
            T.instant(
                "fleet.engine_kill", cat="fleet",
                engine=e, migrated=migrated, retrying=retried,
            )

    def _harvest(self) -> None:
        """Collect engine completions into fleet completions exactly once."""

        for e, eng in enumerate(self.engines):
            if self._harvested[e] == len(eng.completions):
                continue
            new = eng.completions[self._harvested[e]:]
            self._harvested[e] = len(eng.completions)
            for c in new:
                rid = self._rid_map[e].pop(c.rid, None)
                if rid is None or rid in self._completed_rids:
                    # Structurally unreachable (a rid has one live
                    # placement); counted so conservation tests can
                    # assert it stayed that way.
                    self.stats.duplicate_completions += 1
                    continue
                self._completed_rids.add(rid)
                p = self._pending.pop(rid)
                self._routed[e] -= 1
                self.completions.append(
                    FleetCompletion(
                        rid=rid,
                        tokens=c.tokens,
                        prompt_len=c.prompt_len,
                        engine=e,
                        stop=c.stop,
                        attempts=p.attempts,
                        migrations=p.migrations,
                    )
                )
                self.stats.completed += 1
                if T.enabled():
                    _metrics()["completions"].inc()
                ev = self._done_events.get(rid)
                if ev is not None:
                    ev.set()

    def _check_deadlines(self) -> None:
        """A request queued past its deadline migrates (admitted work is
        never preempted — the deadline bounds queueing, not decode)."""

        for p in list(self._pending.values()):
            if p.deadline is None or self._tick <= p.deadline or p.engine < 0:
                continue
            src = p.engine
            if not self._can_migrate(p):
                continue
            if len(self._candidates(frozenset({src}))) == 0:
                continue  # nowhere better to go
            if self._withdraw(p) is not None:
                self.stats.deadline_requeues += 1
                p.deadline = None  # one requeue per request; no thrash
                self._migrate(p, src, reason="deadline")

    def _retry_due(self) -> None:
        """Re-place requests lost to an engine death, past their backoff."""

        for p in list(self._pending.values()):
            if p.engine >= 0 or self._tick < p.retry_at:
                continue
            self.stats.retries += 1
            e = self._place(p)
            if T.enabled():
                _metrics()["retries"].inc()
                T.instant(
                    "fleet.retry", cat="fleet",
                    rid=p.rid, dst=e, attempt=p.attempts,
                )

    # -- fleet-level parking (PR 9's pod protocol, one level up) -------------

    def _capacity(self, engines: Sequence[int]) -> int:
        return sum(self.engines[i].n_slots for i in engines)

    def _offered_load(self) -> int:
        n = sum(
            1 for p in self._pending.values() if p.engine < 0
        )  # unplaced retries still need a seat
        for e, eng in enumerate(self.engines):
            if self._alive[e]:
                n += sum(len(q) for q in eng.queues)
                n += int((eng.slot_rid >= 0).sum())
        return n

    def _engines_by_efficiency(self) -> list[int]:
        """Alive engines, most energy-efficient first (modeled active
        watts per unit of calibrated throughput, ascending)."""

        alive = [i for i in range(self.n_engines) if self._alive[i]]
        return sorted(
            alive,
            key=lambda i: (self.powers[i] / max(self.scheduler.rates[i], 1e-12), i),
        )

    def _update_parking(self) -> None:
        if self.objective == "perf" or self.n_engines < 2:
            return
        h = self.scheduler.rebalance_threshold
        n_work = self._offered_load()
        order = self._engines_by_efficiency()
        if not order:
            return
        unparked = [i for i in order if i not in self._parked]
        # Re-admit most efficient first while capacity is short.
        for i in order:
            if self._capacity(unparked) >= n_work:
                break
            if i in self._parked:
                self._unpark(i)
                unparked = [j for j in order if j not in self._parked]
        # Park least efficient while the rest holds the load with margin.
        for i in reversed(order):
            if i in self._parked or len(unparked) <= 1 or i == order[0]:
                continue
            remaining = [j for j in unparked if j != i]
            if n_work <= self._capacity(remaining) * (1.0 - h):
                self._park(i)
                unparked = remaining
            else:
                break

    def _park(self, e: int) -> None:
        """Drain and gate one engine: queued requests migrate, routing
        excludes it, in-flight work finishes (parking never preempts)."""

        self._parked.add(e)
        self.stats.engine_parks += 1
        drained = 0
        for req in self.engines[e].export_queued():
            rid = self._rid_map[e].pop(req.rid, None)
            if rid is None:
                continue
            p = self._pending[rid]
            self._routed[e] -= 1
            p.engine, p.erid = -1, -1
            if self._can_migrate(p):
                self._migrate(p, e, reason="engine_park")
                drained += 1
            else:
                # Hand it back under a fresh engine rid: a parked engine
                # still admits what it kept (parking blocks routing, not
                # progress).
                erid = self.engines[e].submit(p.prompt, p.max_new_tokens)
                self._rid_map[e][erid] = rid
                self._routed[e] += 1
                p.engine, p.erid = e, erid
        if T.enabled():
            _metrics()["engines_parked"].set(len(self._parked))
            T.instant(
                "fleet.engine_park", cat="fleet", engine=e, drained=drained,
            )

    def _unpark(self, e: int) -> None:
        self._parked.discard(e)
        self.stats.engine_unparks += 1
        if T.enabled():
            _metrics()["engines_parked"].set(len(self._parked))
            T.instant("fleet.engine_unpark", cat="fleet", engine=e)

    # -- queued-request migration off saturated engines ----------------------

    def _migrate_from_saturated(self) -> None:
        """Move queued work from engines with a full slot table to
        engines with free budgeted capacity and an empty queue.

        "Saturated" is deliberately strict — queue behind a *full* slot
        table while another engine idles — so noise never thrashes
        requests back and forth; the deficit router already keeps the
        steady-state split proportional.  Unhealthy engines' queues
        drain wholesale (they are excluded from routing anyway).
        """

        cands = self._candidates()
        for e, eng in enumerate(self.engines):
            if not self._alive[e]:
                continue
            queued = [r for q in eng.queues for r in q]
            if not queued:
                continue
            drain_all = self._unhealthy[e] or e in self._parked
            if not drain_all:
                full = int((eng.slot_rid >= 0).sum()) >= eng.n_slots
                idle_room = sum(
                    max(
                        0,
                        self.engines[i].n_slots
                        - int((self.engines[i].slot_rid >= 0).sum())
                        - sum(len(q) for q in self.engines[i].queues),
                    )
                    for i in cands
                    if i != e
                )
                if not full or idle_room <= 0:
                    continue
                queued = queued[-min(len(queued), idle_room):]  # newest first out
            for req in queued:
                rid = self._rid_map[e].get(req.rid)
                if rid is None:
                    continue
                p = self._pending[rid]
                if not self._can_migrate(p):
                    continue
                if len(self._candidates(frozenset({e}))) == 0:
                    return
                if self._withdraw(p) is not None:
                    self._migrate(p, e, reason="saturation")

    # -- telemetry -----------------------------------------------------------

    def _record_tick_telemetry(self) -> None:
        m = _metrics()
        m["engines_alive"].set(sum(self._alive))
        m["engines_parked"].set(len(self._parked))
        for e, eng in enumerate(self.engines):
            if not self._alive[e]:
                continue
            m["queue_depth"].labels(engine=str(e)).set(
                sum(len(q) for q in eng.queues)
            )
            m["inflight"].labels(engine=str(e)).set(
                int((eng.slot_rid >= 0).sum())
            )

    # -- health surface ------------------------------------------------------

    def health(self) -> dict:
        """Fleet + per-engine health, one poll away."""

        return {
            "tick": self._tick,
            "alive": sum(self._alive),
            "parked": sorted(self._parked),
            "unhealthy": [
                i for i in range(self.n_engines) if self._unhealthy[i]
            ],
            "pending": len(self._pending),
            "engines": [
                self.engines[i].health() if self._alive[i] else {"dead": True}
                for i in range(self.n_engines)
            ],
        }

    # -- drive to completion -------------------------------------------------

    def run(self, *, max_ticks: Optional[int] = None) -> list[FleetCompletion]:
        """Tick until every pending request completes (exactly once).

        Returns the completions this call produced; cumulative history
        stays on :attr:`completions`.  Raises if every engine is dead
        with work pending, or if the fleet stops making progress —
        conservation failures must be loud, never silent drops.
        """

        start = len(self.completions)
        idle = 0
        while self._pending:
            if not any(self._alive):
                raise RuntimeError("all engines dead with requests pending")
            before = self.stats.completed
            self.tick()
            idle = 0 if self.stats.completed > before else idle + 1
            if idle > 10_000:
                raise RuntimeError(
                    "fleet made no progress for 10000 ticks "
                    f"({len(self._pending)} requests pending)"
                )
            if max_ticks is not None and self.stats.ticks >= max_ticks:
                break
        return self.completions[start:]

    def generate(self, prompts: np.ndarray, gen_len: int) -> np.ndarray:
        """Batch convenience mirroring :meth:`ServingEngine.generate`:
        returns ``(B, P + gen_len)`` tokens in submission order (rows
        stopped early by ``eos_id`` zero-padded)."""

        prompts = np.asarray(prompts, np.int32)
        rids = [self.submit(p, gen_len) for p in prompts]
        self.run()
        by_rid = {c.rid: c for c in self.completions}
        out = np.zeros((len(rids), prompts.shape[1] + gen_len), np.int32)
        for i, rid in enumerate(rids):
            toks = by_rid[rid].tokens
            out[i, : len(toks)] = toks
        return out

    # -- async surface -------------------------------------------------------

    async def submit_async(
        self, prompt, max_new_tokens: int, *, deadline: Optional[int] = None
    ) -> int:
        """Async twin of :meth:`submit` (placement is synchronous; the
        await point is for API symmetry with streaming clients)."""

        rid = self.submit(prompt, max_new_tokens, deadline=deadline)
        await asyncio.sleep(0)
        return rid

    async def complete_async(self, rid: int) -> FleetCompletion:
        """Wait for one request's completion (someone must be ticking —
        :meth:`run_async` or a driver loop)."""

        ev = self._done_events.setdefault(rid, asyncio.Event())
        if rid in self._completed_rids:
            ev.set()
        await ev.wait()
        return next(c for c in self.completions if c.rid == rid)

    async def stream(self, rid: int):
        """Async token stream: yields ``np.int32`` chunks of *generated*
        tokens as they appear, across migrations and retries — a retried
        request re-produces the identical prefix, so the stream never
        contradicts itself.  Ends when the request completes."""

        sent = 0
        while True:
            if rid in self._completed_rids:
                c = next(c for c in self.completions if c.rid == rid)
                gen = c.tokens[c.prompt_len:]
                if sent < len(gen):
                    yield gen[sent:]
                return
            p = self._pending.get(rid)
            if p is not None and p.engine >= 0 and self._alive[p.engine]:
                part = self.engines[p.engine].partial_tokens(p.erid)
                if part is not None and len(part) > sent:
                    yield part[sent:]
                    sent = len(part)
            await asyncio.sleep(0)

    async def run_async(
        self, *, max_ticks: Optional[int] = None
    ) -> list[FleetCompletion]:
        """Async twin of :meth:`run`, yielding to streamers between ticks."""

        start = len(self.completions)
        idle = 0
        while self._pending:
            if not any(self._alive):
                raise RuntimeError("all engines dead with requests pending")
            before = self.stats.completed
            self.tick()
            idle = 0 if self.stats.completed > before else idle + 1
            if idle > 10_000:
                raise RuntimeError("fleet made no progress for 10000 ticks")
            if max_ticks is not None and self.stats.ticks >= max_ticks:
                break
            await asyncio.sleep(0)
        return self.completions[start:]


__all__ = ["Fleet", "FleetCompletion", "FleetStats"]
