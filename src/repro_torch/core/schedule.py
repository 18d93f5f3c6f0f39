"""Iteration-space partitioning and scheduling across asymmetric device classes.

Implements the paper's four scheduling strategies (Sections 4, 5.2, 5.4) as
pure, testable partitioners over a 1-D iteration space:

  * **SSS** — symmetric-static: equal chunks per worker, oblivious to class
    throughput (the architecture-oblivious baseline of Section 4).
  * **SAS** — static-asymmetric: chunks proportional to a per-class
    performance *ratio* knob (Section 5.2; the paper exposes the ratio via
    environment variables — here it is an explicit argument / calibrated
    from measurements).
  * **CA-SAS** — SAS with per-class tile alignment: each class's chunk is
    aligned to *its own* stride (``m_c`` in the paper; the per-class block
    shape or microbatch on TPU) — the "two control trees" of Section 5.3.
  * **DAS / CA-DAS** — dynamic: a discrete-time greedy scheduler where each
    class's leader grabs the next chunk (sized by its own stride) whenever
    the class becomes idle (Section 5.4's critical-section loop).  Under
    XLA's static-shape SPMD an intra-step work queue is not expressible, so
    the production path uses :class:`DynamicScheduler` — a between-steps
    feedback controller that re-derives the SAS table from observed
    per-class throughput (straggler mitigation).  The intra-step queue
    itself is modelled faithfully in :mod:`repro.core.simulator` for
    validation against the paper's figures.

All partitioners guarantee exact coverage (chunks sum to the iteration
count) and respect tile alignment where requested; these invariants are
property-tested in ``tests/test_property.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.observability import trace as _trace


@dataclasses.dataclass(frozen=True)
class Chunk:
    """A half-open range ``[start, start + size)`` assigned to a class."""

    cls: int
    start: int
    size: int

    @property
    def stop(self) -> int:
        return self.start + self.size


@dataclasses.dataclass(frozen=True)
class ChunkTable:
    """A full static partition of ``[0, n_units)`` across classes."""

    n_units: int
    chunks: tuple[Chunk, ...]

    def sizes(self) -> list[int]:
        out: dict[int, int] = {}
        for c in self.chunks:
            out[c.cls] = out.get(c.cls, 0) + c.size
        n_cls = max(out) + 1 if out else 0
        return [out.get(i, 0) for i in range(n_cls)]

    def validate(self) -> None:
        pos = 0
        for c in self.chunks:
            if c.start != pos or c.size < 0:
                raise ValueError(f"non-contiguous chunk table at {c}")
            pos = c.stop
        if pos != self.n_units:
            raise ValueError(f"chunk table covers {pos} of {self.n_units} units")


# ---------------------------------------------------------------------------
# Scheduling objectives
# ---------------------------------------------------------------------------

# What the scheduler optimizes.  ``perf`` is the paper's baseline (minimize
# makespan); ``energy`` minimizes modeled joules (the companion work's
# throughput-per-Watt goal); ``edp`` minimizes the energy-delay product,
# the standard compromise between the two.
OBJECTIVES = ("perf", "energy", "edp")

# Exponent applied to the per-class energy-efficiency discount: perf
# ignores efficiency entirely, energy weighs it fully, edp takes the
# geometric middle (sqrt) — minimizing E*t trades each factor evenly.
_OBJECTIVE_EXP = {"perf": 0.0, "energy": 1.0, "edp": 0.5}


def validate_objective(objective: str) -> str:
    if objective not in OBJECTIVES:
        raise ValueError(
            f"unknown objective {objective!r}; expected one of {OBJECTIVES}"
        )
    return objective


def objective_discounts(
    objective: str,
    rates: Sequence[float],
    powers: Optional[Sequence[float]] = None,
) -> np.ndarray:
    """Per-class efficiency discounts in ``(0, 1]`` for an objective.

    ``powers[i]`` is class ``i``'s modeled active draw in watts; the energy
    cost of a unit of work on class ``i`` is then ``powers[i] / rates[i]``
    joules.  The discount is ``(c_min / c_i) ** exp`` — 1.0 for the most
    efficient class, smaller for classes that burn more joules per unit —
    raised to the objective's exponent (0 for perf, 1 for energy, 0.5 for
    edp).  Under a *uniform* power model (powers proportional to rates,
    i.e. identical joules per unit) every discount is exactly 1.0, so the
    energy and edp objectives reduce bit-identically to perf.
    """

    validate_objective(objective)
    rates = np.asarray(rates, dtype=np.float64)
    n = len(rates)
    if objective == "perf" or powers is None:
        return np.ones(n)
    powers = np.asarray(powers, dtype=np.float64)
    if len(powers) != n:
        raise ValueError(f"expected {n} class powers, got {len(powers)}")
    disc = np.ones(n)
    live = (rates > 0.0) & (powers > 0.0)
    if not live.any():
        return disc
    cost = np.where(live, powers / np.maximum(rates, 1e-300), np.inf)  # J/unit
    rel = cost[live].min() / cost[live]
    disc[live] = rel ** _OBJECTIVE_EXP[objective]
    return disc


def _largest_remainder(weights: np.ndarray, total: int) -> np.ndarray:
    """Apportion ``total`` integer units proportionally to ``weights``."""

    weights = np.asarray(weights, dtype=np.float64)
    if weights.sum() <= 0:
        raise ValueError("weights must have positive sum")
    quota = weights / weights.sum() * total
    base = np.floor(quota).astype(np.int64)
    rem = total - int(base.sum())
    # Hand out the remainder to the largest fractional parts.
    order = np.argsort(-(quota - base))
    base[order[:rem]] += 1
    return base


def sss_partition(n_units: int, n_classes: int) -> ChunkTable:
    """Architecture-oblivious equal split (paper Section 4)."""

    sizes = _largest_remainder(np.ones(n_classes), n_units)
    return _table_from_sizes(n_units, sizes)


def sas_partition(
    n_units: int,
    ratios: Sequence[float],
    *,
    workers: Optional[Sequence[int]] = None,
    tiles: Optional[Sequence[int]] = None,
) -> ChunkTable:
    """Static-asymmetric partition (paper Section 5.2).

    ``ratios[i]`` is the relative per-worker throughput of class ``i`` (the
    paper's big:LITTLE ratio knob).  ``workers[i]`` scales by class size
    (4 cores per cluster in the paper; chips per pod here).  ``tiles[i]``
    aligns each class's chunk to its own stride — passing per-class tiles
    turns SAS into **CA-SAS** (two control trees, Section 5.3); a common
    tile is plain SAS with a single control tree.
    """

    ratios = np.asarray(ratios, dtype=np.float64)
    n_classes = len(ratios)
    w = np.asarray(workers if workers is not None else np.ones(n_classes))
    sizes = _largest_remainder(ratios * w, n_units)

    if tiles is not None:
        sizes = _align_sizes(sizes, np.asarray(tiles, dtype=np.int64), n_units)
    return _table_from_sizes(n_units, sizes)


def ca_sas_partition(
    n_units: int,
    ratios: Sequence[float],
    tiles: Sequence[int],
    *,
    workers: Optional[Sequence[int]] = None,
) -> ChunkTable:
    """CA-SAS = SAS with per-class tile (stride) alignment (Section 5.3)."""

    return sas_partition(n_units, ratios, workers=workers, tiles=tiles)


def _align_sizes(sizes: np.ndarray, tiles: np.ndarray, n_units: int) -> np.ndarray:
    """Round class sizes to their tiles while preserving the exact total.

    A class whose tile exceeds its proportional share cannot align without
    starving — *that class alone* keeps its unaligned share (the paper's
    partial-panel case: a cluster processes a sub-``m_c`` panel at reduced
    efficiency rather than no panel at all); every other class keeps its
    ``m_c`` alignment.  The residue from rounding the aligned classes down
    goes to a class that is already unaligned when one exists, else to the
    class with the smallest tile (the paper's LITTLE cluster mopping up
    remainder rows).  Since ``aligned[i] <= sizes[i]`` for every class the
    residue is provably non-negative.
    """

    sizes = sizes.copy()
    starved = (tiles > np.maximum(sizes, 1)) & (sizes > 0)
    aligned = np.where(starved, sizes, (sizes // tiles) * tiles)
    residue = int(n_units - aligned.sum())
    if starved.any():
        # Already-partial classes absorb the remainder; pick the one with
        # the smallest tile (closest analogue of the paper's sink).
        candidates = np.where(starved)[0]
        sink = int(candidates[np.argmin(tiles[candidates])])
    else:
        sink = int(np.argmin(tiles))
    aligned[sink] += residue
    return aligned


def _table_from_sizes(n_units: int, sizes: np.ndarray) -> ChunkTable:
    chunks = []
    pos = 0
    for cls, s in enumerate(sizes):
        chunks.append(Chunk(cls=cls, start=pos, size=int(s)))
        pos += int(s)
    table = ChunkTable(n_units=n_units, chunks=tuple(chunks))
    table.validate()
    return table


# ---------------------------------------------------------------------------
# Dynamic scheduling
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DasResult:
    """Outcome of the intra-step dynamic schedule (paper Section 5.4)."""

    assignments: list[Chunk]
    makespan: float
    busy: list[float]  # per-class busy time
    energy_j: Optional[float] = None  # modeled joules (when powers given)

    def sizes(self) -> list[int]:
        n_cls = len(self.busy)
        out = [0] * n_cls
        for c in self.assignments:
            out[c.cls] += c.size
        return out


def das_schedule(
    n_units: int,
    rates: Sequence[float],
    strides: Sequence[int],
    *,
    grab_overhead: float = 0.0,
    unit_cost: float = 1.0,
    objective: str = "perf",
    powers: Optional[Sequence[float]] = None,
    idle_powers: Optional[Sequence[float]] = None,
) -> DasResult:
    """Greedy dynamic chunk distribution (paper Section 5.4).

    Each class's leader, upon becoming idle, enters the critical section and
    claims the next ``strides[cls]`` units (its own ``m_c``); the work is
    then spread across the class's cores (folded into ``rates[cls]``, the
    aggregate class throughput in units/second).  ``grab_overhead`` models
    the critical section.  Deterministic: ties broken by class index.

    Non-``perf`` objectives bias the greedy choice toward energy-efficient
    classes via *virtual time*: class ``i`` advances its selection clock by
    ``dur / discount_i`` (see :func:`objective_discounts`), so a class that
    burns more joules per unit looks proportionally slower to the selector
    and grabs proportionally less work — while physical times, busy, and
    makespan still account real seconds.  Under a uniform power model every
    discount is 1.0 and the schedule is bit-identical to ``perf``.  When
    ``powers`` is given, ``energy_j`` reports the modeled joules (active
    draw while busy plus, when ``idle_powers`` is given, idle draw for the
    remainder of the makespan).

    A zero-rate class (a dead pod) never grabs work — it is skipped by the
    greedy loop, exactly as a hung cluster leader would never re-enter the
    paper's critical section.  All classes dead is unschedulable and raises.
    """

    rates = list(map(float, rates))
    strides = [max(1, int(s)) for s in strides]
    disc = objective_discounts(objective, rates, powers)
    alive = [i for i, r in enumerate(rates) if r > 0.0]
    if not alive and n_units > 0:
        raise ValueError("all class rates are zero — nothing can grab work")
    t = [0.0] * len(rates)   # next-free physical time per class
    tv = [0.0] * len(rates)  # virtual time: physical / efficiency discount
    busy = [0.0] * len(rates)
    pos = 0
    assignments: list[Chunk] = []
    while pos < n_units:
        cls = min(alive, key=lambda i: (tv[i], i))
        size = min(strides[cls], n_units - pos)
        dur = grab_overhead + size * unit_cost / rates[cls]
        assignments.append(Chunk(cls=cls, start=pos, size=size))
        pos += size
        t[cls] += dur
        tv[cls] += dur / disc[cls] if disc[cls] > 0 else float("inf")
        busy[cls] += dur
    makespan = max(t) if t else 0.0
    energy = None
    if powers is not None:
        p = np.asarray(powers, dtype=np.float64)
        energy = float(np.dot(p, busy))
        if idle_powers is not None:
            ip = np.asarray(idle_powers, dtype=np.float64)
            energy += float(np.dot(ip, makespan - np.asarray(busy)))
    return DasResult(
        assignments=assignments, makespan=makespan, busy=busy, energy_j=energy
    )


class DynamicScheduler:
    """Between-steps feedback controller (the SPMD-compatible CA-DAS).

    Observes per-class execution times of the previous step and re-derives
    the SAS chunk table for the next one from the throughput EMA.  This is
    the production straggler-mitigation path: a pod that slows down (thermal
    throttling, failing host) automatically sheds work, exactly as the
    paper's dynamic scheme sheds work from the LITTLE cluster — but at step
    granularity, which is what XLA's static shapes allow.

    **Rebalance hysteresis**: re-deriving the table costs a relayout
    downstream (the trainer re-pads its batch; the serving engine resizes
    its slot regions), so :meth:`table` keeps returning the *previous*
    partition until the calibrated throughput shares drift past
    ``rebalance_threshold`` (relative drift of the normalized rates since
    the last re-derivation).  This mirrors how the paper's workers keep
    their assignment between micro-kernel grabs (§5.4) instead of
    re-partitioning every iteration; noise-level timing jitter no longer
    thrashes the layout.
    """

    def __init__(
        self,
        n_classes: int,
        *,
        init_ratios: Optional[Sequence[float]] = None,
        tiles: Optional[Sequence[int]] = None,
        workers: Optional[Sequence[int]] = None,
        ema: float = 0.5,
        rebalance_threshold: float = 0.05,
        objective: str = "perf",
        powers: Optional[Sequence[float]] = None,
    ):
        self.n_classes = n_classes
        self.ema = float(ema)
        self.tiles = list(tiles) if tiles is not None else None
        self.workers = list(workers) if workers is not None else None
        self.objective = validate_objective(objective)
        self.powers = (
            np.asarray(powers, dtype=np.float64).copy() if powers is not None else None
        )
        if self.powers is not None and len(self.powers) != n_classes:
            raise ValueError(
                f"expected {n_classes} class powers, got {len(self.powers)}"
            )
        self.rates = np.asarray(
            init_ratios if init_ratios is not None else np.ones(n_classes), dtype=np.float64
        ).copy()
        self.rebalance_threshold = float(rebalance_threshold)
        self._last_sizes: Optional[np.ndarray] = None
        self._last_n_units: Optional[int] = None
        self._table_rates: Optional[np.ndarray] = None  # rates at last re-derive
        self._last_table: Optional[ChunkTable] = None
        self.rebalances = 0

    def observe(self, class_units: Sequence[int], class_times: Sequence[float]) -> None:
        """Record measured units processed and wall time per class.

        A starvation floor (2 % of the fastest class) keeps every class
        observable: a class that received zero units has no throughput
        signal, and without the floor it could never re-enter the schedule
        (the paper's dynamic queue has the same property — every cluster
        always grabs at least one chunk).

        Both sequences must have exactly ``n_classes`` entries: a caller
        handing per-pod telemetry to a per-class scheduler (or vice versa)
        is a wiring bug, not a partial observation.
        """

        if len(class_units) != self.n_classes or len(class_times) != self.n_classes:
            raise ValueError(
                f"observe() expects {self.n_classes} per-class entries, got "
                f"{len(class_units)} units / {len(class_times)} times"
            )
        for i, (u, dt) in enumerate(zip(class_units, class_times)):
            if u > 0 and dt > 0:
                inst = u / dt
                self.rates[i] = self.ema * inst + (1 - self.ema) * self.rates[i]
        floor = 0.02 * float(self.rates.max())
        self.rates = np.maximum(self.rates, floor)

    def drift(self) -> float:
        """Relative drift of the normalized rates since the last re-derive.

        ``max_i |r̂_i - r̂_last_i| / max_j r̂_last_j`` over the per-class
        throughput *shares* (normalization makes a uniform slowdown — which
        changes no assignment — zero drift).  The delta is measured against
        the **largest** reference share, not each class's own: a
        starvation-floored near-dead class (share pinned at the ~2 % floor)
        would otherwise amplify noise-level jitter into constant rebalance
        thrash, since any absolute wobble divided by a tiny own-share looks
        enormous.  ``inf`` before any table has been derived.
        """

        if self._table_rates is None:
            return float("inf")
        cur = self.rates / self.rates.sum()
        ref = self._table_rates / self._table_rates.sum()
        return float(np.max(np.abs(cur - ref)) / ref.max())

    def needs_rebalance(self) -> bool:
        """Would :meth:`table` re-derive the partition right now?"""

        return self.drift() > self.rebalance_threshold

    def table(self, n_units: int) -> ChunkTable:
        """The partition for ``n_units``, re-derived only past hysteresis.

        The cached table is reused while the rate shares stay within
        ``rebalance_threshold`` of the shares the table was derived from
        (and ``n_units`` is unchanged); a different ``n_units`` always
        re-derives (the old sizes cannot cover it) without counting as a
        rebalance.
        """

        if (
            self._last_table is not None
            and self._last_n_units == n_units
            and not self.needs_rebalance()
        ):
            return self._last_table
        drift = self.drift()  # trigger magnitude, before _table_rates resets
        # Non-perf objectives shrink inefficient classes' shares by their
        # efficiency discount; under uniform power every discount is 1.0
        # and the weights (hence the table) are bit-identical to perf.
        weights = self.rates * objective_discounts(
            self.objective, self.rates, self.powers
        )
        t = sas_partition(n_units, weights, workers=self.workers, tiles=self.tiles)
        sizes = np.asarray(t.sizes())
        if (
            self._last_sizes is not None
            and self._last_n_units == n_units
            and len(self._last_sizes) == len(sizes)
            and np.any(sizes != self._last_sizes)
        ):
            self.rebalances += 1
            _trace.instant(
                "scheduler.rebalance", cat="scheduler",
                drift=drift, threshold=self.rebalance_threshold,
                n_units=n_units,
                before=[int(s) for s in self._last_sizes],
                after=[int(s) for s in sizes],
            )
        self._last_sizes = sizes
        self._last_n_units = n_units
        self._table_rates = self.rates.copy()
        self._last_table = t
        return t


def deficit_route(weights: Sequence[float], routed: Sequence[int]) -> int:
    """Largest-remainder router: the class furthest behind its quota.

    Given target ``weights`` and cumulative per-class ``routed`` counts,
    returns the class whose share of the *next* total (``sum(routed)+1``)
    is most under-served — so the running split tracks the proportional
    quota with bounded deficit, exactly like the serving engine's
    admission router (extracted from there so the fleet can route
    requests over engines with the same arithmetic it uses over classes).
    """

    w = np.asarray(weights, dtype=np.float64)
    if w.ndim != 1 or len(w) != len(routed):
        raise ValueError(
            f"weights/routed arity mismatch: {len(w)} vs {len(routed)}"
        )
    if not w.sum() > 0:
        raise ValueError(f"need positive total weight, got {w.tolist()}")
    total = int(sum(routed)) + 1
    quota = w / w.sum() * total
    base = np.floor(quota).astype(np.int64)
    rem = total - int(base.sum())
    order = np.argsort(-(quota - base), kind="stable")
    base[order[:rem]] += 1
    return int(np.argmax(base - np.asarray(routed)))


def fleet_scheduler(
    rel_throughput: Sequence[float],
    *,
    ema: float = 0.5,
    rebalance_threshold: float = 0.05,
    objective: str = "perf",
    powers: Optional[Sequence[float]] = None,
) -> DynamicScheduler:
    """The engines-as-classes adapter: a :class:`DynamicScheduler` whose
    "classes" are whole serving engines.

    This is the paper's scheduling story lifted one level — calibrated
    tokens-per-second per engine plays ``rel_throughput``, and the same
    EMA/drift/hysteresis machinery (class-count-agnostic since PR 3)
    balances *requests* over engines instead of rows over pods.  No
    tiles, no worker multiplicity: a request is the indivisible unit.
    """

    rel = [float(r) for r in rel_throughput]
    if not rel or min(rel) <= 0:
        raise ValueError(f"need positive per-engine throughputs, got {rel}")
    return DynamicScheduler(
        len(rel),
        init_ratios=rel,
        ema=ema,
        rebalance_threshold=rebalance_threshold,
        objective=objective,
        powers=powers,
    )


def balanced_ratio(rates: Sequence[float]) -> float:
    """The paper's optimal ratio knob: fast rate / slow rate (Section 5.2.2).

    Defined for any number of classes in any order — the knob is the spread
    between the fastest and slowest class (1.0 when homogeneous or with a
    single class).  Non-positive rates have no meaningful ratio and raise.
    """

    rates = list(map(float, rates))
    if not rates:
        raise ValueError("need at least one class rate")
    if min(rates) <= 0.0:
        raise ValueError(f"class rates must be positive, got {rates}")
    return max(rates) / min(rates)


__all__ = [
    "Chunk",
    "ChunkTable",
    "DasResult",
    "DynamicScheduler",
    "OBJECTIVES",
    "validate_objective",
    "objective_discounts",
    "sss_partition",
    "sas_partition",
    "ca_sas_partition",
    "das_schedule",
    "balanced_ratio",
    "deficit_route",
    "fleet_scheduler",
]
