"""Port vs reference: the fault-tolerant fleet and the engine surface it drives.

The fleet (``runtime/fleet.py``) and its fault injection
(``runtime/faults.py``) are copies of the reference's modules; here they
run over the port's engines.  What is held:

  * **the fault matrix** — under each injectable fault (engine stall, pod
    death, admission failure, latency spike) every submitted request
    completes exactly once with tokens **bitwise** equal to a fault-free
    single-engine run of the port, including requests migrated while
    queued and requests retried after an engine death, and across slot
    tables of different sizes;
  * **the fleet's decisions against the reference's** — both ``Fleet``
    classes over the same stub engines and the same seeded
    ``FaultPlan``: identical stats, completion histories and trace
    instants;
  * the control plane on the stub (health hysteresis, parking, deadlines,
    streaming) and the conservation property under seeded plans;
  * the engine's fleet surface against the reference engine's, and the
    serve CLI's ``--fleet``.

Real engines run the reduced internlm2 (a row-local family: greedy decode
is a function of each request's own prompt) on the reference's weights,
carried over by ``convert.params_from_jax``; the numpy stub engine below
covers the control-plane paths.
"""

import asyncio
import collections
import dataclasses
import sys

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import observability as JOBS
from repro.configs import get_config as jax_config
from repro.core.asymmetric import AsymmetricMesh as JMesh
from repro.launch import serve as jax_serve
from repro.models import model_zoo as JZ
from repro.runtime import faults as JF
from repro.runtime.fleet import Fleet as JFleet
from repro.runtime.serving import ServingEngine as JaxEngine

from repro_torch import observability as OBS
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.asymmetric import AsymmetricMesh, DeviceClass
from repro_torch.core.schedule import deficit_route, fleet_scheduler
from repro_torch.launch import serve
from repro_torch.runtime import faults
from repro_torch.runtime.fleet import Fleet
from repro_torch.runtime.serving import Request, ServingEngine

torch.set_num_threads(1)

ARCH = "internlm2-1.8b"
GEN_LEN = 6
SEQ_CAP = 32


# ---------------------------------------------------------------------------
# The stub engine: the engine surface the fleet touches, without a model
# ---------------------------------------------------------------------------


def stub_tokens(prompt: np.ndarray, n: int) -> np.ndarray:
    """The stub's "greedy decode": ``n`` generated tokens, a function of
    the prompt alone (the property every fleet exactness test leans on)."""

    seed = int(np.asarray(prompt, np.int64).sum()) % 997
    return np.asarray([(seed * 7 + k * 13) % 997 for k in range(n)], np.int32)


@dataclasses.dataclass
class StubCompletion:
    rid: int
    tokens: np.ndarray
    prompt_len: int
    stop: str = "budget"


class _StubStats:
    def __init__(self):
        self.tokens = 0
        self.modeled_decode_s = 0.0


class _StubAsym:
    """Just enough ``asym`` for the fleet's default ``powers``."""

    def __init__(self, watts: float):
        self._watts = watts

    def pod_active_watts(self):
        return [self._watts]


class StubEngine:
    """Slot-table serving semantics in numpy: one class queue, one token a
    slot a step on a modeled clock of ``1/speed`` seconds a step."""

    def __init__(self, n_slots: int = 2, speed: float = 1.0, watts: float = 10.0):
        if n_slots < 1 or speed <= 0:
            raise ValueError("need n_slots >= 1 and speed > 0")
        self.n_slots = int(n_slots)
        self.speed = float(speed)
        self.queues = [collections.deque()]
        self.slot_rid = np.full(self.n_slots, -1, np.int64)
        self._slot_req: dict[int, Request] = {}
        self._slot_toks: dict[int, list[int]] = {}
        self._slot_remaining: dict[int, int] = {}
        self._next_rid = 0
        self.completions: list[StubCompletion] = []
        self.stats = _StubStats()
        self.asym = _StubAsym(watts)

    def submit(self, prompt, max_new_tokens: int) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.queues[0].append(Request(rid=rid, prompt=np.asarray(prompt, np.int32).reshape(-1),
                                      max_new_tokens=int(max_new_tokens)))
        return rid

    def admit(self) -> int:
        admitted = 0
        for slot in np.nonzero(self.slot_rid < 0)[0]:
            if not self.queues[0]:
                break
            req = self.queues[0].popleft()
            slot = int(slot)
            self.slot_rid[slot] = req.rid
            self._slot_req[slot] = req
            self._slot_toks[slot] = []
            self._slot_remaining[slot] = req.max_new_tokens
            admitted += 1
        return admitted

    def step(self) -> int:
        active = np.nonzero(self.slot_rid >= 0)[0]
        if len(active) == 0:
            return 0
        for slot in active:
            slot = int(slot)
            req = self._slot_req[slot]
            k = len(self._slot_toks[slot])
            self._slot_toks[slot].append(int(stub_tokens(req.prompt, k + 1)[k]))
            self._slot_remaining[slot] -= 1
            if self._slot_remaining[slot] == 0:
                self._retire(slot)
        self.stats.tokens += len(active)
        self.stats.modeled_decode_s += 1.0 / self.speed
        return len(active)

    def _retire(self, slot: int) -> None:
        req = self._slot_req.pop(slot)
        toks = np.asarray(self._slot_toks.pop(slot), np.int32)
        del self._slot_remaining[slot]
        self.slot_rid[slot] = -1
        self.completions.append(StubCompletion(rid=req.rid, tokens=np.concatenate([req.prompt, toks]),
                                               prompt_len=len(req.prompt)))

    def withdraw(self, rid: int):
        for i, req in enumerate(self.queues[0]):
            if req.rid == rid:
                del self.queues[0][i]
                return req
        return None

    def export_queued(self) -> list[Request]:
        out = sorted(self.queues[0], key=lambda r: r.rid)
        self.queues[0].clear()
        return out

    def partial_tokens(self, rid: int):
        for slot, req in self._slot_req.items():
            if req.rid == rid:
                return np.asarray(self._slot_toks[slot], np.int32)
        return None

    def calibrated_tps(self) -> float:
        return self.speed

    def health(self) -> dict:
        return {"queued": len(self.queues[0]), "active": int((self.slot_rid >= 0).sum()),
                "slots": self.n_slots, "calibrated_tps": self.calibrated_tps(),
                "completed": len(self.completions)}


# ---------------------------------------------------------------------------
# Real engines (reduced internlm2 on the CPU)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def zoo():
    jcfg = jax_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jparams = JZ.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def _engine(cfg, params, *, slots_per_pod=2):
    asym = AsymmetricMesh([DeviceClass("only", chips_per_pod=1)], strategy="ca-das", batch_tile=1)
    return ServingEngine(cfg, params, asym, seq_cap=SEQ_CAP, slots_per_pod=slots_per_pod,
                         class_sharded="off", device="cpu")


def _requests(cfg, n=10):
    rng = np.random.default_rng(3)
    return [rng.integers(0, cfg.vocab, (4 if i % 2 else 8,), dtype=np.int32) for i in range(n)]


def _run(fleet, prompts, plan=None, *, inject=faults.injected):
    with inject(plan) if plan else _null():
        for p in prompts:
            fleet.submit(p, GEN_LEN)
        fleet.run()
    return {c.rid: np.asarray(c.tokens) for c in fleet.completions}


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.fixture(scope="module")
def reference(zoo):
    """Fault-free single-engine tokens: the exactness yardstick."""

    *_, cfg, params = zoo
    return _run(Fleet([_engine(cfg, params)]), _requests(cfg))


# ---------------------------------------------------------------------------
# The fault matrix: exactly once, bitwise, under every fault type
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("point", sorted(faults.FAULT_POINTS))
def test_fault_matrix_bit_identical(zoo, reference, point):
    *_, cfg, params = zoo
    prompts = _requests(cfg)
    plan = faults.FaultPlan([faults.FaultEvent(point=point, engine=0, tick=2, duration=3)])
    fleet = Fleet([_engine(cfg, params) for _ in range(2)])
    toks = _run(fleet, prompts, plan)

    assert fleet.stats.submitted == fleet.stats.completed == len(prompts)
    assert fleet.stats.duplicate_completions == 0
    assert set(toks) == set(reference)
    for rid in reference:
        assert np.array_equal(toks[rid], reference[rid]), f"{point}: rid {rid} diverged"
    if point == "pod_death":
        assert fleet.stats.engine_kills == 1
        assert sum(fleet._alive) == 1
        assert fleet.stats.migrated > 0
        assert fleet.stats.retries > 0
    if point == "engine_stall":
        assert fleet.stats.stalled_ticks == 3
    if point == "admission_fail":
        assert fleet.stats.admission_faults == 3
    if point == "latency_spike":
        assert fleet.stats.latency_spikes == 3
        assert fleet.stats.migrated == 0  # a perf fault, not a correctness one


def test_nofault_fleet_bit_identical(zoo, reference):
    *_, cfg, params = zoo
    fleet = Fleet([_engine(cfg, params) for _ in range(2)])
    toks = _run(fleet, _requests(cfg))
    assert fleet.stats.completed == fleet.stats.submitted
    for rid in reference:
        assert np.array_equal(toks[rid], reference[rid])
    assert all(e.stats.tokens > 0 for e in fleet.engines)


def test_queued_requests_migrate_off_dead_engine(zoo, reference):
    """Engines of one slot (against the yardstick's two) force deep queues;
    the kill must migrate them, and the tokens stay bitwise."""

    *_, cfg, params = zoo
    plan = faults.FaultPlan([faults.FaultEvent(point="pod_death", engine=0, tick=2)])
    fleet = Fleet([_engine(cfg, params, slots_per_pod=1) for _ in range(2)])
    toks = _run(fleet, _requests(cfg), plan)
    assert fleet.stats.completed == fleet.stats.submitted
    assert fleet.stats.migrated > 0
    for rid in reference:
        assert np.array_equal(toks[rid], reference[rid])
    assert all(c.engine == 1 for c in fleet.completions if c.attempts > 1 or c.migrations > 0)


@pytest.mark.parametrize("slots_per_pod", [1, 3, 5])
def test_tokens_do_not_depend_on_the_slot_table(zoo, reference, slots_per_pod):
    """A request's tokens are the same whatever the engine's slot count
    (the decode GEMM's M), so a request may move between engines of
    different sizes and stay bitwise."""

    *_, cfg, params = zoo
    toks = _run(Fleet([_engine(cfg, params, slots_per_pod=slots_per_pod)]), _requests(cfg))
    for rid in reference:
        assert np.array_equal(toks[rid], reference[rid]), rid


@pytest.mark.parametrize("device_class", ["big", "little"])
def test_decode_blocks_share_bk_across_slot_counts(device_class):
    """At the full-width internlm2 GEMM shapes, an engine of 1 to 64 slots
    (the decode GEMMs' M) gets one ``bk`` on the card's kernels, so its
    fp32 sums run in one order and a request's tokens do not depend on
    the slot count of the engine that serves it."""

    from repro_torch.core.asymmetric import biglittle_classes
    from repro_torch.models import transformer as TX

    backend = "cuda"  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    asym = AsymmetricMesh(biglittle_classes(chips_per_pod=1), strategy="ca-das", batch_tile=1,
                          backend=backend)
    ctx = asym.execution_context(device_class)
    assert ctx.backend() == {"big": "cuda", "little": "cuda_lean"}[device_class]
    for (k, n), _ in TX.gemm_shapes(get_config(ARCH)):
        bks = {ctx.block_config(m, k, n, "bfloat16", 2).bk for m in range(1, 65)}
        assert len(bks) == 1, ((k, n), bks)


# ---------------------------------------------------------------------------
# Fault plumbing: off is free, arming, validation, seeded plans
# ---------------------------------------------------------------------------


def test_fault_injection_off_is_free():
    assert faults._PLAN is None
    assert not faults.armed()
    assert faults.fault_active("pod_death", engine=0, tick=1) is None


def test_arm_disarm_and_injected_restores():
    plan = faults.FaultPlan([faults.FaultEvent(point="engine_stall", engine=0, tick=1)])
    faults.arm(plan)
    try:
        assert faults.armed()
        assert faults.fault_active("engine_stall", engine=0, tick=1) is not None
        assert faults.fault_active("engine_stall", engine=1, tick=1) is None
        assert faults.fault_active("pod_death", engine=0, tick=1) is None
    finally:
        faults.disarm()
    assert not faults.armed()
    with pytest.raises(RuntimeError):
        with faults.injected(plan):
            assert faults.armed()
            raise RuntimeError("boom")
    assert not faults.armed()


def test_fault_validation():
    with pytest.raises(ValueError):
        faults.validate_point("not_a_point")  # repro: noqa=RPR006 -- negative test: validation must reject drift  # repro_torch: noqa=RPR006 -- negative test: validation must reject drift
    with pytest.raises(ValueError):
        faults.FaultEvent(point="not_a_point", engine=0, tick=1)  # repro: noqa=RPR006 -- negative test: validation must reject drift  # repro_torch: noqa=RPR006 -- negative test: validation must reject drift
    with pytest.raises(ValueError):
        faults.FaultEvent(point="engine_stall", engine=-1, tick=1)
    plan = faults.FaultPlan([faults.FaultEvent(point="engine_stall", engine=0, tick=1)])
    with pytest.raises(ValueError):
        plan.active("not_a_point", 0, 1)


def test_seeded_plan_deterministic_and_keeps_survivor():
    a = faults.FaultPlan.seeded(11, n_engines=3, horizon=20, n_events=6)
    b = faults.FaultPlan.seeded(11, n_engines=3, horizon=20, n_events=6)
    assert a.events == b.events
    assert len(a.events) <= 6
    assert len({e.engine for e in a.events if e.point == "pod_death"}) < 3
    for ev in a.events:
        assert ev.point in faults.FAULT_POINTS
        assert 0 <= ev.engine < 3


@pytest.mark.parametrize("seed", [0, 11, 123, 4567])
def test_seeded_plans_match_reference(seed):
    got = faults.FaultPlan.seeded(seed, n_engines=3, horizon=20, n_events=6)
    want = JF.FaultPlan.seeded(seed, n_engines=3, horizon=20, n_events=6)
    assert [dataclasses.astuple(e) for e in got.events] == [dataclasses.astuple(e) for e in want.events]


def test_pod_death_is_permanent():
    ev = faults.FaultEvent(point="pod_death", engine=0, tick=5)
    assert not ev.covers(4)
    assert ev.covers(5) and ev.covers(500)
    stall = faults.FaultEvent(point="engine_stall", engine=0, tick=5, duration=2)
    assert stall.covers(5) and stall.covers(6) and not stall.covers(7)


# ---------------------------------------------------------------------------
# Scheduling adapter: deficit routing over DAS shares
# ---------------------------------------------------------------------------


def test_deficit_route_tracks_weights():
    routed = [0, 0]
    for _ in range(30):
        routed[deficit_route([2.0, 1.0], routed)] += 1
    assert routed == [20, 10]


def test_deficit_route_validation():
    with pytest.raises(ValueError):
        deficit_route([0.0, 0.0], [0, 0])
    with pytest.raises(ValueError):
        deficit_route([1.0], [0, 0])
    with pytest.raises(ValueError):
        fleet_scheduler([])
    with pytest.raises(ValueError):
        fleet_scheduler([1.0, 0.0])


def test_fleet_routes_proportional_to_throughput():
    fleet = Fleet([StubEngine(n_slots=8, speed=3.0), StubEngine(n_slots=8, speed=1.0)])
    for i in range(40):
        fleet.submit(np.asarray([i], np.int32), 2)
    assert abs(fleet._routed[0] - 30) <= 2


# ---------------------------------------------------------------------------
# Control plane on the stub: health, parking, deadlines, streaming
# ---------------------------------------------------------------------------


def _stub_fleet(n=2, **kw):
    return Fleet([StubEngine(n_slots=2) for _ in range(n)], **kw)


def test_health_hysteresis_trip_and_recover():
    fleet = _stub_fleet(unhealthy_after=2, healthy_after=2)
    plan = faults.FaultPlan([faults.FaultEvent(point="engine_stall", engine=0, tick=1, duration=3)])
    with faults.injected(plan):
        for i in range(12):
            fleet.submit(np.asarray([i], np.int32), 2)
        for _ in range(8):
            fleet.tick()
        assert fleet.stats.health_trips == 1
        assert fleet.stats.health_recoveries == 1
        assert fleet.health()["unhealthy"] == []
        fleet.run()
    assert fleet.stats.completed == fleet.stats.submitted
    assert fleet.stats.duplicate_completions == 0


def test_energy_objective_parks_and_unparks_engines():
    fleet = Fleet([StubEngine(n_slots=2, watts=1.0), StubEngine(n_slots=2, watts=100.0)],
                  objective="energy")
    fleet.submit(np.asarray([1], np.int32), 2)
    fleet.tick()
    assert fleet.health()["parked"] == [1]
    assert fleet.stats.engine_parks >= 1
    for i in range(6):
        fleet.submit(np.asarray([i], np.int32), 4)
    fleet.tick()
    assert fleet.stats.engine_unparks >= 1
    fleet.run()
    assert fleet.stats.completed == fleet.stats.submitted


def test_perf_objective_never_parks():
    fleet = _stub_fleet()
    fleet.submit(np.asarray([1], np.int32), 2)
    fleet.run()
    assert fleet.stats.engine_parks == 0


def test_deadline_requeues_stranded_request():
    fleet = Fleet([StubEngine(n_slots=1), StubEngine(n_slots=1)], rel_throughput=[1000.0, 1.0])
    for i in range(3):
        fleet.submit(np.asarray([10 + i], np.int32), 8, deadline=1)
    for _ in range(4):
        fleet.tick()
    assert fleet.stats.deadline_requeues >= 1
    fleet.run()
    assert fleet.stats.completed == 3
    assert fleet.stats.duplicate_completions == 0


def test_stub_engine_matches_contract():
    eng = StubEngine(n_slots=2)
    prompt = np.asarray([5, 6, 7], np.int32)
    eng.submit(prompt, 4)
    eng.admit()
    while not eng.completions:
        eng.step()
    c = eng.completions[0]
    assert np.array_equal(c.tokens[:3], prompt)
    assert np.array_equal(c.tokens[3:], stub_tokens(prompt, 4))


def _stream_one(fleet, prompt, n, plan=None):
    async def main():
        with faults.injected(plan) if plan else _null():
            rid = await fleet.submit_async(prompt, n)
            chunks = []

            async def consume():
                async for ch in fleet.stream(rid):
                    chunks.append(np.asarray(ch))

            task = asyncio.ensure_future(consume())
            await fleet.run_async()
            await task
        done = await fleet.complete_async(rid)
        return np.concatenate(chunks), done

    return asyncio.run(main())


def test_stream_yields_generated_tokens():
    prompt = np.asarray([3, 1, 4], np.int32)
    got, done = _stream_one(_stub_fleet(), prompt, 5)
    assert np.array_equal(got, stub_tokens(prompt, 5))
    assert done.rid == 0


def test_stream_consistent_across_engine_kill():
    plan = faults.FaultPlan([faults.FaultEvent(point="pod_death", engine=0, tick=2)])
    fleet = Fleet([StubEngine(n_slots=1), StubEngine(n_slots=1)], rel_throughput=[1000.0, 1.0])
    prompt = np.asarray([9, 9], np.int32)
    got, done = _stream_one(fleet, prompt, 6, plan)
    assert np.array_equal(got, stub_tokens(prompt, 6))
    assert done.attempts == 2 and done.engine == 1


def test_stream_of_a_real_engine_across_a_kill(zoo, reference):
    """The streamed chunks of a request retried after its engine died join
    to its completion's generated tokens, which equal the yardstick's."""

    *_, cfg, params = zoo
    plan = faults.FaultPlan([faults.FaultEvent(point="pod_death", engine=0, tick=3)])
    fleet = Fleet([_engine(cfg, params), _engine(cfg, params)], rel_throughput=[1000.0, 1.0])
    prompt = _requests(cfg)[0]
    got, done = _stream_one(fleet, prompt, GEN_LEN, plan)
    assert done.attempts == 2 and fleet.stats.retries == 1
    assert np.array_equal(got, done.tokens[done.prompt_len:])
    assert np.array_equal(done.tokens, reference[0])


def test_all_engines_dead_raises():
    fleet = Fleet([StubEngine(n_slots=1)])
    plan = faults.FaultPlan([faults.FaultEvent(point="pod_death", engine=0, tick=1)])
    with faults.injected(plan):
        fleet.submit(np.asarray([1], np.int32), 4)
        with pytest.raises(RuntimeError, match="engine"):
            fleet.run()


# ---------------------------------------------------------------------------
# Conservation under arbitrary seeded fault plans (the property test)
# ---------------------------------------------------------------------------


@given(
    seed=st.integers(0, 10_000),
    n_engines=st.integers(2, 4),
    n_requests=st.integers(1, 12),
    n_events=st.integers(0, 6),
)
@settings(max_examples=50, deadline=None)
def test_fleet_conservation_under_faults(seed, n_engines, n_requests, n_events):
    """Under any seeded plan every request completes exactly once with the
    stub's tokens, and the counters reconcile with the trace instants."""

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 997, (int(rng.integers(1, 6)),)).astype(np.int32)
               for _ in range(n_requests)]
    plan = faults.FaultPlan.seeded(seed, n_engines=n_engines, horizon=12, n_events=n_events)
    engines = [StubEngine(n_slots=int(rng.integers(1, 3)), speed=float(rng.integers(1, 4)))
               for _ in range(n_engines)]
    fleet = Fleet(engines, retry_backoff=1)
    OBS.enable()
    try:
        with faults.injected(plan):
            for p in prompts:
                fleet.submit(p, 3)
            fleet.run()
    finally:
        buf = OBS.disable()

    assert fleet.stats.completed == fleet.stats.submitted == n_requests
    assert fleet.stats.duplicate_completions == 0
    assert sorted(c.rid for c in fleet.completions) == list(range(n_requests))
    for c in fleet.completions:
        got = np.asarray(c.tokens)
        assert np.array_equal(got[: c.prompt_len], prompts[c.rid])
        assert np.array_equal(got[c.prompt_len:], stub_tokens(prompts[c.rid], 3))
    names = [e.name for e in buf.events if e.ph == "i"]
    assert names.count("fleet.migrate") == fleet.stats.migrated
    assert names.count("fleet.retry") == fleet.stats.retries
    assert names.count("fleet.engine_kill") == fleet.stats.engine_kills


# ---------------------------------------------------------------------------
# The port's Fleet against the reference's, decision for decision
# ---------------------------------------------------------------------------


def _drive_traced(fleet_cls, faults_mod, obs, engines, prompts, plan, kw):
    fleet = fleet_cls(engines, **kw)
    obs.enable()
    try:
        with faults_mod.injected(plan):
            for i, p in enumerate(prompts):
                fleet.submit(p, 3 + i % 3, deadline=2 if i % 4 == 0 else None)
            fleet.run()
    finally:
        buf = obs.disable()
    history = [(c.rid, c.engine, c.attempts, c.migrations, c.tokens.tolist()) for c in fleet.completions]
    instants = [(e.name, e.args) for e in buf.events if e.ph == "i"]
    return fleet.stats.snapshot(), history, instants, fleet.health()


@pytest.mark.parametrize("objective", ["perf", "energy"])
@pytest.mark.parametrize("seed", range(8))
def test_port_fleet_decides_as_the_reference(seed, objective):
    rng = np.random.default_rng(seed)
    n_engines = 2 + seed % 3
    shape = [(int(rng.integers(1, 3)), float(rng.integers(1, 4)), float(rng.integers(1, 50)))
             for _ in range(n_engines)]
    prompts = [rng.integers(0, 997, (int(rng.integers(1, 6)),)).astype(np.int32) for _ in range(10)]
    kw = dict(objective=objective, retry_backoff=1)

    def engines():
        return [StubEngine(n_slots=s, speed=v, watts=w) for s, v, w in shape]

    plan = dict(n_engines=n_engines, horizon=12, n_events=5)
    got = _drive_traced(Fleet, faults, OBS, engines(), prompts, faults.FaultPlan.seeded(seed, **plan), kw)
    want = _drive_traced(JFleet, JF, JOBS, engines(), prompts, JF.FaultPlan.seeded(seed, **plan), kw)
    assert got[0] == want[0]  # stats
    assert got[1] == want[1]  # completion histories
    assert got[2] == want[2]  # trace instants, in order, with their arguments
    assert got[3] == want[3]  # health
    assert got[0]["completed"] == got[0]["submitted"] == len(prompts)


# ---------------------------------------------------------------------------
# The engine's fleet surface against the reference engine's
# ---------------------------------------------------------------------------


def test_withdraw_and_export_rollback_router_counts(zoo):
    *_, cfg, params = zoo
    eng = _engine(cfg, params)
    rids = [eng.submit(p, GEN_LEN) for p in _requests(cfg, n=4)]
    routed_before = list(eng._routed)
    req = eng.withdraw(rids[1])
    assert req is not None and req.rid == rids[1]
    assert eng.withdraw(rids[1]) is None
    assert sum(eng._routed) == sum(routed_before) - 1
    rest = eng.export_queued()
    assert [r.rid for r in rest] == [rids[0], rids[2], rids[3]]
    assert all(len(q) == 0 for q in eng.queues)
    assert sum(eng._routed) == 0


def test_engine_surface_matches_reference_engine(zoo):
    """Router counts after each withdraw/export, ``health()`` and
    ``calibrated_tps`` equal the reference engine's on the big/little
    mesh (two class queues), and ``partial_tokens`` tracks a slot."""

    from repro.core.asymmetric import biglittle_classes as jax_classes
    from repro_torch.core.asymmetric import biglittle_classes

    jcfg, jparams, cfg, params = zoo
    jeng = JaxEngine(jcfg, jparams, JMesh(jax_classes(chips_per_pod=1), strategy="ca-das",
                                          batch_tile=1), seq_cap=SEQ_CAP, slots_per_pod=2,
                     class_sharded="off")
    eng = ServingEngine(cfg, params, AsymmetricMesh(biglittle_classes(chips_per_pod=1),
                                                    strategy="ca-das", batch_tile=1),
                        seq_cap=SEQ_CAP, slots_per_pod=2, device="cpu")
    prompts = _requests(cfg, n=7)
    assert [eng.submit(p, GEN_LEN) for p in prompts] == [jeng.submit(p, GEN_LEN) for p in prompts]
    assert eng._routed == jeng._routed
    assert eng.health() == jeng.health()
    assert eng.calibrated_tps() == jeng.calibrated_tps()
    for rid in (5, 2, 2, 99):
        got, want = eng.withdraw(rid), jeng.withdraw(rid)
        assert (got is None) == (want is None)
        assert got is None or (got.rid == want.rid and np.array_equal(got.prompt, want.prompt))
        assert eng._routed == jeng._routed
    for _ in range(3):
        eng.submit(prompts[0], GEN_LEN)
        jeng.submit(prompts[0], GEN_LEN)
    assert eng.admit() > 0
    assert eng.health()["active"] > 0 and eng.health()["queued"] >= 0
    slot = int(np.nonzero(eng.slot_rid >= 0)[0][0])
    rid = int(eng.slot_rid[slot])
    assert eng.partial_tokens(rid).tolist() == eng._slot_toks[slot]
    assert eng.withdraw(rid) is None  # admitted work cannot be withdrawn
    assert eng.partial_tokens(12345) is None
    jeng.admit()
    assert eng.health() == jeng.health()
    assert [r.rid for r in eng.export_queued()] == [r.rid for r in jeng.export_queued()]
    assert eng._routed == jeng._routed  # what stays counted is the admitted work
    assert sum(eng._routed) == eng.health()["active"]


# ---------------------------------------------------------------------------
# The serve CLI's --fleet
# ---------------------------------------------------------------------------


CLI = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "6", "--prompt-len", "5",
       "--gen-len", "4"]


@pytest.mark.parametrize("extra", [[], ["--objective", "energy"]])
def test_cli_fleet_tokens_equal_single_engine(extra, capsys):
    summary, tokens, fleet = serve.serve(serve.build_parser().parse_args(CLI + ["--fleet", "2"] + extra))
    _, want, eng = serve.serve(serve.build_parser().parse_args(CLI + ["--fleet", "0"] + extra))
    assert summary["path"] == "fleet:2" and isinstance(fleet, Fleet)
    stats = summary["engine"]["fleet"]
    assert stats["completed"] == stats["submitted"] == 6 and stats["duplicate_completions"] == 0
    assert len(summary["engine"]["engines"]) == 2
    assert summary["engine"]["completed_budget"] == 6
    assert set(summary["engine"]["health"]["engines"][0]) == set(eng.health())
    assert np.array_equal(tokens, want)
    assert "fleet rel_throughput:" in capsys.readouterr().out


def test_cli_fleet_refusals_match_reference(monkeypatch):
    with pytest.raises(SystemExit) as got:
        serve.main(CLI + ["--fleet", "2", "--one-shot"])
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--reduced", "--fleet", "2", "--one-shot"])
    with pytest.raises(SystemExit) as want:
        jax_serve.main()
    assert str(got.value) == str(want.value)
    assert "cannot be combined with --one-shot" in str(got.value)
    with pytest.raises(SystemExit, match="--fleet must be >= 0, got -1"):
        serve.main(CLI + ["--fleet", "-1"])
