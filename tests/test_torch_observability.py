"""Port vs reference: the metrics registry, the step-time probe, the engine's telemetry.

Counterparts of ``tests/test_observability.py``'s metrics, probe and
engine-wiring tests on the port, plus two that close the loop:

  * parity: the reference's engine and the port's, given the same
    deterministic ``pod_time_hook`` and the same requests at reduced
    internlm2-1.8b, derive the same sequence of slot budgets and the same
    rebalance count (``core/schedule.py`` is a copy; the measured times
    are the only input that moves it), and the same scheduler rates
    exactly;
  * the calibration loop closes: a probe whose measured times contradict
    the typed 4:1 ratio drives the scheduler past its hysteresis and a
    rebalance, visible in the trace.

The probe is inert while observability is off, and an untraced engine
records nothing (its rates stay the typed ones).  No tolerances: these
are structural and exact checks.
"""

import json
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.asymmetric import AsymmetricMesh as JMesh
from repro.core.asymmetric import biglittle_classes as jax_classes
from repro.models import model_zoo as JZ
from repro.runtime.serving import ServingEngine as JaxEngine

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes
from repro_torch.launch import serve
from repro_torch.observability import metrics as MET
from repro_torch.observability import report
from repro_torch.observability import trace as T
from repro_torch.observability.probe import StepTimeProbe
from repro_torch.runtime.serving import ServingEngine

torch.set_num_threads(1)

ARCH = "internlm2-1.8b"


@pytest.fixture(autouse=True)
def _trace_off():
    T.disable()
    yield
    T.disable()


def _biglittle(**kw):
    kw.setdefault("strategy", "ca-das")
    kw.setdefault("batch_tile", 1)
    return AsymmetricMesh(biglittle_classes(chips_per_pod=1), **kw)


@pytest.fixture(scope="module")
def small_model():
    jcfg = jax_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jparams = JZ.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def _engine(cfg, params, asym=None, **kw):
    kw.setdefault("seq_cap", 24)
    kw.setdefault("slots_per_pod", 4)
    return ServingEngine(cfg, params, asym or _biglittle(), device="cpu", **kw)


# ---------------------------------------------------------------------------
# Metrics registry (the port's copy)
# ---------------------------------------------------------------------------


class TestMetrics:
    def test_counter_gauge_histogram_basics(self):
        reg = MET.MetricsRegistry()
        c = reg.counter("req_total", "requests")
        c.inc()
        c.inc(2.5)
        with pytest.raises(ValueError):
            c.inc(-1)
        g = reg.gauge("depth", "queue depth")
        g.set(4)
        g.inc()
        g.dec(2)
        h = reg.histogram("lat_seconds", buckets=(0.01, 0.1, 1.0))
        for v in (0.005, 0.05, 0.5, 5.0):
            h.observe(v)
        snap = reg.snapshot()
        assert snap["req_total"]["samples"][0]["value"] == 3.5
        assert snap["depth"]["samples"][0]["value"] == 3.0
        hs = snap["lat_seconds"]["samples"][0]
        assert hs["count"] == 4 and hs["sum"] == pytest.approx(5.555)
        assert hs["buckets"] == {"0.01": 1, "0.1": 2, "1": 3, "+Inf": 4}
        json.dumps(snap)

    def test_label_validation_and_children(self):
        reg = MET.MetricsRegistry()
        fam = reg.counter("adm_total", labels=("device_class",))
        fam.labels(device_class="big").inc(2)
        assert fam.labels(device_class="big") is fam.labels(device_class="big")
        with pytest.raises(ValueError):
            fam.labels(wrong="x")
        with pytest.raises(ValueError):
            fam.inc()
        with pytest.raises(ValueError):
            reg.counter("bad name")
        with pytest.raises(ValueError):
            reg.counter("ok", labels=("bad-label",))

    def test_idempotent_reregistration_and_mismatch(self):
        reg = MET.MetricsRegistry()
        a = reg.counter("x_total", "help", labels=("k",))
        assert reg.counter("x_total", "other help", labels=("k",)) is a
        with pytest.raises(ValueError):
            reg.gauge("x_total")
        with pytest.raises(ValueError):
            reg.counter("x_total", labels=("other",))

    def test_prometheus_exposition_format(self):
        reg = MET.MetricsRegistry()
        reg.counter("req_total", "requests served", labels=("cls",)).labels(cls='wei"rd\\v').inc(3)
        h = reg.histogram("step_seconds", "step time", buckets=(0.5,))
        h.observe(0.25)
        h.observe(2.0)
        lines = reg.exposition().splitlines()
        assert "# TYPE req_total counter" in lines
        assert 'req_total{cls="wei\\"rd\\\\v"} 3' in lines
        assert 'step_seconds_bucket{le="0.5"} 1' in lines
        assert 'step_seconds_bucket{le="+Inf"} 2' in lines
        assert "step_seconds_sum 2.25" in lines and "step_seconds_count 2" in lines


# ---------------------------------------------------------------------------
# Step-time probe: inert when off, measured per-pod times when on
# ---------------------------------------------------------------------------


class TestStepTimeProbe:
    def test_inert_while_observability_disabled(self):
        probe = StepTimeProbe(_biglittle(), device="cpu")
        assert not probe.active()
        assert probe(0, [1, 1]) is None
        assert probe.refreshes == 0

    def test_measured_times_scale_with_units(self):
        asym = _biglittle()
        probe = StepTimeProbe(
            asym, interval=64, reps=1, probe_shape=(100, 128, 128), always=True, device="cpu",
            workloads={"big": lambda: time.sleep(0.002), "little": lambda: time.sleep(0.008)},
        )
        times = probe(0, [4, 2])
        assert probe.refreshes == 1 and len(times) == asym.n_pods
        rs_big = probe.last_measured["big"] / 100
        rs_little = probe.last_measured["little"] / 100
        assert times[0] == pytest.approx(4 * rs_big)
        assert times[1] == pytest.approx(2 * rs_little)
        assert rs_little > rs_big
        assert probe(1, [0, 3])[0] == 0.0
        assert probe.refreshes == 1
        probe(64, [1, 1])
        assert probe.refreshes == 2
        classes = {s["labels"]["device_class"]
                   for s in MET.REGISTRY.snapshot()["probe_row_seconds"]["samples"]}
        assert {"big", "little"} <= classes

    def test_default_unit_charge_is_one_per_pod(self):
        probe = StepTimeProbe(_biglittle(), reps=1, always=True, device="cpu",
                              workloads={"big": lambda: None, "little": lambda: None})
        times = probe(0)
        assert len(times) == 2 and all(t >= 0.0 for t in times)

    def test_default_workload_runs_each_class_tree_in_bf16(self):
        probe = StepTimeProbe(_biglittle(), reps=1, always=True, device="cpu",
                              probe_shape=(16, 64, 64))
        rows = probe.refresh()
        assert len(rows) == 2 and all(r > 0 for r in rows)
        a, b = probe._operands
        assert a.dtype == b.dtype == torch.bfloat16 and a.device.type == "cpu"
        assert set(probe.last_measured) == {"big", "little"}


# ---------------------------------------------------------------------------
# Engine wiring: traced run emits class-tagged spans + metric families
# ---------------------------------------------------------------------------


class TestEngineTelemetry:
    def test_snapshot_is_the_reporting_surface(self, small_model):
        *_, cfg, params = small_model
        eng = _engine(cfg, params, pod_time_hook=None)
        snap = eng.stats.snapshot()
        json.dumps(snap)
        import dataclasses as dc

        assert set(snap) == {f.name for f in dc.fields(eng.stats)} | {
            "tokens_per_s", "tokens_per_j", "modeled_tokens_per_s"}

    @pytest.mark.parametrize("paged", ["off", "on"])
    def test_traced_generate_emits_spans_and_metrics(self, small_model, paged):
        *_, cfg, params = small_model
        eng = _engine(cfg, params, pod_time_hook=None, paged=paged)
        prompts = np.random.default_rng(3).integers(0, cfg.vocab, (4, 4)).astype(np.int32)
        adm0 = sum(s["value"] for s in MET.REGISTRY.snapshot()
                   .get("engine_admissions_total", {"samples": []})["samples"])
        T.enable()
        try:
            eng.generate(prompts, 4)
        finally:
            buf = T.disable()
        names = [e.name for e in buf.events]
        assert "engine.prefill" in names
        assert names.count("engine.decode_step") >= 3
        shards = [e for e in buf.events if e.name == "engine.decode_shard"]
        assert len(shards) == names.count("engine.decode_step")
        tags = shards[0].args
        assert tags["device_class"] == "big" and tags["backend"] == "matmul"
        assert tags["block_source"] == "analytical"
        snap = MET.REGISTRY.snapshot()
        for key in ("engine_queue_depth", "engine_slot_occupancy", "engine_admissions_total",
                    "engine_tokens_total", "engine_decode_step_seconds", "engine_tokens_per_s"):
            assert key in snap, key
        assert sum(s["value"] for s in snap["engine_admissions_total"]["samples"]) - adm0 == 4
        if paged == "on":
            assert "engine.page_alloc" in names and "engine.page_free" in names
            assert "engine_page_allocs_total" in snap and "engine_kv_pool_pages_live" in snap

    def test_untraced_generate_records_nothing(self, small_model):
        *_, cfg, params = small_model
        eng = _engine(cfg, params)  # the default "auto" probe, tracing off
        out = eng.generate(np.random.default_rng(4).integers(0, cfg.vocab, (4, 4)).astype(np.int32), 4)
        assert out.shape == (4, 8)
        assert not T.enabled()
        assert isinstance(eng.pod_time_hook, StepTimeProbe)
        assert eng.pod_time_hook.refreshes == 0
        assert eng.pod_time_hook.probe_shape == (128, cfg.d_model, cfg.d_model)
        rates = eng.asym.scheduler.rates
        assert rates[0] == pytest.approx(1.0) and rates[1] == pytest.approx(0.25)

    def test_tracing_leaves_the_tokens_unchanged(self, small_model):
        *_, cfg, params = small_model
        prompts = np.random.default_rng(6).integers(0, cfg.vocab, (6, 5)).astype(np.int32)
        want = _engine(cfg, params).generate(prompts, 5)
        T.enable()
        try:
            got = _engine(cfg, params).generate(prompts, 5)  # the default probe measures
        finally:
            T.disable()
        assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# Parity with the reference: same hook, same requests -> same budgets
# ---------------------------------------------------------------------------


def _budget_log(eng) -> list:
    log = []
    orig = eng._refresh_budgets

    def logged():
        orig()
        log.append(list(eng.budgets))

    eng._refresh_budgets = logged
    return log


def _skewed_hook(step, units):
    """Deterministic per-pod seconds: little measures 3x faster a row."""

    return [u * 3e-3 for u in units[:1]] + [u * 1e-3 for u in units[1:]]


def test_budgets_and_rebalances_equal_the_reference_engine(small_model):
    jcfg, jparams, cfg, params = small_model
    jasym = JMesh(jax_classes(chips_per_pod=1), strategy="ca-das", batch_tile=1)
    asym = _biglittle()
    jeng = JaxEngine(jcfg, jparams, jasym, seq_cap=24, slots_per_pod=6, class_sharded="off",
                     pod_time_hook=_skewed_hook)
    eng = _engine(cfg, params, asym, slots_per_pod=6, pod_time_hook=_skewed_hook)
    jlog, log = _budget_log(jeng), _budget_log(eng)
    rng = np.random.default_rng(8)
    for batch, gen in ((8, 3), (8, 4), (5, 2), (8, 3), (8, 2)):
        prompts = rng.integers(0, cfg.vocab, (batch, 4)).astype(np.int32)
        jeng.generate(prompts, gen)
        eng.generate(prompts, gen)
        assert log == jlog
        assert list(asym.scheduler.rates) == list(jasym.scheduler.rates)
    assert eng.stats.rebalances == jeng.stats.rebalances >= 1
    assert asym.scheduler.rebalances == jasym.scheduler.rebalances
    placed = lambda e: sorted((c.rid, c.slot, c.pod, c.device_class) for c in e.completions)  # noqa: E731
    assert placed(eng) == placed(jeng)


# ---------------------------------------------------------------------------
# The loop closes: measured probe times drive a real rebalance
# ---------------------------------------------------------------------------


def test_measured_times_trigger_rebalance(small_model):
    *_, cfg, params = small_model
    asym = _biglittle()  # typed init: rates [1.0, 0.25]
    probe = StepTimeProbe(
        asym, interval=4, reps=1, probe_shape=(100, 128, 128), always=True, device="cpu",
        workloads={"big": lambda: time.sleep(0.004), "little": lambda: time.sleep(0.001)},
    )
    eng = _engine(cfg, params, asym, slots_per_pod=8, pod_time_hook=probe)
    prompts = np.random.default_rng(5).integers(0, cfg.vocab, (8, 4)).astype(np.int32)
    T.enable()
    try:
        eng.generate(prompts, 4)
        sched = asym.scheduler
        assert probe.refreshes >= 1
        assert sched.rates[1] > sched.rates[0]
        assert sched.needs_rebalance()
        before = list(sched._last_sizes)
        eng.generate(prompts, 4)
    finally:
        buf = T.disable()
    after = list(asym.scheduler._last_sizes)
    assert eng.stats.rebalances >= 1
    assert after != before and after[1] > before[1]
    rebs = [e for e in buf.events if e.name == "scheduler.rebalance"]
    assert rebs
    ev = rebs[0].args
    assert ev["drift"] > ev["threshold"]
    assert ev["before"] == before and sum(ev["after"]) == sum(before)
    assert any(e.name == "probe.measured" for e in buf.events)
    assert any(e.name == "engine.rebalance" for e in buf.events)
    assert MET.REGISTRY.snapshot()["engine_rebalances_total"]["samples"][0]["value"] >= 1


# ---------------------------------------------------------------------------
# The tuner's telemetry and the serve CLI's --trace / --metrics
# ---------------------------------------------------------------------------


def test_search_emits_span_and_candidate_timings():
    from repro_torch.core.blocking import H100
    from repro_torch.tuning.tune import _obs_metrics, tune_shapes

    misses0 = _obs_metrics()["cache"].labels(result="miss").value
    T.enable()
    try:
        (res,) = tune_shapes([(512, 512, 512)], spec=H100, backend_name="cost-model")
    finally:
        buf = T.disable()
    search = {e.name: e for e in buf.events}["tuning.search_shape"]
    assert search.args["n_candidates"] == res.n_candidates
    assert search.args["best"] == [res.best.bm, res.best.bk, res.best.bn]
    cands = [e for e in buf.events if e.name == "tuning.candidate"]
    assert len(cands) == res.n_candidates
    assert all(e.parent == search.id and e.parent_name == "tuning.search_shape" for e in cands)
    assert MET.REGISTRY.snapshot()["tuning_candidate_seconds"]["samples"][0]["count"] >= len(cands)
    assert _obs_metrics()["cache"].labels(result="miss").value == misses0 + 1


def test_serve_cli_writes_trace_and_metrics(tmp_path, capsys):
    trace, metrics = str(tmp_path / "t.json"), str(tmp_path / "m.json")
    summary = serve.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--batch", "4",
                          "--prompt-len", "4", "--gen-len", "4", "--trace", trace,
                          "--metrics", metrics])
    assert summary["trace"] == trace and summary["metrics"] == metrics
    assert summary["objective"] == "perf"
    assert not T.enabled()
    snap = json.loads(open(metrics).read())
    assert snap["probe_refreshes_total"]["samples"][0]["value"] >= 1
    assert {s["labels"]["device_class"] for s in snap["probe_row_seconds"]["samples"]} >= {"big", "little"}
    capsys.readouterr()
    assert report.main([trace]) == 0
    text = capsys.readouterr().out
    assert "engine.decode_step" in text and "probe.refresh" in text and "probe.measured" in text
