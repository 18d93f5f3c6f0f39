"""Port vs reference: the tuner, the simulator, the metrics registry, the report.

The framework-neutral copies (``core/simulator.py``,
``observability/metrics.py``, ``observability/report.py``) differ from the
reference's only in their import lines, and give *equal* results on equal
inputs: the simulator's results, Prometheus exposition and ``snapshot()``
strings, and ``summarize`` text are compared exactly.  The tuner itself
is rebuilt for Hopper, so its tests are the reference's
(``tests/test_tuning.py``, ``tests/test_simulator.py``) adapted to the
Hopper specs and the CUDA kernels' compiled tile shapes; the calibration
from measurements is compared exactly, and ``gemm_with_tree`` against the
reference's on the same numpy operands at fp32 1e-4 relative and bf16
2e-2 (the tolerances of ``tests/test_torch_paged.py``).
"""

import dataclasses
import json
import logging
import os
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blocking as JB
from repro.core import control_tree as JCT
from repro.core import simulator as jsim
from repro.kernels import ops as jops
from repro.observability import metrics as JMET
from repro.observability import report as jreport
from repro.tuning import cache as JC
from repro.tuning import ratio as JR
from repro.tuning import tune as JT

from repro_torch.core import blocking as B
from repro_torch.core import control_tree as CT
from repro_torch.core import execution as X
from repro_torch.core import simulator as sim
from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes
from repro_torch.kernels import gemm as G
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.observability import metrics as MET
from repro_torch.observability import report
from repro_torch.observability import trace as TR
from repro_torch.tuning import cache as C
from repro_torch.tuning import candidates as CAND
from repro_torch.tuning import measure as M
from repro_torch.tuning import ratio as R
from repro_torch.tuning import tune as T

ROOT = pathlib.Path(__file__).resolve().parents[1]
LITTLE = B.H100_LITTLE
SHAPES = [(256, 256, 256), (512, 512, 512), (300, 1100, 200), (12, 2048, 8192)]
R_BIG = 6144  # paper's largest problem size regime


@pytest.fixture(autouse=True)
def _no_cache_env(monkeypatch):
    """Every test starts without a tuning cache in either package."""

    for var in (C.ENV_VAR, C.ENV_SPEC_VAR, JC.ENV_VAR, JC.ENV_SPEC_VAR):
        monkeypatch.delenv(var, raising=False)


# ---------------------------------------------------------------------------
# The copies: only import lines differ, and results are equal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rel", ["core/simulator.py", "observability/metrics.py",
                                 "observability/report.py"])
def test_copies_differ_only_in_import_lines(rel):
    theirs = (ROOT / "src" / "repro" / rel).read_text().splitlines()
    ours = (ROOT / "src" / "repro_torch" / rel).read_text().splitlines()
    assert len(theirs) == len(ours)
    for a, b in zip(theirs, ours):
        if a != b:
            assert a.startswith(("from repro.", "import repro")), a
            assert b == a.replace("repro.", "repro_torch.", 1), (a, b)


@pytest.mark.parametrize("r", [512, 2048, R_BIG])
@pytest.mark.parametrize("cache_aware", [False, True])
def test_simulator_equals_the_reference(r, cache_aware):
    for fine in ("loop4", "loop5"):
        for ratio in (1.0, 3.0, 5.0, None):
            kw = dict(cache_aware=cache_aware, fine=fine)
            if ratio is not None:
                kw["ratio"] = ratio
            assert dataclasses.asdict(sim.simulate_static(r, **kw)) == dataclasses.asdict(
                jsim.simulate_static(r, **kw))
        assert dataclasses.asdict(sim.simulate_dynamic(r, cache_aware=cache_aware, fine=fine)) == \
            dataclasses.asdict(jsim.simulate_dynamic(r, cache_aware=cache_aware, fine=fine))
    got = [dataclasses.asdict(x) for x in sim.sweep_ratio(r, ratios=range(1, 8), cache_aware=cache_aware)]
    want = [dataclasses.asdict(x) for x in jsim.sweep_ratio(r, ratios=range(1, 8), cache_aware=cache_aware)]
    assert got == want
    best, res = R.sweep_ratio_knob(r, cache_aware=cache_aware)
    jbest, jres = JR.sweep_ratio_knob(r, cache_aware=cache_aware)
    assert best == jbest
    assert [dataclasses.asdict(x) for x in res] == [dataclasses.asdict(x) for x in jres]


def _drive_registry(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("req_total", "requests served", labels=("cls",))
    c.labels(cls='wei"rd\\v').inc(3)
    c.labels(cls="big").inc(0.5)
    g = reg.gauge("depth", "queue depth")
    g.set(4)
    g.inc()
    g.dec(2)
    h = reg.histogram("step_seconds", "step time", buckets=(0.01, 0.5, 1.0))
    rng = np.random.default_rng(0)
    for v in rng.exponential(0.3, size=40):
        h.observe(float(v))
    return reg


def test_metrics_exposition_and_snapshot_equal_the_reference():
    ours, theirs = _drive_registry(MET), _drive_registry(JMET)
    assert ours.exposition() == theirs.exposition()
    assert json.dumps(ours.snapshot(), sort_keys=True) == json.dumps(theirs.snapshot(), sort_keys=True)


def test_report_summarize_equals_the_reference(tmp_path):
    TR.enable()
    try:
        for i in range(3):
            with TR.span("engine.decode_step", cat="engine", step=i):
                with TR.span("engine.decode_shard", cat="engine", device_class="big"):
                    pass
            TR.instant("engine.page_alloc", cat="engine", slot=i, pages=2, pages_live=2 * (i + 1),
                       pages_free=10 - 2 * (i + 1))
        TR.instant("engine.page_free", cat="engine", slot=0, pages=2, stop="eos", pages_live=4,
                   pages_free=6)
    finally:
        buf = TR.disable()
    path = str(tmp_path / "t.json")
    buf.save(path)
    events, meta = report.load_events(path)
    jevents, jmeta = jreport.load_events(path)
    assert events == jevents and meta == jmeta
    assert report.summarize(events) == jreport.summarize(jevents)
    assert report.kv_pool_rollup(events) == jreport.kv_pool_rollup(jevents)


# ---------------------------------------------------------------------------
# The simulator's own claims (tests/test_simulator.py, on the port's copy)
# ---------------------------------------------------------------------------


class TestSingleCluster:
    def test_a15_peak(self):
        assert sim.simulate_single_cluster(R_BIG, sim.A15, 4).gflops == pytest.approx(9.6, rel=0.06)

    def test_a7_peak(self):
        assert sim.simulate_single_cluster(R_BIG, sim.A7, 4).gflops == pytest.approx(2.4, rel=0.06)

    def test_a15_over_a7_about_4x(self):
        a15 = sim.simulate_single_cluster(R_BIG, sim.A15, 4).gflops
        a7 = sim.simulate_single_cluster(R_BIG, sim.A7, 4).gflops
        assert 3.3 < a15 / a7 < 4.7

    def test_three_a15_cores_most_energy_efficient(self):
        eff = [sim.simulate_single_cluster(R_BIG, sim.A15, n).gflops_per_w for n in (1, 2, 3, 4)]
        assert int(np.argmax(eff)) == 2

    def test_4xa7_more_efficient_than_1xa15(self):
        a7 = sim.simulate_single_cluster(R_BIG, sim.A7, 4)
        a15 = sim.simulate_single_cluster(R_BIG, sim.A15, 1)
        assert a7.gflops_per_w > a15.gflops_per_w * 1.1
        assert a7.gflops < a15.gflops


class TestSSS:
    def test_sss_is_40pct_of_a15(self):
        sss = sim.simulate_static(R_BIG).gflops
        a15 = sim.simulate_single_cluster(R_BIG, sim.A15, 4).gflops
        assert sss / a15 == pytest.approx(0.40, abs=0.05)

    def test_sss_worst_energy(self):
        sss = sim.simulate_static(R_BIG).gflops_per_w
        others = [
            sim.simulate_single_cluster(R_BIG, sim.A15, 4).gflops_per_w,
            sim.simulate_single_cluster(R_BIG, sim.A7, 4).gflops_per_w,
            sim.simulate_static(R_BIG, ratio=5).gflops_per_w,
            sim.simulate_dynamic(R_BIG).gflops_per_w,
        ]
        assert all(sss < o for o in others)


class TestSAS:
    def test_optimum_ratio_5_to_6(self):
        results = sim.sweep_ratio(R_BIG, ratios=range(1, 8))
        assert int(np.argmax([r.gflops for r in results])) + 1 in (5, 6)

    def test_sas_beats_a15_by_20pct(self):
        best = max(r.gflops for r in sim.sweep_ratio(R_BIG, ratios=range(1, 8)))
        a15 = sim.simulate_single_cluster(R_BIG, sim.A15, 4).gflops
        assert best / a15 == pytest.approx(1.20, abs=0.07)

    def test_small_problems_worse(self):
        assert sim.simulate_static(512, ratio=5).gflops < sim.simulate_static(R_BIG, ratio=5).gflops

    def test_close_to_ideal(self):
        best = max(r.gflops for r in sim.sweep_ratio(R_BIG, ratios=range(1, 8)))
        assert best > 0.9 * sim.ideal_gflops(R_BIG)


class TestCASAS:
    def test_ca_helps_only_below_ratio_5(self):
        for ratio in (1, 3):
            ca = sim.simulate_static(R_BIG, ratio=ratio, cache_aware=True).gflops
            assert ca > sim.simulate_static(R_BIG, ratio=ratio).gflops * 1.05
        for ratio in (5, 6):
            ca = sim.simulate_static(R_BIG, ratio=ratio, cache_aware=True).gflops
            assert ca == pytest.approx(sim.simulate_static(R_BIG, ratio=ratio).gflops, rel=0.03)

    def test_loop4_beats_loop5(self):
        l4 = sim.simulate_static(R_BIG, ratio=5, cache_aware=True, fine="loop4").gflops
        l5 = sim.simulate_static(R_BIG, ratio=5, cache_aware=True, fine="loop5").gflops
        assert l4 > l5


class TestCADAS:
    def test_cadas_beats_das(self):
        cadas = sim.simulate_dynamic(R_BIG, cache_aware=True).gflops
        assert cadas > sim.simulate_dynamic(R_BIG, cache_aware=False).gflops * 1.05

    def test_cadas_at_least_best_static_chosen_ratio(self):
        cadas = sim.simulate_dynamic(R_BIG, cache_aware=True).gflops
        assert cadas >= sim.simulate_static(R_BIG, ratio=5, cache_aware=True).gflops * 0.97

    def test_loop4_beats_loop5_dynamic(self):
        assert sim.simulate_dynamic(R_BIG, fine="loop4").gflops > \
            sim.simulate_dynamic(R_BIG, fine="loop5").gflops


# ---------------------------------------------------------------------------
# Candidates: launchable, feasible under their ring, analytical included
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("spec_name", sorted(CAND.SPECS))
def test_candidates_feasible_and_launchable(shape, spec_name):
    m, k, n = shape
    spec = CAND.get_spec(spec_name)
    for backend in CAND.KERNEL_BACKENDS:
        stages = X.backend_stages(backend)
        cands = CAND.enumerate_candidates(m, k, n, spec=spec, stages=stages)
        assert cands, "candidate set must be non-empty"
        for cfg in cands:
            assert cfg.fits(spec, stages=X.min_stages(stages)), (backend, cfg)
            assert cfg.bm in B.BM_TILES and cfg.bn in B.BN_TILES
            assert cfg.bk % B.BK_ALIGN == 0 and 0 < cfg.bk <= B.MAX_BK
            G.validate_block_config(m, k, n, cfg)  # never larger than the padded problem


@pytest.mark.parametrize("shape", SHAPES)
def test_candidates_include_analytical(shape):
    m, k, n = shape
    cands = CAND.enumerate_candidates(m, k, n)
    assert cands[0] == CAND.analytical_config(m, k, n) == B.derive_block_config(m, k, n)
    assert len({(c.bm, c.bk, c.bn) for c in cands}) == len(cands), "deduplicated"


def test_specs_are_the_classes_specs():
    classes = {c.name: c.spec for c in biglittle_classes()}
    assert CAND.SPECS["h100"] is classes["big"] is B.hopper_spec()
    assert CAND.SPECS["h100-little"] is classes["little"] is B.hopper_spec(little=True)
    assert sorted(CAND.SPECS) == ["h100", "h100-little"]
    with pytest.raises(KeyError, match="unknown core spec"):
        CAND.get_spec("tpu-v5e")


def test_neighborhood_feasible():
    seed = CAND.analytical_config(512, 512, 512)
    nbrs = CAND.neighborhood(seed, shape=(512, 512, 512))
    assert nbrs and seed not in nbrs
    for cfg in nbrs:
        assert cfg.fits(B.H100, stages=B.MIN_PIPELINE_STAGES)
        assert CAND.launchable(cfg, 512, 512, 512)
        assert sum(getattr(cfg, d) != getattr(seed, d) for d in ("bm", "bk", "bn")) == 1


# ---------------------------------------------------------------------------
# Cost model: deterministic, charges padding, waves and steps
# ---------------------------------------------------------------------------


def test_cost_model_deterministic_and_positive():
    cfg = B.BlockConfig(bm=128, bk=64, bn=128)
    assert M.cost_model_time(512, 512, 512, cfg) == M.cost_model_time(512, 512, 512, cfg) > 0.0


def test_cost_model_charges_padding():
    # One row past a multiple of bm costs what a whole extra block row does.
    cfg = B.BlockConfig(bm=128, bk=64, bn=256)
    exact = M.cost_model_time(128 * 132, 1024, 256, cfg)
    assert M.cost_model_time(128 * 132 + 1, 1024, 256, cfg) == M.cost_model_time(128 * 133, 1024, 256, cfg)
    assert M.cost_model_time(128 * 132 + 1, 1024, 256, cfg) > exact
    assert M.cost_breakdown(100, 64, 64, B.BlockConfig(64, 64, 64)).flops == 2.0 * 128 * 64 * 64


def test_cost_model_charges_waves():
    # M = 12, N = 2048: bn = 32 fills 64 SMs, bn = 256 only 8, so each CTA
    # streams 8x the weight bytes with a 1/132 share of the bandwidth.
    narrow = M.cost_breakdown(12, 2048, 2048, B.BlockConfig(64, 256, 32))
    wide = M.cost_breakdown(12, 2048, 2048, B.BlockConfig(64, 256, 256))
    assert (narrow.grid, wide.grid) == ((1, 64, 8), (1, 8, 8))
    assert narrow.waves == wide.waves == 1
    assert wide.time_s > 4 * narrow.time_s
    # Past one wave the grid runs in ceil(CTAs / n_sm) waves.
    assert M.cost_breakdown(12, 2048, 8192, B.BlockConfig(64, 256, 32)).waves == 2


def test_cost_model_charges_grid_overhead():
    tiny = B.BlockConfig(bm=64, bk=64, bn=32)
    large = B.BlockConfig(bm=128, bk=64, bn=256)
    t, g = M.cost_breakdown(2048, 2048, 2048, tiny), M.cost_breakdown(2048, 2048, 2048, large)
    assert t.overhead_s > g.overhead_s
    assert t.time_s > g.time_s


@pytest.mark.parametrize("shape", SHAPES)
def test_search_no_worse_than_analytical(shape):
    res = T.search_shape(*shape, spec=B.H100, dtype_bytes=2, backend=M.make_backend("cost-model"),
                         kernel_backends=CAND.KERNEL_BACKENDS)
    assert res.best_time_s <= res.analytical_time_s
    assert res.speedup >= 1.0
    assert res.analytical == B.derive_block_config(*shape)


# ---------------------------------------------------------------------------
# Cache: roundtrip, version invalidation, atomicity, fallback
# ---------------------------------------------------------------------------


def test_cache_roundtrip(tmp_path):
    path = str(tmp_path / "cache.json")
    cache = C.TuningCache(path=path)
    cfg = B.BlockConfig(bm=128, bk=128, bn=256)
    cache.put("h100", "bfloat16", 512, 512, 512, cfg, backend="cuda", time_s=1e-3)  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    cache.save()
    loaded = C.TuningCache.load(path)
    assert loaded.get("h100", "bfloat16", 512, 512, 512) == cfg
    # Buckets are the 16-aligned dims the kernels' blocks are clamped to.
    assert loaded.get("h100", "bfloat16", 500, 510, 497) == cfg
    assert loaded.get("h100", "bfloat16", 496, 512, 512) is None
    assert C.shape_bucket_key("h100", "bfloat16", 12, 2048, 92544) == "h100/bfloat16/16x2048x92544"
    assert loaded.get("h100", "float32", 512, 512, 512) is None
    assert loaded.get("h100-little", "bfloat16", 512, 512, 512) is None


def test_cache_version_mismatch_invalidates(tmp_path):
    path = str(tmp_path / "cache.json")
    with open(path, "w") as f:
        json.dump({"version": C.CACHE_VERSION + 1,
                   "entries": {"h100/bfloat16/512x512x512": {"bm": 64, "bk": 64, "bn": 64}}}, f)
    loaded = C.TuningCache.load(path)
    assert loaded.entries == {}
    cfg, hit = loaded.lookup_or_analytical(512, 512, 512)
    assert not hit and cfg == B.derive_block_config(512, 512, 512)


def test_cache_corrupt_file_starts_empty(tmp_path):
    path = tmp_path / "cache.json"
    path.write_text("{not json")
    assert C.TuningCache.load(str(path)).entries == {}


def test_cache_non_object_json_starts_empty(tmp_path):
    path = tmp_path / "cache.json"
    path.write_text(json.dumps([{"bench": "gemm"}]))
    assert C.TuningCache.load(str(path)).entries == {}


def test_cache_malformed_entry_is_a_miss(tmp_path, monkeypatch):
    path = str(tmp_path / "cache.json")
    key = C.shape_bucket_key("h100", "float32", 256, 256, 256)
    with open(path, "w") as f:
        json.dump({"version": C.CACHE_VERSION, "entries": {key: {"oops": 1}}}, f)
    assert C.TuningCache.load(path).get("h100", "float32", 256, 256, 256) is None
    monkeypatch.setenv(C.ENV_VAR, path)
    cfg = G.resolve_block_config(256, 256, 256, torch.float32)
    assert cfg == B.derive_block_config(256, 256, 256, dtype_bytes=4)


def test_cache_atomic_write_leaves_no_temp(tmp_path):
    path = str(tmp_path / "cache.json")
    cache = C.TuningCache(path=path)
    cache.put("h100", "bfloat16", 128, 128, 128, B.BlockConfig(64, 64, 64))
    cache.save()
    assert [p for p in os.listdir(tmp_path) if p.startswith(".tuning-cache-")] == []
    assert json.load(open(path))["version"] == C.CACHE_VERSION


def test_each_package_reads_only_its_own_cache(tmp_path, monkeypatch):
    """The port and the reference share test processes: a Hopper cache
    must not reach the TPU kernels, nor a TPU cache the CUDA ones."""

    path = str(tmp_path / "cache.json")
    cache = C.TuningCache(path=path)
    cache.put("h100", "bfloat16", 256, 256, 256, B.BlockConfig(64, 128, 32), backend="cuda")  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    cache.put("tpu-v5e", "bfloat16", 256, 256, 256, B.BlockConfig(128, 128, 128), backend="pallas")  # repro_torch: noqa=RPR005 -- the reference's backend name (repro.core.execution.BACKENDS)
    cache.save()
    monkeypatch.setenv(JC.ENV_VAR, path)
    assert X.tuned_block_config(256, 256, 256) is None
    monkeypatch.delenv(JC.ENV_VAR)
    monkeypatch.setenv(C.ENV_VAR, path)
    assert JC.cached_block_config(256, 256, 256, "bfloat16", 2) is None
    assert X.tuned_block_config(256, 256, 256) == B.BlockConfig(64, 128, 32)


# ---------------------------------------------------------------------------
# tune CLI: search -> write -> second run hits the cache
# ---------------------------------------------------------------------------


def test_tune_cli_writes_cache_and_hits_on_rerun(tmp_path, caplog):
    path = str(tmp_path / "cache.json")
    argv = ["--spec", "h100", "--backend", "cost-model", "--shapes", "512x512x512,12x2048x2048",
            "--cache", path]
    summary = T.main(argv)
    assert os.path.exists(path)
    assert len(summary["shapes"]) == 2
    for rec in summary["shapes"]:
        assert not rec["cache_hit"] and rec["n_candidates"] > 0
        assert rec["best_time_s"] <= rec["analytical_time_s"]
    with caplog.at_level(logging.INFO, logger="repro_torch.tuning.tune"):
        summary2 = T.main(argv)
    assert all(rec["cache_hit"] for rec in summary2["shapes"])
    assert any("cache hit" in r.message for r in caplog.records)


def test_tune_cli_then_the_mesh_reports_tuned_trees(tmp_path, monkeypatch):
    path = str(tmp_path / "cache.json")
    T.main(["--spec", "h100", "--backend", "cost-model", "--shapes", "512x512x512", "--cache", path])
    monkeypatch.setenv(C.ENV_VAR, path)
    trees = AsymmetricMesh(biglittle_classes()).control_trees((512, 512, 512))
    assert trees["big"].block_source == "tuned"


def test_tune_cli_calibrate_ratios_with_wallclock_backend(tmp_path):
    path = str(tmp_path / "cache.json")
    summary = T.main(["--backend", "wallclock", "--device", "cpu", "--shapes", "64x64x64",
                      "--cache", path, "--max-candidates", "1", "--calibrate-ratios"])
    assert len(summary["init_ratios"]) == 2
    assert summary["init_ratios"][1] < 1.0


def test_tune_cli_wallclock_needs_the_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        T.main(["--backend", "wallclock", "--shapes", "64x64x64",
                "--cache", str(tmp_path / "c.json")])


def test_tune_cli_dry_run_writes_nothing(tmp_path):
    path = str(tmp_path / "cache.json")
    summary = T.main(["--backend", "cost-model", "--cache", path, "--dry-run"])
    assert summary["cache_path"] is None
    assert not os.path.exists(path)
    assert summary["shapes"], "dry run still searches the default shapes"


@pytest.mark.parametrize("text", ["512x512", "", ",", "1x2x3x4", "axbxc", "12x", "x12x12"])
def test_parse_shapes_rejects_the_references_garbage(text):
    with pytest.raises(ValueError):
        JT.parse_shapes(text)
    with pytest.raises(ValueError):
        T.parse_shapes(text)


def test_parse_shapes_agrees_with_the_reference():
    for text in ("512x512x512", "12x2048x2048, 4096X3072x1024", "1x1x1,"):
        assert T.parse_shapes(text) == JT.parse_shapes(text)


# ---------------------------------------------------------------------------
# Kernel integration: REPRO_TORCH_TUNING_CACHE drives cfg=None resolution
# ---------------------------------------------------------------------------


def _write_cache(tmp_path, cfg, m, k, n, dtype_name="float32", spec="h100", backend="test"):
    path = str(tmp_path / "cache.json")
    cache = C.TuningCache.load(path)
    cache.put(spec, dtype_name, m, k, n, cfg, backend=backend)
    cache.save(path)
    return path


def test_gemm_resolves_cached_config(tmp_path, monkeypatch):
    tuned = B.BlockConfig(bm=128, bk=192, bn=64, dtype_bytes=4)
    monkeypatch.setenv(C.ENV_VAR, _write_cache(tmp_path, tuned, 256, 256, 256))
    assert G.resolve_block_config(256, 256, 256, torch.float32) == tuned
    monkeypatch.delenv(C.ENV_VAR)
    assert G.resolve_block_config(256, 256, 256, torch.float32) == B.derive_block_config(
        256, 256, 256, dtype_bytes=4)


def test_gemm_with_cache_matches_oracle(tmp_path, monkeypatch):
    m = k = n = 256
    tuned = B.BlockConfig(bm=128, bk=128, bn=256, dtype_bytes=4)
    monkeypatch.setenv(C.ENV_VAR, _write_cache(tmp_path, tuned, m, k, n))
    rng = np.random.default_rng(7)
    a = torch.as_tensor(rng.normal(size=(m, k)), dtype=torch.float32)
    b = torch.as_tensor(rng.normal(size=(k, n)), dtype=torch.float32)
    out_cached = G.gemm_cuda(a, b)
    monkeypatch.delenv(C.ENV_VAR)
    torch.testing.assert_close(out_cached, ref.gemm_ref(a, b), rtol=1e-5, atol=1e-4)
    assert torch.equal(out_cached, G.gemm_cuda(a, b, tuned))


def test_cached_config_dtype_bytes_reconciled(tmp_path, monkeypatch):
    tuned = B.BlockConfig(bm=64, bk=128, bn=64, dtype_bytes=2)
    monkeypatch.setenv(C.ENV_VAR, _write_cache(tmp_path, tuned, 128, 128, 128))
    assert G.resolve_block_config(128, 128, 128, torch.float32).dtype_bytes == 4


# ---------------------------------------------------------------------------
# Ratio calibration: measured ratios replace hand-typed rel_throughput
# ---------------------------------------------------------------------------


def test_calibrate_biglittle_ratios():
    cal = R.calibrate_class_ratios(biglittle_classes(), backend="cost-model")
    assert cal.class_names == ("big", "little")
    assert cal.ratios[0] == 1.0
    # Half the peak and the bandwidth, not just half the shared memory.
    assert 0.0 < cal.ratios[1] < 0.6
    assert cal.knob() > 1.5


@pytest.mark.parametrize("chips", [1, 2])
def test_calibration_from_measurements_equals_the_reference(chips):
    from repro.core.asymmetric import biglittle_classes as jclasses

    recs = [("big", 128, 3.1e-5), ("little", 128, 4.7e-5)]
    got = R.calibrate_class_ratios(biglittle_classes(chips_per_pod=chips), backend="wallclock",
                                   measurements=[R.ClassMeasurement(*r) for r in recs])
    want = JR.calibrate_class_ratios(jclasses(chips_per_pod=chips), backend="wallclock",
                                     measurements=[JR.ClassMeasurement(*r) for r in recs])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(ValueError, match="missing classes"):
        R.calibrate_class_ratios(biglittle_classes(), measurements=[R.ClassMeasurement(*recs[0])])


def test_mesh_from_calibration():
    mesh = AsymmetricMesh.from_calibration(biglittle_classes(), strategy="ca-sas", batch_tile=8)
    assert mesh.calibration is not None
    assert mesh.classes[0].rel_throughput == 1.0
    assert mesh.classes[1].rel_throughput == pytest.approx(mesh.calibration.ratios[1])
    layout = mesh.batch_layout(256)
    assert sum(layout.sizes) == 256 and layout.sizes[0] > layout.sizes[1]


def test_mesh_from_calibration_explicit_calibration():
    cal = R.Calibration(class_names=("big", "little"), ratios=(1.0, 0.5),
                        probe_shape=(512, 512, 512), backend="cost-model", times_s=(1.0, 2.0))
    mesh = AsymmetricMesh.from_calibration(biglittle_classes(), cal, strategy="sas")
    assert mesh.classes[1].rel_throughput == 0.5
    with pytest.raises(ValueError, match="covers 2 classes"):
        AsymmetricMesh.from_calibration(biglittle_classes()[:1], cal)


def test_wallclock_calibration_rejects_heterogeneous_specs():
    with pytest.raises(ValueError, match="heterogeneous"):
        R.calibrate_class_ratios(biglittle_classes(), backend="wallclock")


def test_sweep_ratio_knob_prefers_asymmetric():
    best, results = R.sweep_ratio_knob(2048, ratios=(1, 2, 3, 4, 5, 6, 7))
    assert best > 1.0 and len(results) == 7


# ---------------------------------------------------------------------------
# The wall clock on the CPU: the plain versions; f32 refused on the card
# ---------------------------------------------------------------------------


def test_wallclock_backend_runs_small():
    cfg = B.BlockConfig(bm=64, bk=64, bn=64, dtype_bytes=4)
    assert M.wallclock_time(64, 64, 64, cfg, dtype=torch.float32, device="cpu", reps=1, warmup=0) > 0.0


def test_wallclock_times_the_lean_kernel_too():
    cfg = B.BlockConfig(bm=64, bk=64, bn=64)
    assert M.wallclock_time(64, 64, 64, cfg, device="cpu", reps=1, warmup=0,
                            kernel_backend="cuda_lean") > 0.0  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    for not_a_kernel in ("matmul", "torch_ref", "pallas"):
        with pytest.raises(ValueError, match="cannot time kernel backend"):
            M.wallclock_time(64, 64, 64, cfg, device="cpu", kernel_backend=not_a_kernel)


def test_wallclock_refuses_what_the_card_cannot_time():
    """f32 on the card is an error, not a fallback to another timer."""

    with pytest.raises(TypeError, match="bf16"):
        M.wallclock_time(64, 64, 64, B.BlockConfig(64, 64, 64, dtype_bytes=4), device="cuda")
    with pytest.raises(ValueError, match="cannot score objective"):
        M.make_backend("wallclock", objective="energy", device="cpu")


# ---------------------------------------------------------------------------
# Kernel variants as a search dimension (paper §5.3)
# ---------------------------------------------------------------------------

# A constrained, memory-bound class: 66,667 B of shared memory (60,000 for
# the ring) and thin HBM.  The pipelined ring holds 64 x 64 x 128 panels at
# most; the one-stage kernel holds 128 x 64 x 256, which halves the bytes a
# CTA streams per output, more than the lost overlap costs.
NANO = B.HopperClassSpec(name="h100-nano", smem_bytes=66_667, peak_flops=200e12, hbm_bw=50e9)


def test_kernel_candidates_widen_the_feasible_set():
    cands = CAND.enumerate_kernel_candidates(12, 2048, 8192, spec=LITTLE)
    by_backend = {}
    for c in cands:
        by_backend.setdefault(c.backend, []).append(c.cfg)
    assert set(by_backend) == {"cuda", "cuda_lean"}
    assert all(c.fits(LITTLE, stages=2) for c in by_backend["cuda"])
    assert all(c.fits(LITTLE, stages=1) for c in by_backend["cuda_lean"])
    assert [c for c in by_backend["cuda_lean"] if not c.fits(LITTLE, stages=2)]
    assert len({c.key for c in cands}) == len(cands)
    for not_a_kernel in ("mosaic", "matmul", "torch_ref", "torch_ref_lean", "pallas"):
        with pytest.raises(ValueError, match="unknown kernel backend"):
            CAND.enumerate_kernel_candidates(256, 256, 256, backends=[not_a_kernel])


def test_kernel_backends_derive_from_the_registry():
    assert CAND.KERNEL_BACKENDS == tuple(G.GEMM_KERNELS) == ("cuda", "cuda_lean")
    for name in G.GEMM_KERNELS:
        assert name in X.BACKENDS and X.plain_twin(name) in X.BACKENDS


def test_cost_model_serializes_lean_streams():
    cfg = B.BlockConfig(bm=128, bk=64, bn=128)
    pip = M.cost_breakdown(512, 512, 512, cfg, spec=NANO)
    lean = M.cost_breakdown(512, 512, 512, cfg, spec=NANO, kernel_backend="cuda_lean")  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    assert pip.compute_s == lean.compute_s and pip.memory_s == lean.memory_s
    assert pip.time_s == max(pip.compute_s, pip.memory_s) + pip.overhead_s
    assert lean.time_s == lean.compute_s + lean.memory_s + lean.overhead_s
    assert lean.time_s > pip.time_s


def test_search_picks_lean_when_panels_beat_overlap(tmp_path):
    cache = C.TuningCache(path=str(tmp_path / "cache.json"))
    shape = (4096, 4096, 4096)
    res = T.tune_shapes([shape], spec=NANO, backend_name="cost-model", cache=cache)[0]
    assert res.best_backend == "cuda_lean"  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    assert res.best_time_s < res.analytical_time_s
    assert not res.best.fits(NANO, stages=2) and res.best.fits(NANO, stages=1)
    entry = cache.entries[C.shape_bucket_key(NANO.name, "bfloat16", *shape)]
    assert entry["backend"] == "cuda_lean" and entry["measured_with"] == "cost-model"
    hit = T.tune_shapes([shape], spec=NANO, backend_name="cost-model", cache=cache)[0]
    assert hit.cache_hit and hit.best_backend == "cuda_lean"  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)


def test_single_variant_search_unchanged():
    calls = []

    def scorer(m, k, n, cfg):  # no kernel_backend kwarg: the one-variant contract
        calls.append(cfg)
        return M.cost_model_time(m, k, n, cfg, spec=NANO)

    res = T.search_shape(512, 512, 512, spec=NANO, dtype_bytes=2, backend=scorer,
                         kernel_backends=("cuda",))
    assert res.best_backend == "cuda"  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    assert calls and all(c.fits(NANO, stages=2) for c in calls)


def test_scorer_name_in_the_backend_field_is_no_variant(tmp_path, monkeypatch):
    cfg = B.BlockConfig(bm=64, bk=128, bn=64)
    monkeypatch.setenv(C.ENV_VAR, _write_cache(tmp_path, cfg, 512, 512, 512, "bfloat16",
                                               backend="cost-model"))
    assert C.cached_kernel_backend(512, 512, 512, "bfloat16", spec_name="h100") == "cost-model"
    assert X.tuned_kernel_backend(512, 512, 512, spec=B.H100) is None
    tree = CT.build_control_trees({"x": B.H100}, 512, 512, 512, backend="torch_ref")["x"]  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    assert tree.block_source == "tuned" and tree.block == cfg
    assert tree.backend == "torch_ref"  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)


def test_lean_recorded_entry_never_reaches_pipelined_consumers(tmp_path, monkeypatch):
    # One stage of this block fits the little class's shared memory, two do not.
    cfg = B.BlockConfig(bm=64, bk=128, bn=256)
    assert cfg.fits(LITTLE, stages=1) and not cfg.fits(LITTLE, stages=2)
    shape = (2048, 2048, 2048)
    monkeypatch.setenv(C.ENV_VAR, _write_cache(tmp_path, cfg, *shape, "bfloat16",
                                               spec=LITTLE.name, backend="cuda_lean"))  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    monkeypatch.setenv(C.ENV_SPEC_VAR, LITTLE.name)
    got, src = X.resolve_block_config(*shape, spec=LITTLE, stages=B.PIPELINE_STAGES)
    assert src == "analytical" and got.fits(LITTLE)
    got, src = X.resolve_block_config(*shape, spec=LITTLE, stages=1)
    assert src == "tuned" and got == cfg
    _, src = X.resolve_block_config(*shape, stages=B.PIPELINE_STAGES)  # spec from the env
    assert src == "analytical"
    # The per-call context path: a pipelined tree derives a block it can hold.
    tree = CT.ControlTree(device_class="little", block=B.derive_block_config(256, 256, 256, spec=LITTLE),
                          backend="torch_ref", spec=LITTLE, problem_shape=(256, 256, 256))  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    assert X.context_for_tree(tree).block_config(*shape, "bfloat16", 2).fits(LITTLE, stages=2)
    # ...while the tree-build path pairs the entry with the lean kernel.
    built = CT.build_control_trees({"little": LITTLE}, *shape, backend="torch_ref")["little"]  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    assert built.block_source == "tuned" and built.block == cfg
    assert built.backend == "torch_ref_lean"  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    # Recorded for the pipelined kernel, it still does not fit that ring.
    monkeypatch.setenv(C.ENV_VAR, _write_cache(tmp_path, cfg, *shape, "bfloat16",
                                               spec=LITTLE.name, backend="cuda"))  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    assert X.resolve_block_config(*shape, spec=LITTLE)[1] == "analytical"


def test_cache_aware_false_baseline_stays_uniform(tmp_path, monkeypatch):
    cfg = B.BlockConfig(bm=64, bk=128, bn=64)
    _write_cache(tmp_path, cfg, 512, 512, 512, "bfloat16", spec="h100", backend="cuda")  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    monkeypatch.setenv(C.ENV_VAR, _write_cache(tmp_path, cfg, 512, 512, 512, "bfloat16",
                                               spec=LITTLE.name, backend="cuda_lean"))  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    trees = CT.build_control_trees({"big": B.H100, "little": LITTLE}, 512, 512, 512,
                                   backend="cuda", cache_aware=False)  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    assert trees["little"].block == trees["big"].block
    assert trees["little"].backend == trees["big"].backend == "cuda"


def test_recorded_variant_reaches_the_tree(tmp_path, monkeypatch):
    cfg = B.BlockConfig(bm=64, bk=128, bn=64)
    monkeypatch.setenv(C.ENV_VAR, _write_cache(tmp_path, cfg, 512, 512, 512, "bfloat16",
                                               spec=LITTLE.name, backend="cuda_lean"))  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    build = lambda backend: CT.build_control_trees({"little": LITTLE}, 512, 512, 512,  # noqa: E731
                                                   backend=backend)["little"]
    assert build("torch_ref").block_source == "tuned"
    assert build("torch_ref").backend == "torch_ref_lean"
    assert build("cuda").backend == "cuda_lean"
    assert build("matmul").backend == "matmul"  # blocks are decorative there


def test_loop3_honours_a_tuned_entry_only_at_the_shared_bk(tmp_path, monkeypatch):
    shape = (512, 512, 512)
    base = B.derive_block_config(*shape)
    same = dataclasses.replace(base, bn=64)
    other = dataclasses.replace(base, bk=base.bk // 2)
    for entry, want in ((same, "tuned"), (other, "analytical")):
        monkeypatch.setenv(C.ENV_VAR, _write_cache(tmp_path, entry, *shape, "bfloat16",
                                                   spec=LITTLE.name, backend="cuda"))  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
        trees = CT.build_control_trees({"big": B.H100, "little": LITTLE}, *shape, backend="cuda")  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
        assert trees["big"].block_source == "analytical"
        assert trees["little"].block_source == want
        ctx = X.context_for_tree(trees["little"])
        assert ctx.block_config(*shape, "bfloat16", 2) == trees["little"].block


def test_same_bucket_is_the_caches_bucket():
    assert X._same_bucket((12, 2048, 2048), (16, 2048, 2048))
    assert not X._same_bucket((12, 2048, 2048), (17, 2048, 2048))
    assert C._bucket(12) == C._bucket(16) == 16 and C._bucket(17) == 32


# ---------------------------------------------------------------------------
# gemm_with_tree against the reference's on the same numpy operands
# ---------------------------------------------------------------------------

TOLS = {"float32": dict(rtol=1e-4, atol=1e-4), "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backends", [("matmul", "xla"), ("torch_ref", "pallas_interpret"),
                                      ("torch_ref_lean", "pallas_lean_interpret")])
def test_gemm_with_tree_matches_the_reference(dtype, backends):
    ours, theirs = backends
    m, k, n = 96, 320, 160
    rng = np.random.default_rng(11)
    a_np = rng.normal(size=(2, m // 2, k)).astype(np.float32)
    b_np = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    tdt, jdt = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    tree = CT.ControlTree(device_class="big", block=B.BlockConfig(64, 64, 32), backend=ours)
    jtree = JCT.ControlTree(device_class="big", block=JB.BlockConfig(128, 128, 128), backend=theirs)
    got = ops.gemm_with_tree(torch.as_tensor(a_np).to(tdt), torch.as_tensor(b_np).to(tdt), tree)
    want = jops.gemm_with_tree(jnp.asarray(a_np, jdt), jnp.asarray(b_np, jdt), jtree)
    assert got.shape == tuple(want.shape) == (2, m // 2, n) and got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **TOLS[dtype])
