"""Port vs reference: blocking, schedulers, paging and the asymmetric mesh.

The modules the port copies verbatim (the paper's blocking derivation,
``core/schedule.py``, ``runtime/paging.py``, ``util/atomic.py``), the
records of ``observability/trace.py`` and the mesh's scheduling surface
are held to **exact** equality with the JAX package on identical inputs.  The Hopper
block derivation has no reference numbers to match (its shapes differ by
design); it is held to the reference's *structural* rules instead: a
shared ``bk`` under Loop 3, the little class on the lean kernel at the
default tree shape, and oversized blocks rejected.
"""

import json
import os

import numpy as np
import pytest
import torch

from repro.core import asymmetric as JA
from repro.core import blocking as JB
from repro.core import schedule as JS
from repro.runtime import paging as JP
from repro.util import atomic as JU

from repro_torch.core import asymmetric as TA
from repro_torch.core import blocking as TB
from repro_torch.core import execution as TX
from repro_torch.core import schedule as TS
from repro_torch.core.control_tree import build_control_trees
from repro_torch.kernels import gemm as TG
from repro_torch.observability import trace as TT
from repro_torch.runtime import paging as TP
from repro_torch.util import atomic as TU

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# The paper's derivation (verbatim copy: exact)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cache", ["CORTEX_A15", "CORTEX_A7"])
@pytest.mark.parametrize("kw", [{}, {"dtype_bytes": 4}, {"shared_kc": 952}, {"kc_cap": 256}])
def test_goto_blocking_matches_reference(cache, kw):
    got = TB.derive_goto_blocking(getattr(TB, cache), **kw)
    want = JB.derive_goto_blocking(getattr(JB, cache), **kw)
    assert (got.mc, got.kc, got.nc, got.mr, got.nr) == (want.mc, want.kc, want.nc, want.mr, want.nr)


def test_paper_optima_and_power_model_match_reference():
    for name in ("PAPER_A15", "PAPER_A7", "PAPER_A7_SHARED_KC"):
        assert TB.GotoBlocking(**vars(getattr(JB, name))) == getattr(TB, name)
    t, j = TB.PowerModel(idle_w=10.0, flop_j=2e-12, byte_j=1e-10), JB.PowerModel(
        idle_w=10.0, flop_j=2e-12, byte_j=1e-10)
    assert t.active_w(1e12, 1e11) == j.active_w(1e12, 1e11)
    assert t.poll_w(1e12, 1e11) == j.poll_w(1e12, 1e11)
    assert t.energy_j(2.0, 1e12, 1e9) == j.energy_j(2.0, 1e12, 1e9)


# ---------------------------------------------------------------------------
# Schedulers (verbatim copy: exact)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", ["sss", "sas", "ca-sas"])
@pytest.mark.parametrize("n", [1, 7, 64, 1000])
def test_static_partitions_match_reference(strategy, n):
    if strategy == "sss":
        got, want = TS.sss_partition(n, 3), JS.sss_partition(n, 3)
    elif strategy == "sas":
        got = TS.sas_partition(n, [1.0, 0.25, 0.5], workers=[4, 4, 2])
        want = JS.sas_partition(n, [1.0, 0.25, 0.5], workers=[4, 4, 2])
    else:
        got = TS.ca_sas_partition(n, [1.0, 0.25], tiles=[8, 2])
        want = JS.ca_sas_partition(n, [1.0, 0.25], tiles=[8, 2])
    assert got.sizes() == want.sizes()
    assert [(c.start, c.size) for c in got.chunks] == [(c.start, c.size) for c in want.chunks]


def test_dynamic_scheduler_tables_and_drift_match_reference():
    rng = np.random.default_rng(3)
    kw = dict(init_ratios=[1.0, 0.25], tiles=[4, 1], workers=[1, 1])
    t, j = TS.DynamicScheduler(2, **kw), JS.DynamicScheduler(2, **kw)
    for step in range(40):
        n = 48 if step % 10 else int(rng.integers(8, 64))  # rebalances need a fixed n
        assert t.table(n).sizes() == j.table(n).sizes()
        assert t.drift() == j.drift()
        units = rng.integers(0, 32, size=2).tolist()
        times = (rng.uniform(0.5, 2.0, size=2) * (1 + (step > 20))).tolist()
        t.observe(units, times)
        j.observe(units, times)
        assert np.array_equal(t.rates, j.rates)
        assert t.needs_rebalance() == j.needs_rebalance()
    assert t.rebalances == j.rebalances > 0


def test_deficit_route_matches_reference():
    rng = np.random.default_rng(5)
    weights = [1.0, 0.25, 0.6]
    rt, rj = [0, 0, 0], [0, 0, 0]
    for _ in range(200):
        a, b = TS.deficit_route(weights, rt), JS.deficit_route(weights, rj)
        assert a == b
        rt[a] += 1
        rj[b] += 1
        if rng.random() < 0.1:
            weights = rng.uniform(0.1, 1.0, size=3).tolist()
    for bad in ([1.0], [0.0, 0.0, 0.0]):
        with pytest.raises(ValueError):
            TS.deficit_route(bad, [0, 0, 0])


def test_validate_objective_matches_reference():
    for obj in ("perf", "energy", "edp"):
        assert TS.validate_objective(obj) == JS.validate_objective(obj)
    with pytest.raises(ValueError):
        TS.validate_objective("speed")  # repro: noqa=RPR005 -- negative test: an unknown objective must raise  # repro_torch: noqa=RPR005 -- negative test: an unknown objective must raise


# ---------------------------------------------------------------------------
# Paging (verbatim copy: exact pool state)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s_cache,req", [(24, 16), (24, 5), (17, 4), (64, 64), (8, 100)])
def test_divisor_page_size_matches_reference(s_cache, req):
    ps = TP.divisor_page_size(s_cache, req)
    assert ps == JP.divisor_page_size(s_cache, req)
    assert s_cache % ps == 0 and ps <= max(1, req)


@pytest.mark.parametrize("per_slot", [False, True])
def test_page_pool_state_matches_reference_after_identical_ops(per_slot):
    spec_kw = dict(page_size=4, pages_per_slot=6, pages_per_pod=40, n_pods=2)
    t, j = TP.PagePool(TP.PageSpec(**spec_kw), 4), JP.PagePool(JP.PageSpec(**spec_kw), 4)
    assert np.array_equal(t.alloc_phantom(per_slot=per_slot), j.alloc_phantom(per_slot=per_slot))
    rng = np.random.default_rng(9)
    for _ in range(300):
        slot = int(rng.integers(0, 8))
        if rng.random() < 0.6:
            n = int(rng.integers(1, 30))
            assert t.alloc(slot, n) == j.alloc(slot, n)
        else:
            assert t.free_slot(slot) == j.free_slot(slot)
        assert np.array_equal(t.table, j.table)
        assert (t.pages_free, t.pages_live, t.peak_live, t.allocs) == (
            j.pages_free, j.pages_live, j.peak_live, j.allocs)
    pod_of_row = np.arange(8) // 4
    assert np.array_equal(t.localize(t.table, pod_of_row), j.localize(j.table, pod_of_row))
    assert TP.SENTINEL == JP.SENTINEL


# ---------------------------------------------------------------------------
# util.atomic (a verbatim copy) and observability.trace's records (exact)
# ---------------------------------------------------------------------------


def test_atomic_write_json_bytes_match_reference(tmp_path):
    payload = {"b": [1, 2.5, None], "a": {"z": "é", "y": True}}
    pt, pj = tmp_path / "t.json", tmp_path / "j.json"
    TU.atomic_write_json(str(pt), payload)
    JU.atomic_write_json(str(pj), payload)
    assert pt.read_bytes() == pj.read_bytes()
    assert json.loads(pt.read_text()) == payload
    assert not [p for p in os.listdir(tmp_path) if p.startswith(".tmp-")]


def test_trace_buffer_records_like_reference():
    from repro.observability import trace as JT

    out = []
    for mod in (TT, JT):
        mod.enable()
        try:
            mod.instant("engine.rebalance", cat="engine", before=[1, 2], after=[2, 1])
            mod.counter("tokens", n=3)
            with mod.span("step", cat="engine", k=1):
                pass
            events = mod.get_buffer().to_dict()["events"]
            out.append([(e["name"], e["ph"], e["cat"], e["args"]) for e in events])
        finally:
            mod.disable()
        assert not mod.enabled()
    assert out[0] == out[1] and len(out[0]) == 3


# ---------------------------------------------------------------------------
# The asymmetric mesh's scheduling surface (exact)
# ---------------------------------------------------------------------------


def _meshes(**kw):
    return (TA.AsymmetricMesh(TA.biglittle_classes(chips_per_pod=1), **kw),
            JA.AsymmetricMesh(JA.biglittle_classes(chips_per_pod=1), **kw))


@pytest.mark.parametrize("strategy", ["sss", "sas", "ca-sas", "das", "ca-das"])
@pytest.mark.parametrize("batch_tile", [1, 4])
def test_batch_layout_and_slot_budgets_match_reference(strategy, batch_tile):
    t, j = _meshes(strategy=strategy, batch_tile=batch_tile)
    assert t.n_pods == j.n_pods and t.pod_class_indices() == j.pod_class_indices()
    for gb in (1, 5, 8, 13, 64):
        lt, lj = t.batch_layout(gb), j.batch_layout(gb)
        assert (lt.sizes, lt.c_max) == (lj.sizes, lj.c_max)
        assert np.array_equal(lt.mask, lj.mask)
        assert t.imbalance(lt) == j.imbalance(lj)
    for n_work in (0, 1, 3, 6, 9, 12, 40):
        assert t.slot_budgets(6, n_work) == j.slot_budgets(6, n_work)
        assert t.slot_budgets(6, n_work, parked=[1]) == j.slot_budgets(6, n_work, parked=[1])
    t.observe_step([6, 2], [1.0, 3.0])
    j.observe_step([6, 2], [1.0, 3.0])
    assert t.slot_budgets(6, 12) == j.slot_budgets(6, 12)
    assert np.array_equal(t.scheduler.rates, j.scheduler.rates)


def test_calibrate_ratios_matches_reference():
    times = [[1.0, 1.2, 0.9], [3.0, 2.5, 4.0]]
    assert TA.calibrate_ratios(times, [8, 2]) == JA.calibrate_ratios(times, [8, 2])


# ---------------------------------------------------------------------------
# The Hopper block model: structural rules of the reference
# ---------------------------------------------------------------------------


def test_little_spec_halves_big():
    big, little = TB.H100, TB.H100_LITTLE
    assert little.smem_bytes == big.smem_bytes // 2
    assert little.peak_flops == big.peak_flops / 2 and little.hbm_bw == big.hbm_bw / 2
    assert (big.smem_bytes, big.n_sm) == (232_448, 132)
    # Without a card the static copy is used (the CPU tests).
    if not torch.cuda.is_available():
        assert TB.hopper_spec() == big and TB.hopper_spec(little=True) == little


def test_smem_model_counts_stages_of_a_and_b():
    # A stage is its swizzled A and B tiles (no padding) and a full and an
    # empty mbarrier of 8 bytes each.
    cfg = TB.BlockConfig(bm=64, bk=64, bn=128)
    one = 64 * 64 * 2 + 64 * 128 * 2 + 16
    assert TB.BARRIER_BYTES == 16
    assert cfg.smem_bytes(1) == one and cfg.smem_bytes(2) == 2 * one
    assert TB.BlockConfig(bm=128, bk=128, bn=256).smem_bytes(2) == 2 * (128 * 128 * 2 + 128 * 256 * 2 + 16)


@pytest.mark.parametrize("bm,bn,regs,threads", [(64, 32, 16, 256), (64, 128, 64, 256),
                                                (128, 128, 64, 384), (128, 256, 128, 384)])
def test_accumulators_per_consumer_thread(bm, bn, regs, threads):
    """The fp32 sum lives in the consumer warpgroups' registers: one
    warpgroup of 128 threads per 64 rows, each holding bm x bn / (128 x
    bm / 64) values; one producer warpgroup on top."""

    cfg = TB.BlockConfig(bm=bm, bk=64, bn=bn)
    assert cfg.acc_regs_per_thread() == regs == bm * bn // (128 * (bm // 64))
    assert cfg.consumer_warpgroups() == bm // 64 and cfg.threads() == threads
    assert cfg.fits(TB.H100, stages=TB.PIPELINE_STAGES)
    assert TB.H100.acc_regs_per_thread == 128 and TB.H100.threads_per_block == 384


def test_compiled_tiles_are_wgmma_shapes():
    assert TB.BM_TILES == (64, 128)                       # one or two 64-row warpgroups
    assert all(bn % 8 == 0 and bn <= 256 for bn in TB.BN_TILES)
    assert {32, 64} <= set(TB.BN_TILES)                   # decode's M = 12 fills the SMs
    assert TB.BK_ALIGN == 64 and TB.MAX_BK % TB.BK_ALIGN == 0  # one 128-byte swizzle row


@pytest.mark.parametrize("shape", [(12, 2048, 2048), (12, 8192, 2048), (12, 2048, 92544),
                                   (1024, 1024, 1024), (300, 200, 180), (1, 16, 1)])
@pytest.mark.parametrize("stages", [1, 2, 4])
@pytest.mark.parametrize("spec", [TB.H100, TB.H100_LITTLE], ids=["big", "little"])
def test_derived_blocks_fit_and_are_compiled_tiles(shape, stages, spec):
    m, k, n = shape
    cfg = TB.derive_block_config(m, k, n, spec=spec, stages=stages)
    assert cfg.fits(spec, stages=stages)
    assert cfg.bm in TB.BM_TILES and cfg.bn in TB.BN_TILES
    assert cfg.bk % 64 == 0 and 0 < cfg.bk <= TB.MAX_BK
    TG.validate_block_config(m, k, n, cfg)  # never oversized
    assert TB.pad_to_blocks(m, k, n, cfg) == tuple(
        -(-d // b) * b for d, b in zip(shape, (cfg.bm, cfg.bk, cfg.bn)))


def test_lean_model_admits_a_larger_panel():
    big2 = TB.derive_block_config(1024, 1024, 1024, spec=TB.H100_LITTLE, stages=TB.PIPELINE_STAGES)
    lean = TB.derive_block_config(1024, 1024, 1024, spec=TB.H100_LITTLE, stages=1)
    assert lean.smem_bytes(1) <= TB.H100_LITTLE.smem_bytes
    assert lean.bm * lean.bn * lean.bk >= big2.bm * big2.bn * big2.bk


def test_default_trees_mirror_the_reference_structure():
    """At the default tree shape the reference gives big ``pallas`` and
    little ``pallas_lean`` under a shared ``bk``; the port gives ``cuda``
    and ``cuda_lean`` under the same rule."""

    t, j = _meshes(batch_tile=1, backend="cuda")  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    _, jref = _meshes(batch_tile=1, backend="pallas")  # repro_torch: noqa=RPR005 -- the reference's backend name (repro.core.execution.BACKENDS)
    trees, jtrees = t.control_trees(), jref.control_trees()
    rename = {"pallas": "cuda", "pallas_lean": "cuda_lean"}
    assert {k: v.backend for k, v in trees.items()} == {
        k: rename[v.backend] for k, v in jtrees.items()}
    assert trees["big"].backend == "cuda" and trees["little"].backend == "cuda_lean"
    assert len({tr.block.bk for tr in trees.values()}) == 1          # Loop 3: shared bk
    assert trees["little"].block.fits(TB.H100_LITTLE, stages=1)
    assert not trees["little"].block.fits(TB.H100_LITTLE, stages=TX.backend_stages("cuda"))
    assert t.class_backends() == {"big": "cuda", "little": "cuda_lean"}


def test_shared_bk_rederives_bm_and_loop1_is_independent():
    specs = {"big": TB.H100, "little": TB.H100_LITTLE}
    rows = build_control_trees(specs, 1024, 1024, 1024, backend="cuda", coarse_loop="rows")  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    assert rows["little"].block.bk == rows["big"].block.bk
    assert rows["little"].block.bn == rows["big"].block.bn
    plain = build_control_trees(specs, 1024, 1024, 1024, backend="torch_ref")  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    assert plain["little"].backend == "torch_ref_lean"
    cols = build_control_trees(specs, 1024, 1024, 1024, backend="cuda", coarse_loop="cols")  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    assert cols["little"].backend == "cuda"
    assert cols["little"].block == TB.derive_block_config(1024, 1024, 1024, spec=TB.H100_LITTLE)
    single = build_control_trees(specs, 1024, 1024, 1024, backend="cuda", cache_aware=False)  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    assert single["little"].block == single["big"].block
    mm = build_control_trees(specs, 1024, 1024, 1024, backend="matmul")  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    assert {tr.backend for tr in mm.values()} == {"matmul"}


@pytest.mark.parametrize("bad", [dict(bm=128), dict(bk=128), dict(bn=64)])
def test_oversized_blocks_are_rejected(bad):
    # The floors are the smallest compiled tiles (bm 64, bn 32) and one
    # swizzle row of depth (bk 64); anything past them on an 8^3 problem
    # is oversized.
    TG.validate_block_config(8, 8, 8, TB.BlockConfig(bm=64, bk=64, bn=32))
    cfg = TB.BlockConfig(**{**dict(bm=64, bk=64, bn=32), **bad})
    with pytest.raises(ValueError, match="exceeds padded"):
        TG.validate_block_config(8, 8, 8, cfg)
    a = torch.zeros((8, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="exceeds padded"):
        TG.gemm_cuda(a, a, cfg)


def test_execution_context_blocks_per_call_shape():
    t = TA.AsymmetricMesh(TA.biglittle_classes(chips_per_pod=1), batch_tile=1, backend="cuda")  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    big, little = t.execution_context("big"), t.execution_context("little")
    assert t.execution_context().device_class == "big"
    assert big.block_config(1024, 1024, 1024, "bfloat16", 2) == big.tree.block
    assert little.block_config(1024, 1024, 1024, "bfloat16", 2) == little.tree.block
    for ctx, stages in ((big, TB.PIPELINE_STAGES), (little, 1)):
        cfg = ctx.block_config(12, 2048, 92544, "bfloat16", 2)
        assert cfg == TB.derive_block_config(12, 2048, 92544, spec=ctx.spec, stages=stages)
    with pytest.raises(KeyError):
        t.execution_context("medium")
    single = TX.default_context(backend="cuda")  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    assert (single.device_class, single.backend()) == ("h100", "cuda")
    assert single.tree.block == TB.derive_block_config(1024, 1024, 1024)
    assert TX.context_for_tree(little.tree).device_class == "little"
    assert TX.current_context() is None
    with big:
        assert TX.current_context() is big
        with little:
            assert TX.current_context() is little
        assert TX.current_context() is big
    assert TX.current_context() is None
