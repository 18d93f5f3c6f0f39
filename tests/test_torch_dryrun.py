"""The port's one-card dry-run against the reference's, on the CPU.

``repro_torch.launch.dryrun`` runs a cell's step on the ``meta`` device
under the operator counter of ``launch.op_analysis``; the reference
AOT-compiles it and parses the HLO (``repro.launch.hlo_analysis``).  At
the reduced size of the reference's three families of
``tests/test_dryrun_small.py`` (internlm2-1.8b ``train_4k``,
mixtral-8x7b ``decode_32k``, mamba2-1.3b ``long_500k``; published shapes,
``ArchConfig.reduced()`` widths), the reference's side compiled on a
one-device mesh:

  * argument bytes equal ``memory_analysis().argument_size_in_bytes``
    exactly (the same params, optimizer trees, batch and decode state; an
    argument the step never reads is pruned by the reference's ``jit`` and
    not counted by the port);
  * total FLOPs agree within ``FLOPS_RTOL``.

``model_flops`` agrees exactly for every config x shape.  The claims of
``test_dryrun_small.py`` hold on one card, and the GEMM funnel's counts
at the card's shapes are the ones ``chip_smoke.py`` phase 23 holds to the
card's own launch counters.  Last, the sync-free decode writes of
``models/layers.py`` leave the dense cache and the paged arena bitwise
what the dropped writes left.
"""

import json
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeSpec, get_config, list_configs
from repro_torch.launch import dryrun as D
from repro_torch.launch import op_analysis as OA
from repro_torch.launch import roofline as R
from repro_torch.models import layers as L
from repro_torch.models import model_zoo as Z

# Both count the same dots: every projection, the attention's score and
# value products of each query chunk, with remat's forward counted twice.
# One difference: ``torch.utils.checkpoint`` recomputes each layer's whole
# forward, its last product (the MLP's down projection, whose output the
# backward never reads) included, where XLA drops that product as dead
# code: 0.36% of the reduced internlm2 training step (the card runs it:
# 675 launches a step), nothing in the decode steps.  2% bounds the rest.
FLOPS_RTOL = 0.02

CELLS = [
    ("internlm2-1.8b", "train_4k"),
    ("mixtral-8x7b", "decode_32k"),
    ("mamba2-1.3b", "long_500k"),
]


def _reference_dryrun():
    """``repro.launch.dryrun`` imported without its 512-device ``XLA_FLAGS``
    leaking into this process's later subprocesses."""

    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as RD
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return RD


@pytest.fixture(scope="module")
def reference_cells():
    """The reference's reduced cells compiled on a one-device mesh:
    ``{(arch, shape): (flops, argument bytes)}``."""

    import jax

    from repro.configs import get_config as ref_config
    from repro.launch import hlo_analysis as H
    from repro.launch.mesh import make_host_mesh

    RD = _reference_dryrun()
    mesh = make_host_mesh()
    out = {}
    orig = RD.get_config
    RD.get_config = lambda name: ref_config(name).reduced()
    try:
        for arch, shape in CELLS:
            fn, args, in_sh, out_sh = RD.build_cell(arch, shape, mesh)
            donate = (0, 1) if len(args) == 3 else (2,)
            with mesh:
                compiled = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,  # repro: noqa=RPR003 -- one compile per distinct cell, each its own program
                                   donate_argnums=donate).lower(*args).compile()
            out[(arch, shape)] = (H.analyze(compiled.as_text()).flops,
                                  compiled.memory_analysis().argument_size_in_bytes)
    finally:
        RD.get_config = orig
    return out


@pytest.fixture(scope="module")
def port_cells():
    return {(arch, shape): D.run_cell(get_config(arch).reduced(), shape, write=False)
            for arch, shape in CELLS}


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", list_configs())
def test_model_flops_equal_reference(arch):
    from repro.launch.roofline import model_flops as ref_model_flops

    for shape in get_config(arch).shapes(include_skipped=True):
        assert R.model_flops(arch, shape.name) == ref_model_flops(arch, shape.name), shape.name


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}:{c[1]}")
def test_argument_bytes_equal_reference(cell, reference_cells, port_cells):
    rec = port_cells[cell]
    assert rec["ok"], rec.get("error")
    assert rec["memory"]["argument_bytes"] == reference_cells[cell][1]


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}:{c[1]}")
def test_total_flops_match_reference(cell, reference_cells, port_cells):
    got, want = port_cells[cell]["hlo_cost"]["flops"], reference_cells[cell][0]
    assert abs(got - want) <= FLOPS_RTOL * want, (got, want)


def test_batch_and_state_specs_match_reference():
    import jax

    from repro.configs import get_config as ref_config
    from repro.models import model_zoo as RZ

    for arch, shape_name in CELLS + [("whisper-small", "prefill_32k"), ("pixtral-12b", "train_4k")]:
        cfg, rcfg = get_config(arch).reduced(), ref_config(arch).reduced()
        shape = next(s for s in cfg.shapes(include_skipped=True) if s.name == shape_name)
        rshape = next(s for s in rcfg.shapes(include_skipped=True) if s.name == shape_name)
        got = Z.batch_spec(cfg, shape)
        want = RZ.batch_spec(rcfg, rshape)
        assert set(got) == set(want)
        for k in got:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(want[k].shape), k
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
        if shape.kind == "decode":
            st = Z.decode_state_spec(cfg, shape.global_batch, shape.seq_len)
            rst = RZ.decode_state_spec(rcfg, rshape.global_batch, rshape.seq_len)
            assert OA.tree_bytes(st) == sum(
                int(np.prod(x.shape)) * x.dtype.itemsize for x in jax.tree.leaves(rst))


# ---------------------------------------------------------------------------
# test_dryrun_small.py's claims, on one card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: f"{c[0]}:{c[1]}")
def test_every_family_counts_work(cell, port_cells):
    cost = port_cells[cell]["hlo_cost"]
    assert cost["flops"] > 0 and cost["bytes"] > 0
    assert cost["gemm_calls"] > 0 and 0 < cost["gemm_flops"] <= cost["flops"]


def test_class_sharded_train_cell_communicates():
    rec = D.run_cell(get_config("internlm2-1.8b").reduced(), "train_4k",
                     little_spec="h100-little", write=False)
    assert rec["ok"], rec.get("error")
    assert rec["class_sharded"] and [c[1] for c in rec["shard_classes"]] == ["big", "little"]
    assert rec["hlo_cost"]["collective_bytes"] > 0
    assert set(rec["hlo_cost"]["by_collective"]) == {"all-reduce"}
    row = R.analyze_record(rec)
    assert row.collective_s > 0


@pytest.mark.parametrize("sizes", [(2, 1, 1), (2, 16, 16)], ids=["pod2x1x1", "pod2x16x16"])
def test_class_sharded_cells_a_rank_a_pod(sizes):
    """``--little-spec`` on a mesh of pod ranks (the reference's
    ``--multi-pod --little-spec``): rank 0 runs pod 0's program over its
    half of the rows, and the record counts the epilogue's all-reduces
    (each pod's scaled loss, metrics and gradients, and the valid-token
    count) or the logits' all-gather over ``pod``."""

    from repro_torch.launch.mesh import RankMesh

    cfg = get_config("internlm2-1.8b").reduced()
    mesh = RankMesh.abstract(("pod", "data", "model"), sizes)
    one = D.run_cell(cfg, "train_4k", little_spec="h100-little", write=False)
    rec = D.run_cell(cfg, "train_4k", little_spec="h100-little", mesh=mesh, write=False)
    assert rec["ok"], rec.get("error")
    assert rec["class_sharded"] and [c[1] for c in rec["shard_classes"]] == ["big", "little"]
    assert rec["n_chips"] == mesh.world and rec["mesh"] == D.mesh_tag(mesh)
    assert rec["hlo_cost"]["gemm_calls"] * 2 == one["hlo_cost"]["gemm_calls"]
    assert rec["hlo_cost"]["by_collective"] == {
        "all-reduce": one["hlo_cost"]["by_collective"]["all-reduce"] + 4}
    for shape in ("decode_32k", "prefill_32k"):
        s = next(x for x in cfg.shapes() if x.name == shape)
        rec = D.run_cell(cfg, shape, little_spec="h100-little", mesh=mesh, write=False)
        assert rec["ok"] and rec["class_sharded"], rec.get("error")
        rows = s.global_batch // 2 * (1 if s.kind == "decode" else s.seq_len)
        assert rec["hlo_cost"]["by_collective"] == {"all-gather": rows * cfg.vocab * 2}
    # The 16x16 mesh has no pod axis: the cell runs sharded, single-class.
    if sizes == (2, 16, 16):
        rec = D.run_cell(cfg, "decode_32k", little_spec="h100-little", write=False,
                         mesh=RankMesh.abstract(("data", "model"), (16, 16)))
        assert rec["ok"] and not rec["class_sharded"]


def test_ssm_long_context_decode_state_is_small():
    rec = D.run_cell("mamba2-1.3b", "long_500k", write=False)
    assert rec["ok"], rec.get("error")
    assert rec["memory"]["temp_bytes"] / 2**30 < 4.0
    assert rec["fits"] and rec["memory"]["alias_bytes"] > 0


# ---------------------------------------------------------------------------
# The funnel at the card's shapes (chip_smoke.py phase 23 holds the card's
# launch counters to these), full width on the meta device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape,calls", [
    ("internlm2-1.8b", ShapeSpec("phase8", 4096, 12, "decode"), 169),
    ("minitron-4b", ShapeSpec("phase7", 2048, 2, "prefill"), 225),
    ("internlm2-1.8b", ShapeSpec("phase16", 512, 8, "train"), 675),
], ids=["decode", "forward", "train"])
def test_funnel_calls_at_the_cards_shapes(arch, shape, calls):
    rec = D.run_cell(arch, shape, write=False)
    assert rec["ok"], rec.get("error")
    assert rec["hlo_cost"]["gemm_calls"] == calls
    assert rec["exec_backend"] == "matmul"  # set, never probed
    assert rec["attn_backends"]["flash_attn"] == "flash_attn_torch"


def test_minitron_forward_operations_bound():
    # PERF.md §6 row 1: 35.7 ms of GEMM operations a 2 x 2048 forward.
    rec = D.run_cell("minitron-4b", ShapeSpec("phase7", 2048, 2, "prefill"), write=False)
    bound_ms = rec["hlo_cost"]["gemm_flops"] / R.PEAK_FLOPS * 1e3
    assert abs(bound_ms - 35.7) <= 0.01 * 35.7, bound_ms


# A sharded cell: the reference compiled on the conftest's 8 host devices as
# a (pod=2, data=2, model=2) mesh, the port as rank 0 of the abstract mesh
# (FSDP, the stream sequence-sharded, as the reference's dry-run).  The
# arguments are the same shards; the FLOPs are rank 0's share of the same
# products (the +0.36% recompute of the one-card cell); the collectives are
# GSPMD's choice against the port's explicit ones (PERF.md §6: XLA
# all-reduces where the port reduce-scatters, and keeps fp32 where the port
# moves bf16), held within 2x either way.  One cell a family: the dense
# family's training step, the MoE's prefill, the Mamba2's and the hybrid's
# decode steps, the enc-dec's training step (the cells where GSPMD's
# program is not dominated by its own involuntary rematerialisations:
# mamba2's train_4k moves 11x the port's bytes, zamba2's 6.8x).
SHARDED_FLOPS_RTOL = 0.05
SHARDED_COLLECTIVE_RATIO = 2.0
SHARDED_CELLS = [
    ("internlm2-1.8b", "train_4k"),
    ("qwen2-moe-a2.7b", "prefill_32k"),
    ("mamba2-1.3b", "decode_32k"),
    ("zamba2-2.7b", "decode_32k"),
    ("whisper-small", "train_4k"),
]


@pytest.fixture(scope="module")
def sharded_cells():
    import jax

    from repro.configs import get_config as ref_config
    from repro.launch import hlo_analysis as H
    from repro.launch.mesh import make_host_mesh

    from repro_torch.launch.mesh import RankMesh

    RD = _reference_dryrun()
    mesh = make_host_mesh(data=2, model=2, pod=2)
    orig = RD.get_config
    RD.get_config = lambda name: ref_config(name).reduced()
    out = {}
    try:
        for arch, shape in SHARDED_CELLS:
            fn, args, in_sh, out_sh = RD.build_cell(arch, shape, mesh)
            donate = {3: (0, 1), 4: (2,)}.get(len(args), ())
            with mesh:
                compiled = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh,  # repro: noqa=RPR003 -- one compile a distinct sharded cell
                                   donate_argnums=donate).lower(*args).compile()
            cost = H.analyze(compiled.as_text())
            port = D.run_cell(get_config(arch).reduced(), shape,
                              mesh=RankMesh.abstract(("pod", "data", "model"), (2, 2, 2)), write=False)
            out[(arch, shape)] = ({"flops": cost.flops,
                                   "args": compiled.memory_analysis().argument_size_in_bytes,
                                   "collective": cost.collective_bytes}, port)
    finally:
        RD.get_config = orig
    return out


@pytest.mark.parametrize("cell", SHARDED_CELLS, ids=lambda c: f"{c[0]}:{c[1]}")
def test_sharded_cell_matches_reference_hlo(cell, sharded_cells):
    ref, rec = sharded_cells[cell]
    assert rec["ok"], rec.get("error")
    assert rec["mesh"] == "mesh2x2x2" and rec["n_chips"] == 8
    assert rec["memory"]["argument_bytes"] == ref["args"]
    assert abs(rec["hlo_cost"]["flops"] - ref["flops"]) <= SHARDED_FLOPS_RTOL * ref["flops"]
    ratio = rec["hlo_cost"]["collective_bytes"] / ref["collective"]
    assert 1 / SHARDED_COLLECTIVE_RATIO <= ratio <= SHARDED_COLLECTIVE_RATIO, ratio


def test_production_meshes_run_every_family(tmp_path, capsys):
    # Every config's decode cells on both production meshes: each ok, or a
    # full-attention long_500k skipped for the reference's reason; the
    # batch-of-1 long caches (mixtral's ring, the SSM states) split their
    # length or heads over the dp axes and model.
    for arch in list_configs():
        for shape in ("decode_32k", "long_500k"):
            with pytest.raises(SystemExit) as e:
                D.main(["--arch", arch, "--shape", shape, "--both-meshes", "--out", str(tmp_path)])
            assert e.value.code == 0, (arch, shape)
    recs = [json.loads(p.read_text()) for p in sorted(tmp_path.iterdir())]
    assert len(recs) == 2 * 2 * len(list_configs())
    for r in recs:
        assert "error" not in r, (r["arch"], r["shape"], r["mesh"], r.get("error"))
        if r["skipped"]:
            assert r["shape"] == "long_500k"
            assert r["reason"] == "full quadratic attention (see DESIGN.md)"
        else:
            assert r["ok"] and r["hlo_cost"]["collective_bytes"] > 0
    assert sum(not r["skipped"] for r in recs) == 2 * (len(list_configs()) + 3)
    capsys.readouterr()


# ---------------------------------------------------------------------------
# The dry-run's own surface
# ---------------------------------------------------------------------------


def test_kernel_backend_fails_the_cell_on_meta():
    rec = D.run_cell(get_config("internlm2-1.8b").reduced(), "decode_32k", backend="cuda",  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
                     write=False)
    assert not rec["ok"] and "meta device" in rec["error"]


def test_quadratic_long_context_is_skipped_with_the_reference_reason():
    rec = D.run_cell("internlm2-1.8b", "long_500k", write=False)
    assert rec["skipped"] and rec["reason"] == "full quadratic attention (see DESIGN.md)"


def test_multi_card_meshes_raise(tmp_path, capsys):
    # The production meshes no longer raise: --multi-pod writes the
    # reference's pod2x16x16 records, --both-meshes pod16x16 beside them,
    # each a device's share (rank 0 of the abstract mesh).
    for flag, tags in (("--multi-pod", {"pod2x16x16"}), ("--both-meshes", {"pod16x16", "pod2x16x16"})):
        out = tmp_path / flag.strip("-")
        with pytest.raises(SystemExit) as e:
            D.main(["--arch", "internlm2-1.8b", "--shape", "decode_32k", flag, "--out", str(out)])
        assert e.value.code == 0
        recs = [json.loads(p.read_text()) for p in sorted(out.iterdir())]
        assert {r["mesh"] for r in recs} == tags
        for r in recs:
            assert r["ok"] and r["n_chips"] == (512 if r["mesh"] == "pod2x16x16" else 256)
            assert r["hlo_cost"]["collective_bytes"] > 0
        assert "pod2x16x16" in capsys.readouterr().out


def test_cli_writes_records_and_roofline_formats(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "mamba2-1.3b", "--shape", "long_500k", "--out", str(tmp_path)])
    assert e.value.code == 0
    (path,) = tmp_path.iterdir()
    assert path.name == "mamba2-1.3b__long_500k__card1.json"
    R.main(["--dir", str(tmp_path), "--csv", str(tmp_path / "rows.csv")])
    out = capsys.readouterr().out
    assert "mamba2-1.3b" in out and "long_500k" in out
    assert (tmp_path / "rows.csv").read_text().count("\n") == 2


def test_roofline_constants_come_from_the_spec():
    from repro_torch.core.blocking import H100

    assert (R.PEAK_FLOPS, R.HBM_BW) == (H100.peak_flops, H100.hbm_bw)
    rec = {"ok": True, "arch": "x", "shape": "y", "mesh": "card1", "n_chips": 1,
           "hlo_cost": {"flops": 989e12, "bytes": 6.7e12, "attn_score_bytes": 3.35e12,
                        "collective_bytes": 0.0}}
    row = R.analyze_record(rec)
    assert row.compute_s == pytest.approx(1.0) and row.memory_s == pytest.approx(2.0)
    assert row.memory_flash_s == pytest.approx(1.0) and row.collective_s == 0.0


def test_op_cost_has_the_reference_fields_and_the_funnels():
    from repro.launch.hlo_analysis import HloCost

    assert set(OA.OpCost().as_dict()) == set(HloCost().as_dict()) | {"gemm_calls", "gemm_flops"}


def test_counter_rules():
    a = torch.zeros((8, 16), device="meta")
    b = torch.zeros((16, 4), device="meta")
    with OA.count_ops() as cost:
        c = a @ b              # mm: 2 x 8 x 16 x 4
        v = c.view(32)         # a view moves nothing
        d = v.clone()          # a copy: read + write
        del c, v, d
    assert cost.flops == 2 * 8 * 16 * 4 and cost.dot_count == 1
    assert cost.bytes == (8 * 16 + 16 * 4 + 8 * 4) * 4 + 2 * 32 * 4
    # c and its clone were alive together, then released.
    assert cost.peak_live_bytes == 2 * 32 * 4 and cost.live_bytes == 0


# ---------------------------------------------------------------------------
# The sync-free decode writes (models/layers.py) keep the caches bitwise
# ---------------------------------------------------------------------------

ACFG = L.AttnConfig(d_model=32, n_heads=4, n_kv_heads=2, d_head=8)


def _qkv(p, x, pos):
    return L._qkv(p, x, ACFG, pos.long()[:, None])


def _dropping_dense(cache_k, cache_v, k, v, pos):
    # The former write: rows past a linear cache dropped by a mask.
    rows = torch.arange(k.shape[0])
    ok = pos.long() < cache_k.shape[1]
    cache_k[rows[ok], pos.long()[ok]] = k[ok, 0].to(cache_k.dtype)
    cache_v[rows[ok], pos.long()[ok]] = v[ok, 0].to(cache_v.dtype)


def _dropping_paged(pages_k, pages_v, table, k, v, pos):
    n_pages, ps = pages_k.shape[:2]
    w = table.shape[1]
    slot = pos.long()
    page = table[torch.arange(k.shape[0]), torch.clamp(slot // ps, 0, w - 1)].long()
    ok = (slot < w * ps) & (page >= 0) & (page < n_pages)
    pages_k[page[ok], (slot % ps)[ok]] = k[ok, 0].to(pages_k.dtype)
    pages_v[page[ok], (slot % ps)[ok]] = v[ok, 0].to(pages_v.dtype)


@pytest.mark.parametrize("pos", [[0, 3, 5, 2], [6, 9, 1, 6], [7, 8, 9, 10]],
                         ids=["in_cache", "some_past", "all_past"])
def test_dense_write_bitwise(pos):
    g = torch.Generator().manual_seed(0)
    p = L.init_attention(g, ACFG, device="cpu")
    x = torch.randn((4, 1, 32), generator=g).to(L.COMPUTE_DTYPE)
    pos = torch.tensor(pos, dtype=torch.int32)
    cache = [torch.randn((4, 7, 2, 8), generator=g).to(L.COMPUTE_DTYPE) for _ in range(2)]
    want = [c.clone() for c in cache]
    _, k, v = _qkv(p, x, pos)
    _dropping_dense(*want, k, v, pos)
    L.decode_attention(p, x, ACFG, *cache, pos)
    assert all(torch.equal(c, w) for c, w in zip(cache, want))


SENT = int(np.int32(1 << 30))


@pytest.mark.parametrize("table,pos", [
    ([[0, 1], [2, 3], [4, 5], [6, 7]], [0, 5, 6, 7]),
    ([[SENT, SENT], [2, 3], [SENT, SENT], [6, SENT]], [1, 5, 2, 6]),      # unallocated pages
    ([[0, 1], [2, 3], [4, 5], [6, 7]], [8, 3, 9, 12]),                    # past the cache
    ([[SENT, SENT], [SENT, 3], [4, 5], [6, 7]], [0, 1, 8, 11]),           # none accepted
    ([[2, 3], [2, 3], [4, 5], [SENT, SENT]], [6, 6, 1, 3]),               # shared (phantom) page
], ids=["all_live", "unallocated", "past_cache", "none_accepted", "shared_page"])
def test_paged_write_bitwise(table, pos):
    g = torch.Generator().manual_seed(1)
    p = L.init_attention(g, ACFG, device="cpu")
    x = torch.randn((4, 1, 32), generator=g).to(L.COMPUTE_DTYPE)
    x[1] = x[0]  # rows 0 and 1 write the same values (the phantom rows' case)
    pos = torch.tensor(pos, dtype=torch.int32)
    table = torch.tensor(table, dtype=torch.int32)
    arena = [torch.randn((8, 4, 2, 8), generator=g).to(L.COMPUTE_DTYPE) for _ in range(2)]
    want = [a.clone() for a in arena]
    _, k, v = _qkv(p, x, pos)
    _dropping_paged(*want, table, k, v, pos)
    L.decode_attention_paged(p, x, ACFG, *arena, table, pos)
    assert all(torch.equal(a, w) for a, w in zip(arena, want))


def test_decode_step_runs_on_meta():
    # The host syncs the writes replaced raised on a meta tensor.
    cfg = get_config("internlm2-1.8b").reduced()
    shape = ShapeSpec("d", 16, 3, "decode")
    fn, args, alias = D.build_cell(cfg, shape)
    logits, state = fn(*args)
    assert logits.device.type == "meta" and tuple(logits.shape) == (3, 1, cfg.vocab)
    assert state is args[2] and alias == (2,)
