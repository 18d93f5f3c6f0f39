"""The benchmark's Mamba2 family (``portbench/families/ssm.py``) and the
cell ``mamba2-1.3b.train``: the plain reference's SSD against the
step-by-step recurrence, its convolution against the definition, the
frozen counts worked by hand, the two scan readers, and the reduced
cell run through the harness on the CPU (the program against the
reference, the fp8 control and half the batch outside the readings)."""

import json
import math
import os
import sys
import types

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import cell as C  # noqa: E402
from portbench import counts  # noqa: E402
from portbench import run as RUN  # noqa: E402
from portbench import weights as W  # noqa: E402
from portbench.families import ssm as FS  # noqa: E402
from repro_torch.observability import trace  # noqa: E402

CELL = "mamba2-1.3b.train"
PK = {"bf16_flops": 1e12, "hbm_bytes_per_s": 1e9}
SEED = 2**33 + 21


def _conf():
    with open(os.path.join(ROOT, "portbench", "configs", "mamba2-1.3b.json")) as f:
        return json.load(f)


def _reduced_cell():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "portbench_test_cells", os.path.join(ROOT, "portbench", "tests", "cells.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.reduced_cell(CELL)


# ---------------------------------------------------------------------------
# The reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("groups,q_block", [(1, 3), (2, 5), (1, 64)])
def test_the_quadratic_ssd_equals_the_recurrence(groups, q_block):
    """``h_t = exp(A dt_t) h_{t-1} + dt_t B_t ⊗ x_t``, ``y_t = C_t · h_t``,
    step by step in float64."""

    g = torch.Generator().manual_seed(groups)
    b, s, h, p, n = 2, 13, 4, 3, 5
    x = torch.randn(b, s, h, p, generator=g)
    dt = torch.rand(b, s, h, generator=g) * 0.5 + 0.01
    A = -torch.rand(h, generator=g) * 4 - 0.5
    B, Cm = (torch.randn(b, s, groups, n, generator=g) for _ in range(2))
    y = FS.ssd(x, dt, A, B, Cm, "fp32", q_block=q_block)
    rep = h // groups
    state = torch.zeros(b, h, n, p, dtype=torch.float64)
    for t in range(s):
        bh = B[:, t].repeat_interleave(rep, dim=1).double()
        ch = Cm[:, t].repeat_interleave(rep, dim=1).double()
        decay = torch.exp(A.double()[None] * dt[:, t].double())
        state = decay[..., None, None] * state + torch.einsum(
            "bhn,bhp->bhnp", bh * dt[:, t].double()[..., None], x[:, t].double())
        torch.testing.assert_close(y[:, t].double(), torch.einsum("bhn,bhnp->bhp", ch, state),
                                   rtol=1e-5, atol=1e-5)


def test_the_convolution_is_causal_with_the_last_tap_on_the_current_step():
    g = torch.Generator().manual_seed(4)
    u, w, bias = torch.randn(2, 9, 3, generator=g), torch.randn(4, 3, generator=g), torch.randn(3)
    out = FS.causal_conv(u, w, bias)
    for t in range(9):
        acc = bias.clone()
        for k in range(4):
            if t - 3 + k >= 0:
                acc = acc + w[k] * u[:, t - 3 + k]
        torch.testing.assert_close(out[:, t], torch.nn.functional.silu(acc))


def test_the_tied_head_over_the_held_rows():
    conf = _conf()
    assert FS.tied_head(conf) and FS.held_vocab(conf) == 50288 and conf["vocab_size"] == 50277
    specs = {n: s for n, s, _ in W.leaf_specs(conf)}
    assert "lm_head" not in specs and specs["embed"] == (50288, 2048)
    assert specs["blocks.mamba.wbc"] == (48, 2048, 256)
    assert specs["blocks.mamba.out_proj"] == (48, 4096, 2048)


# ---------------------------------------------------------------------------
# The frozen counts, by hand
# ---------------------------------------------------------------------------


# a token's SSD operations in a layer at chunk 256: C·Bᵀ over the causal
# half (256·128, one group), (L∘CBᵀ)·x (64 heads · 256·64), the chunk
# states and the output from them (4 · 64 · 128 · 64)
SSD_PER_TOKEN = 256 * 128 + 64 * 256 * 64 + 4 * 64 * 128 * 64


def test_the_cells_frozen_counts():
    conf = _conf()
    m = 4 * 2048
    train = counts.gemm_products(conf, m, train=True)
    # the tied head forward and its two backward products: 3 launches a step
    assert train == [(m, 2048, 50288, 1), (m, 50288, 2048, 1), (2048, m, 50288, 1)]
    assert counts.launches(train) == 3
    assert counts.launches(counts.gemm_products(conf, m, train=False)) == 1
    in_proj = 2048 * (2 * 4096 + 2 * 128 + 64)
    out_proj = 4096 * 2048
    n = 48 * (in_proj + out_proj) + 2048 * 50288         # the head counted once
    assert n == counts.matmul_params(conf) == 1_342_406_656
    assert SSD_PER_TOKEN == 3_178_496
    mixer = 48 * 2048 * SSD_PER_TOKEN
    assert counts.mixer_flops(conf, 2048) == mixer
    assert counts.train_flops(conf, 4, 2048) == 6 * n * m + 3 * 4 * mixer
    assert counts.forward_flops(conf, 4, 2048) == 2 * n * m + 4 * mixer
    assert counts.flash_bound_s(conf, 4, 2048, PK) == 0.0
    head = 2 * m * 2048 * 50288
    assert counts.product_flops(train) == 3 * head
    bytes_fwd = 2 * (m * 2048 + 2048 * 50288 + m * 50288)
    assert counts.gemm_bound_s(train, PK) == pytest.approx(3 * max(head / 1e12, bytes_fwd / 1e9))


def test_the_scan_bound_by_hand():
    tags = dict(rows=4, seq=2048, heads=64, headdim=64, d_state=128, groups=1, chunk=256)
    ops = 4 * 2048 * SSD_PER_TOKEN
    nbytes = 2 * 4 * 2048 * (2 * 64 * 64 + 64 + 2 * 128)    # x, dt, B, C in; y out
    assert FS.ssd_bound_s(tags, PK) == pytest.approx(nbytes / 1e9)     # bytes bound here
    fast = {"bf16_flops": 1e12, "hbm_bytes_per_s": 1e15}
    assert FS.ssd_bound_s(tags, fast) == pytest.approx(ops / 1e12)    # operations there
    pk = counts.peaks()
    assert FS.ssd_bound_s(tags, pk) == pytest.approx(nbytes / pk["hbm_bytes_per_s"])
    # a short sequence: one chunk of the sequence's length
    short = dict(tags, seq=100)
    per = 100 * 128 + 64 * 100 * 64 + 4 * 64 * 128 * 64
    assert FS.ssd_bound_s(short, fast) == pytest.approx(4 * 100 * per / 1e12)


# ---------------------------------------------------------------------------
# The readers
# ---------------------------------------------------------------------------


TAGS = dict(rows=1, seq=1000, heads=2, headdim=10, d_state=5, groups=1, chunk=100)


def _span(i, name, device_s, **args):
    return types.SimpleNamespace(id=i, name=name, parent=None, host_s=device_s,
                                 device_s=device_s, args=args)


def _steps():
    out = []
    for k in range(2):
        out += [_span(10 * k + 1, "ssm.scan", 0.1, phase="forward", **TAGS),
                _span(10 * k + 2, "ssm.scan", 0.1, phase="recompute", **TAGS),
                _span(10 * k + 3, "ssm.scan.backward", 0.2, **TAGS),
                _span(10 * k + 4, "trainer.step", 1.0)]
    return out


def test_the_scan_readers_by_hand(monkeypatch):
    monkeypatch.setattr(trace, "profiled_spans", lambda: _steps(), raising=False)
    run = {"peaks": PK, "trace": {"units": []}, "window": {"seconds": 1.0, "units": []}}
    # (0.1 + 0.1 + 0.2) of 1.0, twice
    assert RUN.load_reader("ssd_share.train")(run) == pytest.approx(40.0)
    bound = FS.ssd_bound_s(TAGS, PK)
    assert bound == pytest.approx(2 * 1000 * (2 * 2 * 10 + 2 + 2 * 5) / 1e9)
    # the two forwards' bound three times, over every scan span's time
    assert RUN.load_reader("ssd_roofline.train")(run) == pytest.approx(100 * 2 * 3 * bound / 0.8)


@pytest.mark.parametrize("case", ["no_backward", "no_step", "no_device_time"])
def test_the_scan_readers_read_nothing_where_a_part_is_missing(monkeypatch, case):
    spans = {"no_backward": [s for s in _steps() if s.name != "ssm.scan.backward"],
             "no_step": [s for s in _steps() if s.name != "trainer.step"],
             "no_device_time": [_span(9, "ssm.scan", None, phase="forward", **TAGS)] + _steps()}
    monkeypatch.setattr(trace, "profiled_spans", lambda: spans[case], raising=False)
    run = {"peaks": PK}
    assert RUN.load_reader("ssd_share.train")(run) is None
    if case != "no_step":    # the roofline reads the scan's spans alone
        assert RUN.load_reader("ssd_roofline.train")(run) is None


def test_the_manifest_entry_of_the_cell():
    man = C.manifest()
    entry = {w["name"]: w for w in man["workloads"]}[CELL]
    assert (entry["config"], entry["traffic"], entry["chips"]) == ("mamba2-1.3b", "train", 1)
    e2e, layer = RUN.reported(man, CELL)
    assert {m["name"] for m in e2e} == {"setup_s", "train_tokens_per_s", "peak_mem_gb"}
    assert {m["name"] for m in layer} == {
        "idle_share.train", "mfu.train", "gemm_roofline.train", "optimizer_share.train",
        "host_share.train", "ssd_share.train", "ssd_roofline.train"}
    cell = C.load_cell(CELL)
    assert "first_grad_diff_gap" in cell.limits and cell.traffic["seq"] == 2048


# ---------------------------------------------------------------------------
# The reduced cell through the harness
# ---------------------------------------------------------------------------


def _numbers(**kw):
    res = RUN.run_cell(_reduced_cell(), SEED, 0, False, "cpu", **kw)
    return {k: c["value"] for k, c in res["checks"].items()}


def test_the_reduced_cell_against_the_program():
    """Readings at these sizes (two seeds): loss 2.6e-5-3.0e-5, grad norm
    1.3e-3-2.1e-3, first gradient 1.4e-3-2.2e-3, its difference
    0.032-0.041, change 2.7e-3-4.5e-3, decay share 0.096-0.10."""

    got = _numbers()
    assert got["loss_gap"] < 3e-4 and got["grad_norm_gap"] < 0.02
    assert got["first_grad_gap"] < 0.02 and got["change_gap"] < 0.03
    assert got["first_grad_diff_gap"] < 0.1
    # At these sizes the embedding's Adam step moves its decay share (as in
    # the dense family's reduced cells).
    assert got["decay_gap"] < 0.3


@pytest.mark.parametrize("kw,key,floor", [
    ({"control": True}, "first_grad_diff_gap", 0.2),     # fp8 operands: 0.35
    ({"fault": "half_batch"}, "first_grad_diff_gap", 0.5),   # 0.87-1.8
    ({"fault": "half_batch"}, "grad_norm_gap", 0.2),     # 0.39
])
def test_the_control_and_a_fault_read_outside(kw, key, floor):
    assert _numbers(**kw)[key] > floor


def test_a_traced_run_on_the_cpu_records_the_scan_and_reads_no_device_share():
    cell = _reduced_cell()
    res = RUN.run_cell(cell, SEED, 0.2, True, "cpu")
    spans = trace.profiled_spans()
    nl = cell.port_cfg.n_layers
    steps = len([s for s in spans if s.name == "trainer.step"])
    assert steps == RUN.TRACED_UNITS["train"]
    assert len([s for s in spans if s.name == "ssm.scan.backward"]) == steps * nl
    assert len([s for s in spans if s.name == "ssm.scan"]) == 2 * steps * nl
    assert "ssd_share.train" not in res["metrics"] and "ssd_roofline.train" not in res["metrics"]
    assert math.isfinite(res["checks"]["loss_gap"]["value"])
