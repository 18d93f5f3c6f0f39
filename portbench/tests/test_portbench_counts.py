"""The frozen counts and the readers' arithmetic, on hand-worked shapes."""

import json
import math
import os

import pytest

from portbench import counts, readers
from portbench import cell as C
from portbench.tracing import summarise, union

PK = {"bf16_flops": 1e12, "hbm_bytes_per_s": 1e9}
HERE = os.path.dirname(C.__file__)


def _conf(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)


def test_gemm_launches_per_step():
    il = _conf("internlm2-1.8b")
    m = 4 * 2048
    # The funnel's counters on the card (PERF.md, runs AP and BN): 675 a
    # training step and 169 a forward for internlm2-1.8b.
    assert counts.launches(counts.gemm_products(il, m, train=True)) == 675
    assert counts.launches(counts.gemm_products(il, m, train=False)) == 169


def test_matmul_params():
    il = _conf("internlm2-1.8b")
    d, f, layers, v = 2048, 8192, 24, 92544
    per = d * 2048 + 2 * d * 1024 + 2048 * d + 3 * d * f
    assert counts.matmul_params(il) == layers * per + d * v


def test_flops_by_hand():
    il = _conf("internlm2-1.8b")
    n = counts.matmul_params(il)
    attn = 24 * 2 * 16 * 128 * 2048 * 2048
    assert counts.train_flops(il, 4, 2048) == 6 * n * 8192 + 3 * 4 * attn
    assert counts.forward_flops(il, 4, 2048) == 2 * n * 8192 + 4 * attn


def test_frozen_cell_counts():
    with open(os.path.join(HERE, "counts", "cells.json")) as f:
        frozen = json.load(f)
    pk = counts.peaks()
    for name, rec in frozen["cells"].items():
        conf = _conf(rec["config"])
        m = rec["rows"] * rec["seq"]
        prods = counts.gemm_products(conf, m, train=rec["train"])
        flops = (counts.train_flops if rec["train"] else counts.forward_flops)(
            conf, rec["rows"], rec["seq"])
        assert counts.launches(prods) == rec["gemm_launches"], name
        assert counts.product_flops(prods) == rec["gemm_flops"], name
        assert flops == rec["model_flops"], name
        assert counts.gemm_bound_s(prods, pk) == pytest.approx(rec["gemm_bound_s"], rel=1e-12)
        assert counts.flash_bound_s(conf, rec["rows"], rec["seq"], pk) == pytest.approx(
            rec["flash_bound_s"], rel=1e-12, abs=0)


def test_roofline_bound_by_hand():
    # 1000 x 1000 x 1000: 2e9 operations (2 ms at 1e12), 6e6 bytes (6 ms at 1e9)
    assert counts.gemm_bound_s([(1000, 1000, 1000, 1)], PK) == pytest.approx(6e-3)
    # 10000^3: 2e12 operations (2 s), 6e8 bytes (0.6 s)
    assert counts.gemm_bound_s([(10000, 10000, 10000, 2)], PK) == pytest.approx(4.0)


def test_readers_by_hand():
    run = {"window": {"seconds": 2.0, "units": [{"model_flops": 5e11, "tokens": 100}] * 2},
           "peaks": PK,
           "trace": {"busy_s": 0.75, "window_s": 1.0, "family_s": {"gemm": 0.5, "flash": 0.0},
                     "units": [{"gemm_bound_s": 0.2, "flash_bound_s": 0.1, "tokens": 100}] * 2,
                     "streams": {"gemm": {1: [(0, 10)], 2: [(5, 15)]}}}}
    assert readers.mfu(run) == pytest.approx(50.0)
    # busy 0.75 s for 200 traced tokens against 2 s for 200 in the window
    assert readers.idle_share(run) == pytest.approx(62.5)
    assert readers.roofline(run, "gemm", "gemm_bound_s") == pytest.approx(80.0)
    assert readers.roofline(run, "flash", "flash_bound_s") is None    # nothing to read
    assert readers.overlap(run, "gemm") == pytest.approx(50.0)        # 5 of 10 on each
    assert readers.idle_share(dict(run, trace=None)) is None


def test_union_and_gaps():
    assert union([(0, 2), (1, 3), (5, 6)]) == [[0, 3], [5, 6]]
    s = summarise([("gemm_kernel<1>", 0, 2, 7), ("elementwise", 1, 3, 7), ("copy", 5, 6, 7)],
                  [("aten::mm", 0, 1), ("cudaStreamSynchronize", 3, 5), ("aten::item", 6, 10)],
                  (0, 10))
    assert s["busy_s"] == pytest.approx(4e-6) and s["window_s"] == pytest.approx(1e-5)
    assert s["family_s"]["gemm"] == pytest.approx(2e-6)
    assert s["breakdown"]["idle_gaps"][0] == ["aten::item", pytest.approx(4e-6)]
    assert s["breakdown"]["idle_gaps"][1] == ["cudaStreamSynchronize", pytest.approx(2e-6)]
    assert [n for n, _ in s["breakdown"]["device_ops"]][0] in ("gemm_kernel<1>", "elementwise")
    assert math.isclose(sum(t for _, t in s["breakdown"]["device_ops"]), 5e-6)
