"""The plain reference: its attention against the definition step by
step, and the reference against the program at the
reduced sizes on the CPU (the program computes in bfloat16, the
reference in float32: tolerances from bfloat16's rounding)."""

import math

import pytest
import torch

from cells import reduced_cell
from portbench import compare
from portbench import run as RUN
from portbench.families import dense
from portbench.reference import precision as P


def test_attention_equals_the_definition():
    g = torch.Generator().manual_seed(1)
    q = torch.randn(2, 10, 4, 8, generator=g)
    k, v = torch.randn(2, 10, 2, 8, generator=g), torch.randn(2, 10, 2, 8, generator=g)
    out = dense.causal_attention(q, k, v, "fp32", q_block=3)
    for h in range(4):
        kh, vh = k[:, :, h // 2], v[:, :, h // 2]
        sc = torch.einsum("bqd,bkd->bqk", q[:, :, h], kh) / math.sqrt(8)
        sc = sc.masked_fill(torch.ones(10, 10, dtype=torch.bool).triu(1), float("-inf"))
        torch.testing.assert_close(out[:, :, h], torch.softmax(sc, -1) @ vh)


def test_fp8_rounding_is_coarser_than_bf16():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(3))
    e8 = (P.round_fp8(x) - x).abs().max()
    e16 = (x.bfloat16().float() - x).abs().max()
    assert e8 > 4 * e16 and e8 < 0.1 * x.abs().max()


def _numbers(cell, seed, seconds):
    checks = RUN.run_cell(cell, seed, seconds, False, "cpu")["checks"]
    return {k: c["value"] for k, c in checks.items()}


@pytest.mark.parametrize("name", ["internlm2-1.8b.train", "internlm2-1.8b.train_mixed"])
def test_training_step_against_the_program(name):
    numbers = _numbers(reduced_cell(name), 2**33 + 3, 0)
    assert numbers["loss_gap"] < 1e-3
    assert numbers["grad_norm_gap"] < 0.02
    assert numbers["first_grad_gap"] < 0.05 and numbers["change_gap"] < 0.05
    assert numbers["first_grad_diff_gap"] < 0.1
    # At these sizes the embedding's and the head's Adam step moves their
    # decay share by about 10 / ‖w0‖ (‖w0‖ 2.6 here, 275 at full size).
    assert numbers["decay_gap"] < 0.6


def test_scoring_against_the_program():
    numbers = _numbers(reduced_cell("internlm2-1.8b.score"), 2**33 + 4, 0.3)
    assert numbers["logprob_gap_max"] < 0.05 and numbers["logprob_gap_rms"] < 0.01


def test_leaf_gaps_by_hand():
    ref = {"a": 1.0, "b": 2.0, "c": 100.0}     # the median leaf's norm is 2
    assert max(compare.leaf_gaps({"a": 1.1, "b": 2.0, "c": 100.0}, ref)) == pytest.approx(0.05)
    assert max(compare.leaf_gaps({"a": 1.0, "b": 2.0, "c": 90.0}, ref)) == pytest.approx(0.1)
    assert max(compare.leaf_gaps({"a": 1.0, "b": 2.0}, ref)) == math.inf
    assert compare.whole_leaves({"w[0]": 3.0, "w[1]": 4.0, "x": 1.0}) == {"w": 5.0, "x": 1.0}


def test_first_gradient_difference_by_hand():
    side = {"loss": [1.0], "grad_norm": [1.0], "first_grad": {"w[0]": 3.0, "w[1]": 4.0, "x": 0.5},
            "change": {"w[0]": 1.0, "w[1]": 1.0, "x": 1.0},
            "decay_share": {"w": 0.0, "x": 0.0}}
    # w's stack: a difference of (0.6, 0.8), norm 1, over the leaf's norm 5;
    # x: 0.1 over 0.5, the worst leaf, though x is under the median.
    ref = dict(side, first_grad_diff={"w[0]": 0.6, "w[1]": 0.8, "x": 0.1})
    assert compare.training_numbers(side, ref)["first_grad_diff_gap"] == pytest.approx(0.2)
    ref = dict(side, first_grad_diff={"w[0]": 0.6, "w[1]": 0.8})     # x never compared
    assert compare.training_numbers(side, ref)["first_grad_diff_gap"] == math.inf
