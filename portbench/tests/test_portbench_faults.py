"""A run with the timed path broken underneath comes out not correct, for
each fault a cell can have; the control (the reference in fp8 in the
program's place) reads far above the program.  On the CPU at the reduced
sizes, the chip's look skipped (``run_cell`` on ``cpu``)."""

import pytest

from cells import reduced_cell
from portbench import run as RUN

SEED = 2**32 + 99


@pytest.mark.parametrize("name,fault", [
    ("internlm2-1.8b.train", "half_batch"), ("internlm2-1.8b.train", "frozen"),
    ("internlm2-1.8b.train", "no_decay"), ("internlm2-1.8b.train_mixed", "no_decay"),
    ("internlm2-1.8b.score", "half_batch"), ("internlm2-1.8b.score", "altered"),
])
def test_a_planted_fault_is_not_correct(name, fault):
    cell = reduced_cell(name)
    res = RUN.run_cell(cell, SEED, 0.2, False, "cpu", fault=fault)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_without_decay_the_decay_share_reads_one_apart():
    # Sound, the decay share is widest apart in the embedding (0.27 at these
    # sizes, where its Adam step is large against its decay); without the
    # decay every decayed leaf reads about 1 apart.
    cell = reduced_cell("internlm2-1.8b.train")
    sound = RUN.run_cell(cell, SEED, 0, False, "cpu")["checks"]["decay_gap"]["value"]
    fault = RUN.run_cell(cell, SEED, 0, False, "cpu", fault="no_decay")["checks"]
    assert fault["decay_gap"]["value"] == pytest.approx(1.0, abs=0.15)
    assert fault["decay_gap"]["value"] > 3 * sound


@pytest.mark.parametrize("name", ["internlm2-1.8b.train", "internlm2-1.8b.score"])
def test_the_control_reads_far_above_the_program(name):
    cell = reduced_cell(name)
    prog = RUN.run_cell(cell, SEED, 0.2, False, "cpu")["checks"]
    ctrl = RUN.run_cell(cell, SEED, 0.2, False, "cpu", control=True)["checks"]
    key = "first_grad_gap" if "train" in name else "logprob_gap_rms"
    assert ctrl[key]["value"] > 3 * prog[key]["value"]


@pytest.mark.parametrize("name", ["internlm2-1.8b.train", "internlm2-1.8b.train_mixed"])
def test_the_first_gradient_difference_reads_the_control_and_half_batch_apart(name):
    # Reduced, seed 2**32 + 99: the program 0.032, the control 0.36, half
    # the batch 1.03; a state left unchanged reads 1 (the same step again
    # puts nothing into its first moment).
    cell = reduced_cell(name)
    runs = {"program": {}, "control": {"control": True}, "half": {"fault": "half_batch"},
            "frozen": {"fault": "frozen"}}
    read = {k: RUN.run_cell(cell, SEED, 0, False, "cpu", **kw)["checks"]["first_grad_diff_gap"]
            ["value"] for k, kw in runs.items()}
    assert read["program"] < 0.1
    assert read["control"] > 5 * read["program"] and read["half"] > 10 * read["program"]
    assert read["frozen"] == pytest.approx(1.0)


def test_the_result_line():
    cell = reduced_cell("internlm2-1.8b.score")
    res = RUN.run_cell(cell, SEED, 0.3, False, "cpu")
    assert list(res)[:3] == ["correct", "attempted", "failed"] and list(res)[-1] == "checks"
    assert set(res["checks"]) == set(cell.limits)
    assert set(res["metrics"]) == {"setup_s", "score_tokens_per_s", "score_p95_ms",
                                   "peak_mem_gb"}
    assert res["attempted"] >= 1 and res["device"]["count"] == 1


def test_a_training_result_lists_the_first_gradient_difference_unlimited():
    cell = reduced_cell("internlm2-1.8b.train")
    checks = RUN.run_cell(cell, SEED, 0, False, "cpu")["checks"]
    assert "first_grad_diff_gap" not in cell.limits
    assert checks["first_grad_diff_gap"]["limit"] is None
    assert 0 < checks["first_grad_diff_gap"]["value"] < 0.1
