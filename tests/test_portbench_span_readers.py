"""The benchmark's readers of the program's spans (``portbench/spans.py``,
``portbench/metrics/*.py`` with ``source: program_span``): each on
synthetic span lists, None wherever there is nothing to read, and all five
through a traced ``run_cell`` of the reduced cells on the CPU."""

import importlib.util
import os
import sys
import types

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import cell as C  # noqa: E402
from portbench import run as RUN  # noqa: E402
from portbench import spans as SP  # noqa: E402
from repro_torch.observability import trace  # noqa: E402

PEAKS = {"bf16_flops": 1e12, "hbm_bytes_per_s": 1e9}
SPAN_METRICS = {m["name"]: m for m in C.manifest()["per_layer"] if m["source"] == "program_span"}
SEED = 2**32 + 99


def _span(i, name, host_s, device_s, parent=None):
    return types.SimpleNamespace(id=i, name=name, parent=parent, host_s=host_s,
                                 device_s=device_s, args={})


def _mixed_steps():
    """Two mixed steps: pods of 0.6 / 0.4 s and 0.5 / 0.5 s, each under
    its step (the pods nested one level deeper in the second)."""

    return [
        _span(2, "class_sharded.pod", 0.1, 0.6, parent=1),
        _span(3, "class_sharded.pod", 0.1, 0.4, parent=1),
        _span(4, "trainer.optimizer", 0.01, 0.1, parent=1),
        _span(1, "trainer.step", 0.3, 1.2),
        _span(7, "class_sharded.pod", 0.1, 0.5, parent=6),
        _span(8, "class_sharded.pod", 0.1, 0.5, parent=6),
        _span(6, "outer", 0.2, 1.0, parent=5),
        _span(9, "trainer.optimizer", 0.01, 0.2, parent=5),
        _span(5, "trainer.step", 0.5, 0.8),
    ]


def _run(units=()):
    return {"window": {"seconds": 1.0, "units": list(units)}, "peaks": PEAKS,
            "trace": {"units": list(units), "busy_s": 1.0, "window_s": 1.0}}


@pytest.fixture
def given(monkeypatch):
    def feed(spans):
        monkeypatch.setattr(trace, "profiled_spans", lambda: list(spans), raising=False)
    return feed


def test_the_manifest_lists_five_span_readers():
    # PR 29's five, and the Mamba2 scan's two (``tests/test_portbench_ssm.py``)
    assert sorted(SPAN_METRICS) == ["host_share.score", "host_share.train",
                                    "optimizer_share.train", "pod_balance.train",
                                    "prefill_mfu.score", "ssd_roofline.train", "ssd_share.train"]
    assert all(m["unit"] == "%" and m["workloads"] for m in SPAN_METRICS.values())


def test_training_readers_by_hand(given):
    given(_mixed_steps())
    # optimizer 0.1 + 0.2 of steps 1.2 + 0.8; host 0.3 + 0.5 of the same
    assert RUN.load_reader("optimizer_share.train")(_run()) == pytest.approx(15.0)
    assert RUN.load_reader("host_share.train")(_run()) == pytest.approx(40.0)
    # min / max a step: (0.4 + 0.5) / (0.6 + 0.5)
    assert RUN.load_reader("pod_balance.train")(_run()) == pytest.approx(100 * 0.9 / 1.1)


def test_scoring_readers_by_hand(given):
    given([_span(1, "model.prefill", 0.01, 0.2), _span(2, "model.prefill", 0.03, 0.3),
           _span(3, "other", 1.0, 1.0)])
    units = [{"model_flops": 1e11, "tokens": 10}, {"model_flops": 4e11, "tokens": 40}]
    # 5e11 FLOPs over 0.5 s at 1e12 FLOP/s
    assert RUN.load_reader("prefill_mfu.score")(_run(units)) == pytest.approx(100.0)
    assert RUN.load_reader("host_share.score")(_run(units)) == pytest.approx(8.0)


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
@pytest.mark.parametrize("case", ["empty", "no_device_time", "other_names"])
def test_none_where_there_is_nothing_to_read(given, name, case):
    spans = {"empty": [],
             "no_device_time": [_span(s.id, s.name, s.host_s, None, s.parent)
                                for s in _mixed_steps()]
             + [_span(20, "model.prefill", 0.1, None)],
             "other_names": [_span(1, "engine.step", 0.1, 0.2)]}[case]
    given(spans)
    assert RUN.load_reader(name)(_run([{"model_flops": 1e11, "tokens": 1}])) is None


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_none_from_a_program_without_profiled_spans(monkeypatch, name):
    monkeypatch.delattr(trace, "profiled_spans")
    assert SP.program_spans() is None
    assert RUN.load_reader(name)(_run([{"model_flops": 1e11, "tokens": 1}])) is None


def test_a_pod_without_a_step_is_left_out():
    spans = [_span(2, "class_sharded.pod", 0.1, 0.6, parent=9),
             _span(3, "class_sharded.pod", 0.1, 0.4, parent=9)]
    assert SP.balance(spans) is None
    assert SP.balance(spans + [_span(9, "trainer.step", 1.0, 1.0)]) == pytest.approx(100 * 4 / 6)


def _reduced_cell(name):
    spec = importlib.util.spec_from_file_location(
        "portbench_test_cells", os.path.join(ROOT, "portbench", "tests", "cells.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.reduced_cell(name)


@pytest.mark.parametrize("name", ["internlm2-1.8b.train_mixed", "internlm2-1.8b.score"])
def test_a_traced_run_on_the_cpu_reads_every_span_metric(name):
    cell = _reduced_cell(name)
    res = RUN.run_cell(cell, SEED, 0.2, True, "cpu")
    spans = trace.profiled_spans()
    want = "trainer.step" if "train" in name else "model.prefill"
    assert [s for s in spans if s.name == want] and all(s.device_s is None for s in spans)
    _, layer = RUN.reported(C.manifest(), cell.name)
    run = {"trace": {"units": [{"model_flops": 1.0}]}, "peaks": PEAKS}
    for m in layer:
        if m["name"] in SPAN_METRICS:   # no device time on the CPU: nothing to read
            assert RUN.load_reader(m["name"])(run) is None
            assert m["name"] not in res["metrics"]
    assert res["attempted"] >= 1 and res["breakdown"]["idle_gaps"] is not None


def test_an_idle_gap_inside_a_span_is_named_after_it():
    """The harness names a gap after the innermost host event at its
    middle: the program's span is one, so a gap with no aten op there
    reads as the span (on the CPU the whole traced window is one gap)."""

    import time

    from portbench import tracing

    def unit():
        with trace.span("layer.waits"):
            time.sleep(0.05)
        return [{}]

    out = tracing.trace(unit)
    assert out["breakdown"]["idle_gaps"][0][0] == "layer.waits"
