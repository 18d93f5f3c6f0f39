"""The port's spans: ids, the profiler's clock, device time, and the span
sites at the trainer's, the class-sharded step's and the prefill's layer
boundaries.

On the CPU (``device_s`` stays None here); the card's side, device time
and the profiler's device events, is in ``tests/test_torch_cuda.py``.
"""

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.launch import train as train_cli
from repro_torch.models import model_zoo as Z
from repro_torch.observability import metrics as MET
from repro_torch.observability import trace as T
from repro_torch.runtime.trainer import Trainer, TrainerConfig

CFG = get_config("internlm2-1.8b").reduced()


@pytest.fixture(autouse=True)
def _tracing_off():
    """Each test starts and ends with tracing off and no open session."""

    T.disable()
    T.profiled_spans()
    yield
    T.disable()


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof, T.profiled_spans()


def _children(spans, parent):
    return [s.name for s in spans if s.parent == parent.id]


# ---------------------------------------------------------------------------
# The span system
# ---------------------------------------------------------------------------


def test_spans_have_ids_and_their_parents_ids():
    T.enable()
    try:
        with T.span("step", k=1) as outer:
            with T.span("step") as inner:
                T.instant("mark")
            with T.span("other"):
                pass
    finally:
        buf = T.disable()
    ev = {e.id: e for e in buf.events}
    assert len(ev) == 4 and outer.id != inner.id
    assert ev[inner.id].parent == outer.id and ev[inner.id].parent_name == "step"
    assert ev[outer.id].parent is None and ev[outer.id].args == {"k": 1}
    mark = next(e for e in buf.events if e.name == "mark")
    assert mark.parent == inner.id
    other = next(e for e in buf.events if e.name == "other")
    assert other.parent == outer.id and other.host_s == other.dur >= 0


def test_spans_are_live_under_a_profiler_and_no_ops_after():
    assert T.span("idle") is T._NOOP

    def body():
        with T.span("layer.a", cat="test", rows=2):
            with T.span("layer.b"):
                torch.ones(8).sum()
        return T.enabled()

    was_enabled, _, spans = _profiled(body)
    assert not was_enabled and not T.enabled()
    assert [s.name for s in spans] == ["layer.b", "layer.a"]
    b, a = spans
    assert b.parent == a.id and a.args == {"rows": 2} and a.cat == "test"
    assert T.span("after") is T._NOOP
    assert [s.name for s in T.profiled_spans()] == ["layer.b", "layer.a"]
    with T.span("after"):
        pass
    assert [s.name for s in T.profiled_spans()] == ["layer.b", "layer.a"]


def test_the_next_session_starts_a_new_list():
    def one(name):
        with T.span(name):
            pass

    _profiled(lambda: one("first"))
    _, _, spans = _profiled(lambda: one("second"))
    assert [s.name for s in spans] == ["second"]


def test_the_mirrored_range_is_a_cpu_function_event():
    def body():
        with T.span("layer.mirrored"):
            torch.ones(4).add_(1)

    _, prof, spans = _profiled(body)
    mirrored = [e for e in prof.events() if e.name == "layer.mirrored"]
    assert len(mirrored) == 1
    assert mirrored[0].device_type == DeviceType.CPU
    assert mirrored[0].is_user_annotation is False
    inner = [e for e in prof.events() if e.name == "aten::add_"]
    assert inner and mirrored[0].time_range.start <= inner[0].time_range.start
    assert inner[0].time_range.end <= mirrored[0].time_range.end
    assert spans[0].device_s is None


def test_chrome_trace_carries_device_ms_where_known():
    T.enable()
    try:
        with T.span("outer"):
            with T.span("inner"):
                pass
    finally:
        buf = T.disable()
    inner = next(e for e in buf.events if e.name == "inner")
    inner.device_s = 0.0025
    recs = {r["name"]: r for r in buf.chrome_trace()["traceEvents"]}
    assert recs["inner"]["args"] == {"parent": "outer", "device_ms": 2.5}
    assert recs["outer"]["args"] == {}


def test_a_failing_span_is_recorded_with_its_error():
    with pytest.raises(ValueError):
        with profile(activities=[ProfilerActivity.CPU]):
            with T.span("layer.fails"):
                raise ValueError("x")
    (s,) = T.profiled_spans()
    assert s.args == {"error": "ValueError"} and T.current_span() is None


# ---------------------------------------------------------------------------
# The span sites
# ---------------------------------------------------------------------------


def _trainer(tmp_path, **kw):
    return Trainer(CFG, tcfg=TrainerConfig(steps=1, global_batch=4, seq_len=32,
                                           ckpt_dir=str(tmp_path), **kw), device="cpu")


def test_train_step_is_a_step_of_forward_backward_optimizer(tmp_path):
    trainer = _trainer(tmp_path)
    batch, _ = trainer.next_batch(0)
    _, _, spans = _profiled(lambda: trainer.train_step(batch))
    (step,) = [s for s in spans if s.name == "trainer.step"]
    assert step.args == {"step": 0, "tokens": 4 * 32} and step.parent is None
    assert _children(spans, step) == ["trainer.forward", "trainer.backward",
                                      "trainer.optimizer"]
    opt = next(s for s in spans if s.name == "trainer.optimizer")
    assert opt.args == {"leaves": sum(1 for _ in _leaves(trainer.params))}
    assert all(s.device_s is None for s in spans)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def test_micro_batches_tag_their_forward_and_backward(tmp_path):
    trainer = _trainer(tmp_path, n_micro=2)
    batch, _ = trainer.next_batch(0)
    _, _, spans = _profiled(lambda: trainer.train_step(batch))
    fb = [(s.name, s.args) for s in spans if s.name in ("trainer.forward", "trainer.backward")]
    assert fb == [("trainer.forward", {"micro": 0}), ("trainer.backward", {"micro": 0}),
                  ("trainer.forward", {"micro": 1}), ("trainer.backward", {"micro": 1})]


def test_class_sharded_step_spans_each_pod_then_the_epilogue(tmp_path):
    args = train_cli.build_parser().parse_args([
        "--arch", "internlm2-1.8b", "--reduced", "--device", "cpu", "--steps", "1",
        "--seq", "32", "--global-batch", "4", "--heterogeneous", "--class-sharded", "on",
        "--ckpt-dir", str(tmp_path)])
    trainer = train_cli.make_trainer(args)
    batch, _ = trainer.next_batch(0)
    _, _, spans = _profiled(lambda: trainer.train_step(batch))
    (step,) = [s for s in spans if s.name == "trainer.step"]
    assert _children(spans, step) == ["class_sharded.pod", "class_sharded.pod",
                                      "class_sharded.epilogue", "trainer.optimizer"]
    pods = [s for s in spans if s.name == "class_sharded.pod"]
    assert [(p.args["pod"], p.args["device_class"]) for p in pods] == [(0, "big"), (1, "little")]
    assert all(p.args["backend"] == "matmul" and p.args["rows"] >= 1 for p in pods)
    assert sum(p.args["rows"] for p in pods) == batch["tokens"].shape[0]
    for p in pods:
        assert _children(spans, p) == ["trainer.forward", "trainer.backward"]


def test_run_records_a_step_span_and_no_trainer_metrics(tmp_path):
    trainer = _trainer(tmp_path)
    T.enable()
    try:
        trainer.run(1)
    finally:
        buf = T.disable()
    steps = [e for e in buf.events if e.name == "trainer.step"]
    assert len(steps) == 1 and steps[0].args == {"step": 0, "tokens": 128}
    assert not {"trainer_steps_total", "trainer_step_seconds"} & set(MET.REGISTRY.snapshot())


def test_prefill_is_a_model_prefill_span():
    params = Z.init_params(CFG, torch.Generator().manual_seed(0), "cpu", dtype=torch.bfloat16)
    prefill = Z.make_prefill_fn(CFG)
    tokens = torch.randint(0, CFG.vocab, (3, 16))
    logits, _, spans = _profiled(lambda: prefill(params, {"tokens": tokens}))
    assert logits.shape[:2] == (3, 16)
    (s,) = spans
    assert s.name == "model.prefill" and s.args == {"rows": 3, "length": 16}
    assert s.device_s is None and s.host_s > 0
