"""Port vs reference: the class-sharded mixed step in serving — the engine,
the one-shot path and the CLI under ``class_sharded="on"`` — on the CPU at
reduced sizes.

The reduced internlm2 serves the same numpy-drawn prompts in both
packages (the reference's weights carried over by
``convert.params_from_jax``); the reference's engine takes its mixed step
on the 8 forced host devices of ``tests/conftest.py`` (``"auto"``).  The
port's big pod runs ``gemm_cuda`` and its little pod ``gemm_cuda_lean``
(``backend="cuda"``: their plain versions on the CPU).

Within the port the contracts are bitwise: the mixed engine's tokens
equal the mixed one-shot path's, the paged mixed engine's equal the
dense mixed engine's through the gather route, and the reduced
qwen2-moe's mixed logits equal each pod's rows run alone under its own
class (MoE capacity routing stays within a pod, as the reference's
``shard_map`` keeps it).  Against the reference, greedy tokens are held
under ``test_torch_serving.py``'s ``MARGIN`` rule: each row up to its
first step whose top-2 logit gap is below ``MARGIN`` (the packages round
bf16 at other places, logits within rtol = atol = 2e-2).
"""

import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.asymmetric import AsymmetricMesh as JMesh
from repro.core.asymmetric import biglittle_classes as jax_classes
from repro.launch import serve as jax_serve
from repro.models import model_zoo as JZ
from repro.runtime.serving import ServingEngine as JaxEngine

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.asymmetric import AsymmetricMesh, DeviceClass, biglittle_classes
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model_zoo as Z
from repro_torch.observability import trace as T
from repro_torch.runtime.serving import ServingEngine

from test_torch_serving import MARGIN, _reference_margins

torch.set_num_threads(1)

ARCH = "internlm2-1.8b"
B, PLEN, GEN = 6, 6, 6


@pytest.fixture(scope="module")
def model():
    jcfg = jax_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jparams = JZ.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (B, PLEN), dtype=np.int32)
    return jcfg, jparams, cfg, params, prompts


def _mesh(backend="cuda"):  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    return AsymmetricMesh(biglittle_classes(chips_per_pod=1), strategy="ca-das", batch_tile=1,
                          backend=backend)


def _engine(cfg, params, *, asym=None, seq_cap=PLEN + GEN, **kw):
    asym = asym or _mesh()
    kw.setdefault("slots_per_pod", asym.batch_layout(B).c_max)
    return ServingEngine(cfg, params, asym, seq_cap=seq_cap, device="cpu", class_sharded="on",
                         pod_time_hook=None, **kw)


def _args(*extra):
    return serve.build_parser().parse_args(["--device", "cpu", "--arch", ARCH, "--reduced",
                                            "--batch", str(B), "--prompt-len", str(PLEN),
                                            "--gen-len", str(GEN), *extra])


@pytest.mark.parametrize("route", ["matmul", "cuda"])
def test_mixed_engine_equals_mixed_one_shot_bitwise(model, route):
    *_, cfg, params, prompts = model
    eng = _engine(cfg, params, asym=_mesh(route))
    assert eng.mixed and eng.mesh.shape["pod"] == 2
    got = eng.generate(prompts, GEN)
    asym = _mesh(route)
    layout = asym.batch_layout(B)
    padded, order = serve.pad_requests(prompts, layout)
    step = serve.mixed_decode_step(cfg, asym, make_host_mesh(pod=2, device="cpu"), len(padded),
                                   PLEN + GEN)
    out, timings = serve.generate(cfg, params, padded, GEN, PLEN + GEN, device="cpu", decode=step,
                                  prefill=Z.bulk_prefill_from_decode(step))
    assert np.array_equal(got, out[order]), route
    assert timings["decode_steps"] == GEN - 1
    want = [(0, "big", route), (1, "little", route + ("_lean" if route == "cuda" else ""))]
    assert [(p.pod, p.device_class, p.backend) for p in eng.provenance] == want


def test_paged_mixed_engine_equals_dense_mixed_engine_bitwise(model):
    """More requests than slots, mixed lengths and an EOS: slots are reused
    and pages freed mid-stream; each pod's table holds pod-local page ids
    inside its partition."""

    *_, cfg, params, prompts = model
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, cfg.vocab, int(rng.integers(2, 7)), dtype=np.int32), int(n))
            for n in rng.integers(1, 7, size=14)]
    out = {}
    for paged in ("off", "on"):
        eng = _engine(cfg, params, slots_per_pod=3, paged=paged, page_size=4,
                      eos_id=int(prompts[0, 0]))
        for prompt, n in reqs:
            eng.submit(prompt, n)
        if paged == "on":
            tables = []
            real = eng._step_table
            eng._step_table = lambda: tables.append(real()) or tables[-1]
        done = eng.run()
        out[paged] = sorted((c.rid, c.tokens.tolist(), c.stop) for c in done)
        if paged == "on":
            spec = eng.pool.spec
            for t in tables:  # pod-local ids inside the partition, or out of range (SENTINEL)
                assert (((t >= 0) & (t < spec.pages_per_pod)) | (t >= spec.n_pages)).all()
            assert any((t[eng.c_max:] < spec.pages_per_pod).any() for t in tables)  # pod 1 reads
            kv = eng.kv_stats()
            assert kv["pages_live"] == kv["phantom_pages"]
    assert len(out["on"]) == len(reqs)
    assert out["on"] == out["off"]


def test_mixed_engine_tokens_match_reference_mixed_engine(model):
    jcfg, jparams, cfg, params, prompts = model
    jasym = JMesh(jax_classes(chips_per_pod=1), strategy="ca-das", batch_tile=1)
    jeng = JaxEngine(jcfg, jparams, jasym, seq_cap=PLEN + GEN,
                     slots_per_pod=jasym.batch_layout(B).c_max, class_sharded="auto")
    assert jeng.mixed
    want = jeng.generate(prompts, GEN)
    eng = _engine(cfg, params)
    got = eng.generate(prompts, GEN)
    assert got.shape == want.shape == (B, PLEN + GEN)
    margins = _reference_margins(jcfg, jparams, want)
    compared = 0
    for row in range(B):
        narrow = np.nonzero(margins[row] < MARGIN)[0]
        upto = narrow[0] + 1 if len(narrow) else GEN
        wide = upto - (1 if len(narrow) else 0)
        assert np.array_equal(got[row, PLEN:PLEN + wide], want[row, PLEN:PLEN + wide]), row
        compared += wide
    assert compared >= B * GEN // 3, f"only {compared} tokens had wide margins"
    placed = lambda e: sorted((c.rid, c.slot, c.pod, c.device_class) for c in e.completions)  # noqa: E731
    assert placed(eng) == placed(jeng)
    assert [(p.pod, p.device_class) for p in eng.provenance] \
        == [(p.pod, p.device_class) for p in jeng.provenance]


def test_moe_mixed_one_shot_routes_within_each_pod():
    """Reduced qwen2-moe: the mixed step's logits equal each pod's rows run
    alone under that pod's class and concatenated, bitwise — an MoE group
    never spans two pods."""

    cfg = get_config("qwen2-moe-a2.7b").reduced()
    params = Z.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    asym = _mesh()
    layout = asym.batch_layout(B)
    prompts = np.random.default_rng(4).integers(0, cfg.vocab, (B, PLEN), dtype=np.int32)
    padded, _ = serve.pad_requests(prompts, layout)
    rows, seq = len(padded), PLEN + 2
    step = serve.mixed_decode_step(cfg, asym, make_host_mesh(pod=2, device="cpu"), rows, seq)
    with torch.no_grad():
        mixed, _ = Z.bulk_prefill_from_decode(step)(
            params, {"tokens": torch.from_numpy(padded)},
            Z.init_decode_state(cfg, rows, seq, device="cpu"), 0)
        alone = []
        c = layout.c_max
        for pod, cls in enumerate(("big", "little")):
            with asym.execution_context(cls):
                lg, _ = Z.bulk_prefill_from_decode(Z.make_decode_fn(cfg))(
                    params, {"tokens": torch.from_numpy(padded[pod * c:(pod + 1) * c])},
                    Z.init_decode_state(cfg, c, seq, device="cpu"), 0)
            alone.append(lg)
        whole, _ = Z.bulk_prefill_from_decode(Z.make_decode_fn(cfg))(
            params, {"tokens": torch.from_numpy(padded)},
            Z.init_decode_state(cfg, rows, seq, device="cpu"), 0)
    assert torch.equal(mixed, torch.cat(alone))
    assert mixed.shape == whole.shape


def test_mixed_engine_telemetry_names_both_classes(model):
    *_, cfg, params, prompts = model
    eng = _engine(cfg, params, paged="on", page_size=4)
    T.enable()
    try:
        eng.generate(prompts[:4], 3)
    finally:
        buf = T.disable()
    shards = [e.args for e in buf.events if e.name == "engine.decode_shard"]
    steps = [e for e in buf.events if e.name == "engine.decode_step"]
    assert len(shards) == 2 * len(steps) and steps
    assert {(s["device_class"], s["backend"]) for s in shards} \
        == {("big", "cuda"), ("little", "cuda_lean")}
    traced = [e.args for e in buf.events if e.name == "execution.trace"]
    assert {t["device_class"] for t in traced} == {"big", "little"} and all(t["mixed"] for t in traced)


def test_engine_class_sharded_rules(model, monkeypatch):
    *_, cfg, params, _ = model
    one = AsymmetricMesh([DeviceClass("only", n_pods=2)], batch_tile=1)
    with pytest.raises(ValueError, match="class_sharded='on'"):
        ServingEngine(cfg, params, one, seq_cap=8, device="cpu", class_sharded="on")
    with pytest.raises(ValueError, match="class_sharded='sometimes'"):
        ServingEngine(cfg, params, _mesh(), seq_cap=8, device="cpu", class_sharded="sometimes")
    # "auto": the reference takes the mixed step with a device per pod; the
    # port never gives a pod a card of its own, so auto is off on any count.
    for n_dev in (0, 1, 2, 4):
        monkeypatch.setattr(torch.cuda, "device_count", lambda n=n_dev: n)
        eng = ServingEngine(cfg, params, _mesh(), seq_cap=8, device="cpu", pod_time_hook=None)
        assert not eng.mixed and eng.provenance is None and eng.mesh is None, n_dev
    on = ServingEngine(cfg, params, _mesh(), seq_cap=8, device="cpu", pod_time_hook=None,
                       class_sharded="on")
    assert on.mixed and on.mesh.shape == {"pod": 2, "data": 1, "model": 1}
    assert [p.device_class for p in on.provenance] == ["big", "little"]
    assert not ServingEngine(cfg, params, _mesh(), seq_cap=8, device="cpu",
                             class_sharded="off").mixed


def _reference_summary(monkeypatch, capsys, *extra):
    argv = ["serve", "--arch", ARCH, "--reduced", "--batch", "4", "--prompt-len", "4",
            "--gen-len", "4", "--class-sharded", "on", *extra]
    monkeypatch.setattr("sys.argv", argv)
    jax_serve.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("extra", [(), ("--paged", "on"), ("--one-shot",)],
                         ids=["engine", "paged", "one-shot"])
def test_serve_cli_class_sharded_on(monkeypatch, capsys, extra):
    want = _reference_summary(monkeypatch, capsys, *extra)
    got = serve.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--batch", "4",
                      "--prompt-len", "4", "--gen-len", "4", "--class-sharded", "on", *extra])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(got))
    assert set(want) <= set(got)
    assert got["class_sharded"] is want["class_sharded"] is True
    assert got["device_class"] == want["device_class"] == "mixed"
    assert [list(s[:3]) for s in got["shard_classes"]] == [s[:3] for s in want["shard_classes"]]
    assert got["exec_backend"] == "+".join(sorted({s[3] for s in got["shard_classes"]}))
    for key in ("arch", "path", "batch", "generated"):
        assert got[key] == want[key], key


def test_serve_cli_refuses_class_sharded_with_a_device_class():
    with pytest.raises(SystemExit, match="cannot be combined with --device-class"):
        serve.serve(_args("--one-shot", "--class-sharded", "on", "--device-class", "little"))
    with pytest.raises(SystemExit, match="class_sharded='on' needs more than one device class"):
        serve._one_shot(None, None, AsymmetricMesh([DeviceClass("only", n_pods=2)]), None,
                        _args("--one-shot", "--class-sharded", "on"), 8, torch.device("cpu"))
