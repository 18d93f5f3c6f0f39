"""Port vs reference: the serving engine, the one-shot path and the CLI.

The reduced internlm2 (4 layers, d 64, 4/2 heads of 16, vocab 256) serves
the same numpy-drawn prompts in both packages, the reference's weights
carried over by ``convert.params_from_jax``.  The JAX engine runs with
``class_sharded="off"`` (the tests force 8 host devices, which would
otherwise take the mixed class-sharded step the port does not have yet).

Greedy tokens are compared against the reference where the logit margins
are wide: the two frameworks round bf16 at other places (logits agree to
rtol = atol = 2e-2, see ``test_torch_model.py``), so a token whose top-2
gap is within that drift may legitimately flip, and everything after a
flip diverges.  Each row is therefore compared up to its first step with
a top-2 gap below ``MARGIN``.  Within the port the contracts are bitwise:
paged engine == dense engine (gather route) and engine == one-shot.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
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
from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes
from repro_torch.launch import serve
from repro_torch.runtime.serving import ServingEngine

torch.set_num_threads(1)

ARCH = "internlm2-1.8b"
MARGIN = 0.025  # > 2 x the largest logit drift between the packages (~0.01, test_torch_model)
B, PLEN, GEN = 6, 6, 6


@pytest.fixture(scope="module")
def model():
    jcfg = jax_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jparams = JZ.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (B, PLEN), dtype=np.int32)
    return jcfg, jparams, cfg, params, prompts


def _mesh(**kw):
    return AsymmetricMesh(biglittle_classes(chips_per_pod=1), strategy="ca-das", batch_tile=1, **kw)


def _engine(cfg, params, *, seq_cap=PLEN + GEN, **kw):
    asym = kw.pop("asym", None) or _mesh()
    kw.setdefault("slots_per_pod", asym.batch_layout(B).c_max)
    return ServingEngine(cfg, params, asym, seq_cap=seq_cap, device="cpu", **kw)


def _reference_margins(jcfg, jparams, tokens):
    """Top-2 logit gap behind every generated token, teacher-forced
    through the reference's decode recurrence on its own tokens."""

    dec = jax.jit(JZ.make_decode_fn(jcfg))
    state = JZ.init_decode_state(jcfg, len(tokens), PLEN + GEN)
    margins = []
    for t in range(PLEN + GEN - 1):
        logits, state = dec(jparams, {"tokens": jnp.asarray(tokens[:, t:t + 1])}, state,
                            jnp.int32(t))
        if t >= PLEN - 1:
            top2 = np.sort(np.asarray(logits[:, 0].astype(jnp.float32)), axis=-1)[:, -2:]
            margins.append(top2[:, 1] - top2[:, 0])
    return np.stack(margins, axis=1)  # (B, GEN)


def test_engine_tokens_match_reference_engine(model):
    jcfg, jparams, cfg, params, prompts = model
    jasym = JMesh(jax_classes(chips_per_pod=1), strategy="ca-das", batch_tile=1)
    jeng = JaxEngine(jcfg, jparams, jasym, seq_cap=PLEN + GEN,
                     slots_per_pod=jasym.batch_layout(B).c_max, class_sharded="off")
    want = jeng.generate(prompts, GEN)
    eng = _engine(cfg, params)
    got = eng.generate(prompts, GEN)

    assert got.shape == want.shape == (B, PLEN + GEN)
    assert np.array_equal(got[:, :PLEN], prompts)
    margins = _reference_margins(jcfg, jparams, want)
    compared = 0
    for row in range(B):
        narrow = np.nonzero(margins[row] < MARGIN)[0]
        upto = narrow[0] + 1 if len(narrow) else GEN  # the first narrow token may flip
        wide = upto - (1 if len(narrow) else 0)
        assert np.array_equal(got[row, PLEN:PLEN + wide], want[row, PLEN:PLEN + wide]), row
        compared += wide
    assert compared >= B * GEN // 3, f"only {compared} tokens had wide margins"
    # The same requests landed in the same slots of the same classes.
    placed = lambda e: sorted((c.rid, c.slot, c.pod, c.device_class) for c in e.completions)  # noqa: E731
    assert placed(eng) == placed(jeng)
    assert eng.stats.admitted == jeng.stats.admitted == B
    assert eng.stats.host_relayouts == 0


@pytest.mark.parametrize("route", ["matmul", "cuda"])
def test_paged_engine_equals_dense_engine_bitwise(model, route):
    *_, cfg, params, prompts = model
    rng = np.random.default_rng(3)
    # More requests than slots, mixed lengths and an EOS: slots are reused
    # and pages freed mid-stream.
    reqs = [(rng.integers(0, cfg.vocab, int(rng.integers(2, 7)), dtype=np.int32), int(n))
            for n in rng.integers(1, 7, size=14)]
    out = {}
    for paged in ("off", "on"):
        eng = _engine(cfg, params, asym=_mesh(backend=route), slots_per_pod=3, paged=paged,
                      page_size=4, eos_id=int(prompts[0, 0]))
        for prompt, n in reqs:
            eng.submit(prompt, n)
        done = eng.run()
        out[paged] = sorted((c.rid, c.tokens.tolist(), c.stop) for c in done)
        if paged == "on":
            kv = eng.kv_stats()
            assert kv["paged"] and kv["page_size"] == 4 and kv["pages_per_slot"] == 3
            assert kv["pages_live"] == kv["phantom_pages"]  # every request's pages freed
    assert len(out["on"]) == len(reqs)
    assert out["on"] == out["off"]


def test_engine_equals_one_shot_bitwise(model):
    *_, cfg, params, prompts = model
    for route in ("matmul", "cuda"):
        eng = _engine(cfg, params, asym=_mesh(backend=route))
        got = eng.generate(prompts, GEN)
        with _mesh(backend=route).execution_context():
            ref, timings = serve.generate(cfg, params, prompts, GEN, PLEN + GEN, device="cpu")
        assert np.array_equal(got, ref), route
        assert timings["decode_steps"] == GEN - 1


def test_one_shot_under_the_little_class_tree(model):
    *_, cfg, params, prompts = model
    mesh = _mesh(backend="cuda")  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    big, _ = serve.generate(cfg, params, prompts, GEN, PLEN + GEN, device="cpu")
    with mesh.execution_context("little") as ctx:
        assert ctx.backend() == "cuda_lean"
        little, _ = serve.generate(cfg, params, prompts, GEN, PLEN + GEN, device="cpu")
    assert little.shape == big.shape and np.array_equal(little[:, :PLEN], prompts)


def _reference_summary(monkeypatch, capsys, *extra):
    argv = ["serve", "--arch", ARCH, "--reduced", "--batch", "4", "--prompt-len", "4",
            "--gen-len", "4", "--class-sharded", "off", *extra]
    monkeypatch.setattr("sys.argv", argv)
    jax_serve.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("extra", [(), ("--paged", "on"), ("--one-shot", "--device-class", "little")],
                         ids=["engine", "paged", "one-shot-little"])
def test_serve_cli_json_has_the_reference_keys(monkeypatch, capsys, extra):
    want = _reference_summary(monkeypatch, capsys, *extra)
    got = serve.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--batch", "4",
                      "--prompt-len", "4", "--gen-len", "4", *extra])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == got
    assert set(want) <= set(got), sorted(set(want) - set(got))
    if "engine" in want:
        assert set(want["engine"]) <= set(got["engine"])
        assert set(want["engine"]["kv_pool"]) == set(got["engine"]["kv_pool"])
        assert got["engine"]["host_relayouts"] == 0
    for key in ("arch", "path", "objective", "device_class", "batch", "generated", "class_sharded"):
        assert got[key] == want[key], key
    assert got["device"] == "cpu" and got["compile_s"] > 0


def test_engine_refuses_what_is_not_ported(model):
    *_, cfg, params, _ = model
    # A family whose state has no KV pages (the SSM rule) cannot page.
    with pytest.raises(ValueError, match="paged='on'"):
        _engine(dataclasses.replace(cfg, family="ssm"), params, paged="on")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            ServingEngine(cfg, params, _mesh(), seq_cap=8, device="cuda")
    with pytest.raises(ValueError, match="seq_cap"):
        _engine(cfg, params, seq_cap=4).submit(np.zeros(3, np.int32), 3)


def test_profile_decode_records_every_measurement(tmp_path):
    from repro_torch.launch import profile_decode

    out = tmp_path / "profile.json"
    rec = profile_decode.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--batch", "2",
                               "--prompt-len", "2", "--gen-len", "4", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(rec))
    for kind in ("dense", "paged"):
        runs = rec["windows"][kind]["runs"]
        assert len(runs) == profile_decode.REPEATS and all(r["steps"] == 4 - 2 for r in runs)
        trace = rec[kind]["trace"]
        assert trace["steps"] == 1 and not trace["device_seen"]  # no card: host ops only
        assert any(o["name"] == "aten::mm" for o in trace["host_ops"])
        assert any("decode_step" in r["fn"] for r in rec[kind]["python"]["package_by_cum_time"])
    shapes = rec["block_search"]["shapes"]
    assert sum(s["per_step"] for s in shapes) == 7 * 4 + 1  # every GEMM of the reduced step
