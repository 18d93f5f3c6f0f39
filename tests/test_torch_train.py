"""Port vs reference: training — the GEMM autograd Function, model
gradients, the trainer and its CLI — on the CPU at reduced sizes.

Tolerances:

  * The Function against ``torch.matmul`` autograd on the same bf16
    values: both round the same fp32 sums to bf16, in other orders, so
    rtol = atol = 2e-2 (the port's bf16 tolerance, as in
    ``tests/test_backend_parity.py``).  Lean against pipelined at equal
    blocks: bitwise.
  * Model gradients against ``jax.value_and_grad`` of the reference's
    loss, from the reference's params: the loss within 2e-3 absolute (an
    fp32 mean of bf16 logits rounded at other places), each leaf's
    gradient within 0.03 relative L2 (bf16 cotangents through 4 layers).
  * The trainer against the reference's from the same state, 6 steps:
    losses within 1% relative, ``grad_norm`` within 3%, ``lr`` to fp32
    rounding (rtol 1e-6).
  * The reference's own behaviours (``tests/test_train_integration.py``)
    at its own tolerances (deterministic replay to rel 1e-5, the masked
    loss to rel 1e-5).
"""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch.mesh import make_host_mesh
from repro.models import model_zoo as JZ
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.runtime.trainer import Trainer as JTrainer
from repro.runtime.trainer import TrainerConfig as JTrainerConfig

from repro_torch.configs import get_config
from repro_torch.convert import train_state_from_jax
from repro_torch.core import blocking as B
from repro_torch.core import control_tree as CT
from repro_torch.core import execution as X
from repro_torch.core.asymmetric import AsymmetricMesh, DeviceClass, biglittle_classes
from repro_torch.data.pipeline import AsymmetricBatcher, SyntheticLM
from repro_torch.kernels import ops
from repro_torch.launch import train as train_cli
from repro_torch.models import model_zoo as Z
from repro_torch.models import transformer as T
from repro_torch.optim import adamw as O
from repro_torch.runtime.trainer import SimulatedFailure, Trainer, TrainerConfig

torch.set_num_threads(1)

BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _bf16(rng, shape, scale=1.0):
    return torch.as_tensor(rng.normal(scale=scale, size=shape), dtype=torch.float32).to(torch.bfloat16)


def _hand_tree(backend, block=B.BlockConfig(bm=64, bk=64, bn=64)):
    return CT.ControlTree(device_class="hand", block=block, backend=backend)


# ---------------------------------------------------------------------------
# The GEMM autograd Function
# ---------------------------------------------------------------------------


def _grads(fn, a, b, w):
    a = a.clone().requires_grad_(True)
    b = b.clone().requires_grad_(True)
    out = fn(a, b)
    (out.float() * w).sum().backward()
    return out.detach(), a.grad, b.grad


@pytest.mark.parametrize("backend", ["matmul", "torch_ref", "torch_ref_lean"])
@pytest.mark.parametrize("shape", [(2, 24, 96, 80), (1, 40, 64, 136)])
def test_gemm_function_grads_match_matmul_autograd(backend, shape):
    rng = np.random.default_rng(0)
    b0, s, k, n = shape
    a, b, w = _bf16(rng, (b0, s, k)), _bf16(rng, (k, n), 0.1), torch.randn(b0, s, n)
    with X.context_for_tree(_hand_tree(backend)):
        out, da, db = _grads(ops.gemm, a, b, w)
    ref, rda, rdb = _grads(torch.matmul, a, b, w)
    assert da.dtype == db.dtype == torch.bfloat16
    for got, want in ((out, ref), (da, rda), (db, rdb)):
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), **BF16_TOL)


def test_gemm_function_lean_equals_pipelined_bitwise():
    rng = np.random.default_rng(1)
    a, b, w = _bf16(rng, (48, 192)), _bf16(rng, (192, 112), 0.1), torch.randn(48, 112)
    res = {}
    for backend in ("torch_ref", "torch_ref_lean"):
        with X.context_for_tree(_hand_tree(backend)):
            res[backend] = _grads(ops.gemm, a, b, w)
    for got, want in zip(res["torch_ref_lean"], res["torch_ref"]):
        assert torch.equal(got, want)


def test_gemm_function_computes_only_the_grads_asked_for(monkeypatch):
    calls = []
    plain = X.BACKENDS["torch_ref"]  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    monkeypatch.setitem(X.BACKENDS, "torch_ref",
                        lambda a2, b, cfg, dt: calls.append(tuple(a2.shape)) or plain(a2, b, cfg, dt))
    rng = np.random.default_rng(2)
    a, b = _bf16(rng, (16, 64)), _bf16(rng, (64, 32)).requires_grad_(True)
    with X.context_for_tree(_hand_tree("torch_ref")):
        ops.gemm(a, b).float().sum().backward()
    assert calls == [(16, 64), (64, 16)]  # the forward, then dB = Aᵀ·dC only
    with torch.inference_mode(), X.context_for_tree(_hand_tree("torch_ref")):
        out = ops.gemm(a, b)
    assert out.grad_fn is None and not out.requires_grad


def _spy(monkeypatch):
    """Count the GEMM calls of every table entry (the forward's, the
    recompute's and the backward's all go through the table)."""

    counts = {}
    for name, op in X.BACKEND_OPS.items():
        if op != "gemm":
            continue
        fn = X.BACKENDS[name]

        def wrapped(a2, b, cfg, dt, _fn=fn, _name=name):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(a2, b, cfg, dt)

        monkeypatch.setitem(X.BACKENDS, name, wrapped)
    return counts


def test_backward_on_another_thread_keeps_the_forward_backend(monkeypatch):
    """The forward and its remat run under the little class's tree; the
    backward runs outside the ``with`` and on another thread, where the
    ``ContextVar`` is unset ("auto" would mean ``matmul`` here): every
    recompute and backward GEMM must still take the little class's lean
    plain version."""

    cfg = get_config("internlm2-1.8b").reduced()
    params = O.tree_map(lambda p: p.requires_grad_(True),
                        Z.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                                      dtype=torch.float32))
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(cfg.vocab, seed=0).batch(0, 2, 16).items()}
    little = AsymmetricMesh(biglittle_classes(), batch_tile=1, backend="torch_ref").execution_context("little")  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    assert little.backend() == "torch_ref_lean"
    counts = _spy(monkeypatch)
    with little:
        loss, _ = Z.make_loss_fn(cfg)(params, batch)
    n = 7 * cfg.n_layers + 1
    assert counts == {"torch_ref_lean": n}
    leaves = O.tree_leaves(params)
    out = {}
    thread = threading.Thread(target=lambda: out.update(g=torch.autograd.grad(loss, leaves)))
    thread.start()
    thread.join()
    assert X.current_context() is None
    assert counts == {"torch_ref_lean": n + 7 * cfg.n_layers + 2 * n}
    assert all(torch.isfinite(g).all() for g in out["g"])


def test_loss_fn_trains_only_params_that_require_grad(monkeypatch):
    """The training route (remat, attention by ``"auto"``: the flash
    kernels on a card, chunked attention on the CPU) only when autograd
    will differentiate: grad mode on and a leaf that requires grad."""

    seen = []
    monkeypatch.setattr(T, "loss_fn", lambda params, cfg, batch, **kw: seen.append(kw))
    cfg = get_config("internlm2-1.8b").reduced()
    loss_fn = Z.make_loss_fn(cfg)
    params = Z.init_params(cfg, torch.Generator().manual_seed(0), "cpu", dtype=torch.float32)
    loss_fn(params, {})
    O.tree_map(lambda p: p.requires_grad_(True), params)
    loss_fn(params, {})
    with torch.no_grad():
        loss_fn(params, {})
    with torch.inference_mode():
        loss_fn(params, {})
    Z.make_loss_fn(cfg, remat=False)(params, {})
    train = {"attn_backend": "auto"}
    assert seen == [{}, dict(train, remat=True), {}, {}, dict(train, remat=False)]


def test_remat_recomputes_and_leaves_the_gradients_bitwise(monkeypatch):
    """``remat`` recomputes each layer's 7 GEMMs in the backward and
    changes no bit of the loss or the gradients."""

    cfg = get_config("internlm2-1.8b").reduced()
    params = O.tree_map(lambda p: p.requires_grad_(True),
                        Z.init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                                      dtype=torch.float32))
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(cfg.vocab, seed=0).batch(0, 2, 16).items()}
    counts = _spy(monkeypatch)
    res = {}
    for remat in (True, False):
        counts.clear()
        with X.context_for_tree(_hand_tree("torch_ref")):
            loss, _ = Z.make_loss_fn(cfg, remat=remat)(params, batch)
            grads = torch.autograd.grad(loss, O.tree_leaves(params))
        res[remat] = (loss, grads, dict(counts))
    n = 7 * cfg.n_layers + 1
    assert res[False][2] == {"torch_ref": 3 * n}
    assert res[True][2] == {"torch_ref": 3 * n + 7 * cfg.n_layers}
    assert torch.equal(res[True][0], res[False][0])
    assert all(torch.equal(x, y) for x, y in zip(res[True][1], res[False][1]))


# ---------------------------------------------------------------------------
# Model gradients against the reference's
# ---------------------------------------------------------------------------

ARCHS = ["internlm2-1.8b", "minitron-4b", "deepseek-7b", "qwen2.5-32b"]


def _reference_params(arch, seed=0):
    jcfg = jax_config(arch).reduced()
    jparams = JZ.init_params(jax.random.PRNGKey(seed), jcfg)
    if jcfg.qkv_bias:  # zeros at init: draw them so the bias path carries gradient
        rng = np.random.default_rng(seed)
        attn = dict(jparams["blocks"]["attn"])
        for name in ("bq", "bk", "bv"):
            attn[name] = jnp.asarray(rng.normal(scale=0.5, size=attn[name].shape), jnp.float32)
        jparams = dict(jparams, blocks=dict(jparams["blocks"], attn=attn))
    return jcfg, jparams


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("arch", ARCHS)
def test_model_grads_match_reference(arch):
    jcfg, jparams = _reference_params(arch)
    cfg = get_config(arch).reduced()
    params, _ = train_state_from_jax(jax.tree.map(np.asarray, jparams), None, device="cpu")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, size=(2, 24)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, size=(2, 24)).astype(np.int32)
    (jloss, _), jgrads = jax.value_and_grad(JZ.make_loss_fn(jcfg), has_aux=True)(
        jparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    loss, metrics = Z.make_loss_fn(cfg)(params, {"tokens": torch.from_numpy(toks),
                                                 "labels": torch.from_numpy(labels)})
    leaves = O.tree_leaves(params)
    grads = dict(zip(sorted(_flat(params)), torch.autograd.grad(loss, leaves)))
    assert abs(float(loss.detach()) - float(jloss)) <= 2e-3
    assert set(metrics) == {"ce", "aux"}
    jflat = _flat(jax.tree.map(np.asarray, jgrads))
    assert set(jflat) == set(grads)
    for key, jg in jflat.items():
        g = grads[key].float().numpy()
        assert g.shape == jg.shape and grads[key].dtype == torch.float32, key
        rel = np.linalg.norm(g - jg) / max(np.linalg.norm(jg), 1e-12)
        assert rel <= 0.03, (key, rel)


# ---------------------------------------------------------------------------
# The trainer against the reference's, and the reference's behaviours
# ---------------------------------------------------------------------------


def test_trainer_matches_reference_trainer(tmp_path):
    jcfg = jax_config("internlm2-1.8b").reduced()
    cfg = get_config("internlm2-1.8b").reduced()
    tcfg = dict(steps=6, global_batch=8, seq_len=32, ckpt_every=100)
    opt = dict(lr=1e-3, total_steps=6, warmup_steps=2)
    jt = JTrainer(jcfg, make_host_mesh(), opt_cfg=JAdamWConfig(**opt),
                  tcfg=JTrainerConfig(ckpt_dir=str(tmp_path / "j"), **tcfg))
    params, opt_state = train_state_from_jax(
        jax.tree.map(np.asarray, jt.params), jax.tree.map(np.asarray, jt.opt_state), device="cpu")
    pt = Trainer(cfg, opt_cfg=O.AdamWConfig(**opt), tcfg=TrainerConfig(ckpt_dir=str(tmp_path / "p"), **tcfg),
                 device="cpu", params=params, opt_state=opt_state)
    jh, ph = jt.run(), pt.run()
    assert len(jh) == len(ph) == 6
    for j, p in zip(jh, ph):
        assert set(p) == set(j)
        assert p["loss"] == pytest.approx(j["loss"], rel=1e-2)
        assert p["grad_norm"] == pytest.approx(j["grad_norm"], rel=3e-2)
        assert p["lr"] == pytest.approx(j["lr"], rel=1e-6)


def _trainer(tmp, steps=12, asym=None, failure_hook=None, pod_time_hook=None, n_micro=1):
    cfg = get_config("internlm2-1.8b").reduced()
    return Trainer(
        cfg,
        tcfg=TrainerConfig(steps=steps, global_batch=8, seq_len=32, ckpt_dir=str(tmp),
                           ckpt_every=4, n_micro=n_micro),
        opt_cfg=O.AdamWConfig(lr=1e-3, total_steps=steps, warmup_steps=2),
        asym=asym, failure_hook=failure_hook, pod_time_hook=pod_time_hook, device="cpu",
    )


def _fail_at(*steps):
    fails = set(steps)

    def hook(step):
        if step in fails:
            fails.discard(step)
            raise SimulatedFailure(step)

    return hook


def _two_pods(strategy):
    return AsymmetricMesh([DeviceClass("a", chips_per_pod=1), DeviceClass("b", chips_per_pod=1)],
                          strategy=strategy, batch_tile=1)


@pytest.mark.parametrize("case", [
    "loss_decreases", "grad_accumulation_runs", "metrics_present",
    "failures_restore_and_complete", "restart_resumes_from_committed_step",
    "deterministic_data_replay", "straggler_sheds_work", "sss_stays_equal",
])
def test_reference_training_behaviours(tmp_path, case):
    if case == "loss_decreases":
        hist = _trainer(tmp_path, steps=20).run()
        assert np.mean([h["loss"] for h in hist[-4:]]) < np.mean([h["loss"] for h in hist[:4]])
    elif case == "grad_accumulation_runs":
        hist = _trainer(tmp_path, steps=4, n_micro=2).run()
        assert len(hist) == 4 and np.isfinite(hist[-1]["loss"])
    elif case == "metrics_present":
        hist = _trainer(tmp_path, steps=3).run()
        assert {"loss", "lr", "grad_norm", "ce"} <= set(hist[0])
    elif case == "failures_restore_and_complete":
        t = _trainer(tmp_path, steps=12, failure_hook=_fail_at(5, 9))
        hist = t.run()
        assert t.restarts == 2 and t.step == 12 and np.isfinite(hist[-1]["loss"])
    elif case == "restart_resumes_from_committed_step":
        seen = []

        def hook(step):
            seen.append(step)
            if step == 6 and seen.count(6) == 1:
                raise SimulatedFailure(6)

        t = _trainer(tmp_path, steps=8, failure_hook=hook)
        t.run()
        assert seen.count(5) == 2 and t.restarts == 1  # restored to step 4, replayed 4..7
    elif case == "deterministic_data_replay":
        h1 = _trainer(tmp_path / "a", steps=10).run()
        h2 = _trainer(tmp_path / "b", steps=10, failure_hook=_fail_at(7)).run()
        assert h1[-1]["loss"] == pytest.approx(h2[-1]["loss"], rel=1e-5)
    elif case == "straggler_sheds_work":
        asym = _two_pods("ca-das")

        def times(step):
            sizes = asym.batch_layout(8).sizes
            return [sizes[0] / 4.0 + 1e-6, sizes[1] / 1.0 + 1e-6]

        _trainer(tmp_path, steps=15, asym=asym, pod_time_hook=times).run()
        sizes = asym.batch_layout(8).sizes
        assert sizes[0] > sizes[1]
    elif case == "sss_stays_equal":
        asym = _two_pods("sss")
        _trainer(tmp_path, steps=4, asym=asym, pod_time_hook=lambda s: [0.1, 0.4]).run()
        sizes = asym.batch_layout(8).sizes
        assert sizes[0] == sizes[1]


def test_masked_loss_matches_unpadded():
    cfg = get_config("internlm2-1.8b").reduced()
    params = Z.init_params(cfg, torch.Generator().manual_seed(0), "cpu", dtype=torch.float32)
    loss_fn = Z.make_loss_fn(cfg)
    src = SyntheticLM(vocab=cfg.vocab, seed=0)
    tensors = lambda arrays: {k: torch.from_numpy(v) for k, v in arrays.items()}  # noqa: E731
    l_plain, _ = loss_fn(params, tensors(src.batch(0, 6, 16)))
    asym = AsymmetricMesh([DeviceClass("a", chips_per_pod=1),
                           DeviceClass("b", chips_per_pod=1, rel_throughput=0.5)],
                          strategy="sas", batch_tile=4)
    l_padded, _ = loss_fn(params, tensors(AsymmetricBatcher(src, asym).batch(0, 6, 16).arrays))
    assert float(l_plain) == pytest.approx(float(l_padded), rel=1e-5)


def test_trainer_refuses_what_is_not_ported(tmp_path):
    # class_sharded=True on a mesh without a pod axis: the reference's own error.
    with pytest.raises(ValueError, match="class_sharded=True"):
        Trainer(get_config("internlm2-1.8b").reduced(), device="cpu", asym=_two_pods("ca-das"),
                tcfg=TrainerConfig(ckpt_dir=str(tmp_path), class_sharded=True))
    with pytest.raises(ValueError, match="'frames'"):
        Trainer(get_config("whisper-small").reduced(), device="cpu",
                tcfg=TrainerConfig(ckpt_dir=str(tmp_path)))


def test_train_cli_prints_the_reference_summary(tmp_path, capsys):
    out = train_cli.main(["--arch", "internlm2-1.8b", "--reduced", "--device", "cpu",
                          "--steps", "3", "--seq", "32", "--ckpt-dir", str(tmp_path)])
    printed = json.loads(capsys.readouterr().out)
    assert printed == out
    assert set(out) == {"arch", "device_class", "exec_backend", "class_sharded", "shard_classes",
                        "steps", "first_loss", "last_loss", "restarts", "wall_s", "chunk_sizes"}
    assert out["class_sharded"] is False and out["shard_classes"] is None
    assert out["steps"] == 3 and out["restarts"] == 0 and out["chunk_sizes"] == [4, 4]
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])


def test_train_cli_runs_on_the_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        train_cli.main(["--arch", "internlm2-1.8b", "--reduced", "--steps", "1"])
