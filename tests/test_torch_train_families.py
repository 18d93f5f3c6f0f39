"""Port vs reference: training the MoE, Mamba2, hybrid, enc-dec and
embedding-input families on the CPU at reduced sizes.

Model gradients are held against ``jax.value_and_grad`` of the
reference's loss from the reference's params: the loss within 2e-3
absolute, each leaf's gradient within 0.03 relative L2, as
``tests/test_torch_train.py`` holds the dense family.  The reference's
loss is compiled with ``xla_allow_excess_precision`` off, so that XLA
rounds to bf16 wherever the reference's code casts, as eager JAX and the
port do (with it on, the CPU's fused kernels keep fp32 between ops and
the Mamba2 families' gradients move from the eager reference's by more
than the tolerance).

**MoE routing.**  Router probabilities sit close together, so a last-bit
difference between the packages can flip a top-k choice, an O(1) change
in that token's gradient.  So the reference's routing is captured from
its forward under ``jax.disable_jit`` (the capture of
``tests/test_torch_moe.py``) and forced on both sides before gradients
are compared: the port's ``moe.route`` keeps its own probabilities and
takes the captured top-k ids (its gate weights are its probabilities at
those ids, renormalised), and the reference's gradient is traced with its
layer scan unrolled, so that its ``jax.lax.top_k`` is called once a layer
in order and returns the same ids.  Both sides run without remat there
(``jax.checkpoint`` traces a layer once for all layers, and the port's
recompute would call ``route`` again), so each calls its top-k once a
layer in order; remat changes no bit of a gradient
(``test_remat_leaves_gradients_bitwise``).

The trainer against the reference's trainer (its step compiled with
excess precision off as above; qwen2-moe routes on its own on both
sides), at the dense family's tolerances: losses within 1% relative,
``grad_norm`` within 3%, ``lr`` to fp32 rounding.  The losses are held
over 6 free-running steps from one state.  ``grad_norm`` is held step by
step, each step from the reference's state before it: over free-running
steps AdamW turns last-bit differences of near-zero gradients into
whole-``lr`` updates, and reduced mamba2's ``grad_norm`` then moves by
more than 3% between two runs of the reference's own trainer (excess
precision on and off).
"""

import json

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
from repro_torch.launch import train as train_cli
from repro_torch.models import model_zoo as Z
from repro_torch.models import moe as M
from repro_torch.optim import adamw as O
from repro_torch.runtime.trainer import Trainer, TrainerConfig

from test_torch_train import _flat, _reference_params, _spy

torch.set_num_threads(1)

LOSS_ATOL, GRAD_RTOL = 2e-3, 0.03
BATCH, SEQ = 2, 24
MOE = ("qwen2-moe-a2.7b", "mixtral-8x7b")
NO_EXCESS = {"xla_allow_excess_precision": False}


def _batch(cfg, seed=3):
    """numpy inputs of the family: tokens, or embeddings; frames for the
    enc-dec; labels."""

    rng = np.random.default_rng(seed)
    out = {"labels": rng.integers(0, cfg.vocab, size=(BATCH, SEQ)).astype(np.int32)}
    if cfg.embed_inputs:
        out["embeds"] = rng.normal(size=(BATCH, SEQ, cfg.d_model)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, size=(BATCH, SEQ)).astype(np.int32)
    if cfg.family == "encdec":
        out["frames"] = rng.normal(size=(BATCH, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return out


def _unrolled_scan(f, init, xs):
    """``jax.lax.scan`` as a Python loop over the leading axis."""

    carry, ys = init, []
    for i in range(jax.tree.leaves(xs)[0].shape[0]):
        carry, y = f(carry, jax.tree.map(lambda a: a[i], xs))
        ys.append(y)
    return carry, jax.tree.map(lambda *a: jnp.stack(a), *ys)


def _forced_routing(monkeypatch, jcfg, jparams, jbatch):
    """The reference's top-k ids, one (G, S, k) array a layer, captured from
    its forward under ``jax.disable_jit``; then ``jax.lax.top_k`` (with the
    layer scan unrolled) and the port's ``moe.route`` both patched to
    return them, layer by layer in call order.  Returns the call counts."""

    real_top_k, real_route = jax.lax.top_k, M.route
    ids = []

    def capture(probs, k):
        out = real_top_k(probs, k)
        ids.append(np.array(out[1]))
        return out

    monkeypatch.setattr(jax.lax, "top_k", capture)
    with jax.disable_jit():  # no remat: jax.checkpoint would trace the layer
        JZ.make_loss_fn(jcfg, remat=False)(jparams, jbatch)
    assert len(ids) == jcfg.n_layers
    calls = {"jax": 0, "torch": 0}

    def forced_top_k(probs, k):
        idx = jnp.asarray(ids[calls["jax"] % len(ids)])
        calls["jax"] += 1
        return jnp.take_along_axis(probs, idx, axis=-1), idx

    def forced_route(p, x, cfg):
        _, _, probs = real_route(p, x, cfg)
        idx = torch.from_numpy(ids[calls["torch"] % len(ids)]).long()
        calls["torch"] += 1
        gate_w = probs.gather(-1, idx)
        return gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9), idx, probs

    monkeypatch.setattr(jax.lax, "top_k", forced_top_k)
    monkeypatch.setattr(jax.lax, "scan", _unrolled_scan)
    monkeypatch.setattr(M, "route", forced_route)
    return calls


def _reference_value_and_grad(jcfg, jparams, jbatch, remat):
    f = jax.value_and_grad(JZ.make_loss_fn(jcfg, remat=remat), has_aux=True)
    compiled = jax.jit(f).lower(jparams, jbatch).compile(compiler_options=NO_EXCESS)
    (jloss, jmetrics), jgrads = compiled(jparams, jbatch)
    return float(jloss), jmetrics, _flat(jax.tree.map(np.asarray, jgrads))


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mixtral-8x7b", "mamba2-1.3b", "zamba2-2.7b",
                                  "whisper-small", "pixtral-12b"])
def test_family_grads_match_reference(arch, monkeypatch):
    jcfg, jparams = _reference_params(arch)
    cfg = get_config(arch).reduced()
    params, _ = train_state_from_jax(jax.tree.map(np.asarray, jparams), None, device="cpu")
    arrays = _batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in arrays.items()}
    remat = True
    if arch in MOE:
        calls = _forced_routing(monkeypatch, jcfg, jparams, jbatch)
        remat = False
    jloss, jmetrics, jflat = _reference_value_and_grad(jcfg, jparams, jbatch, remat)
    loss, metrics, grads = O.value_and_grad(Z.make_loss_fn(cfg, remat=remat), params,
                                            {k: torch.from_numpy(v) for k, v in arrays.items()})
    grads = _flat(grads)
    if arch in MOE:
        assert calls == {"jax": jcfg.n_layers, "torch": cfg.n_layers}
        assert float(metrics["aux"]) > 0
        assert float(metrics["aux"]) == pytest.approx(float(jmetrics["aux"]), rel=1e-4)
    assert abs(float(loss) - jloss) <= LOSS_ATOL
    assert set(jflat) == set(grads)
    for key, jg in jflat.items():
        g = grads[key].numpy()
        assert g.shape == jg.shape and grads[key].dtype == torch.float32, key
        rel = np.linalg.norm(g - jg) / max(np.linalg.norm(jg), 1e-12)
        assert rel <= GRAD_RTOL, (key, rel)


def _port_state(cfg, seed=0):
    return O.tree_map(lambda p: p.requires_grad_(True),
                      Z.init_params(cfg, torch.Generator().manual_seed(seed), "cpu",
                                    dtype=torch.float32))


@pytest.mark.parametrize("arch,forward,recomputed", [
    # zamba2: the shared block's 7 GEMMs a group (2 groups) and the head.
    ("zamba2-2.7b", 15, {True: 14, False: 0}),
    # whisper: encoder 6 a layer (2), decoder 10 a layer (4), the head;
    # the encoder is recomputed with or without remat.
    ("whisper-small", 53, {True: 52, False: 12}),
    # qwen2-moe: q, k, v, o and the shared expert's GLU a layer (4), the head.
    ("qwen2-moe-a2.7b", 29, {True: 28, False: 0}),
])
def test_remat_leaves_gradients_bitwise(arch, forward, recomputed, monkeypatch):
    """Remat recomputes the layer bodies (the hybrid's shared block nine
    times at full depth with one parameter set, the enc-dec's decoder, and
    its encoder always) and changes no bit of the loss or of any
    gradient; the backward makes two GEMMs a forward GEMM."""

    cfg = get_config(arch).reduced()
    params = _port_state(cfg)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    counts = _spy(monkeypatch)
    res = {}
    for remat in (True, False):
        counts.clear()
        loss, _, grads = O.value_and_grad(Z.make_loss_fn(cfg, remat=remat), params, batch)
        res[remat] = (loss, O.tree_leaves(grads))
        assert counts == {"matmul": 3 * forward + recomputed[remat]}, (remat, counts)
    assert torch.equal(res[True][0], res[False][0])
    assert all(torch.equal(x, y) for x, y in zip(res[True][1], res[False][1]))
    assert all(bool(torch.isfinite(g).all()) for g in res[True][1])


def test_encdec_eval_loss_under_grad_mode_records_nothing():
    """Serving params (bf16, no grad) take the eval route under grad mode:
    a loss without a graph; fp32 masters that require grad get one."""

    cfg = get_config("whisper-small").reduced()
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    serving = Z.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    loss, _ = Z.make_loss_fn(cfg)(serving, batch)
    assert loss.grad_fn is None and not loss.requires_grad
    masters = _port_state(cfg)
    loss, _ = Z.make_loss_fn(cfg)(masters, batch)
    assert loss.requires_grad
    with torch.no_grad():
        eval_loss, _ = Z.make_loss_fn(cfg)(masters, batch)
    assert abs(float(loss.detach()) - float(eval_loss)) <= LOSS_ATOL


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-1.3b", "zamba2-2.7b"])
def test_trainer_matches_reference_trainer(arch, tmp_path, monkeypatch):
    """Both trainers run 6 steps from the same state: the losses stay
    within 1% step by step.  Then each of the reference's 6 steps is
    replayed by the port's trainer from the reference's state before it:
    loss, ``grad_norm``, ``lr`` (and the MoE's ``aux``) at their
    tolerances."""

    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    tcfg = dict(steps=6, global_batch=8, seq_len=32, ckpt_every=100)
    opt = dict(lr=1e-3, total_steps=6, warmup_steps=2)
    real_jit = jax.jit
    monkeypatch.setattr(jax, "jit", lambda f, *a, **kw: real_jit(f, *a, compiler_options=NO_EXCESS, **kw))
    jt = JTrainer(jcfg, make_host_mesh(), opt_cfg=JAdamWConfig(**opt),
                  tcfg=JTrainerConfig(ckpt_dir=str(tmp_path / "j"), **tcfg))
    monkeypatch.setattr(jax, "jit", real_jit)
    states, jstep = [], jt.train_step

    def record(params, opt_state, batch):  # copies: the step donates its arguments
        states.append(jax.tree.map(lambda a: np.array(a, copy=True), (params, opt_state)))
        return jstep(params, opt_state, batch)

    jt.train_step = record

    def port_trainer(state, name):
        params, opt_state = train_state_from_jax(*state, device="cpu")
        return Trainer(cfg, opt_cfg=O.AdamWConfig(**opt), device="cpu", params=params,
                       opt_state=opt_state, tcfg=TrainerConfig(ckpt_dir=str(tmp_path / name), **tcfg))

    pt = port_trainer(jax.tree.map(np.asarray, (jt.params, jt.opt_state)), "p")
    jh, ph = jt.run(), pt.run()
    assert len(jh) == len(ph) == len(states) == 6
    for j, p in zip(jh, ph):
        assert set(p) == set(j)
        assert p["loss"] == pytest.approx(j["loss"], rel=1e-2)
    replay = port_trainer(states[0], "r")
    for step, (state, j) in enumerate(zip(states, jh)):
        replay.params, replay.opt_state = train_state_from_jax(*state, device="cpu")
        p = {k: float(v) for k, v in replay.train_step(replay.next_batch(step)[0]).items()}
        assert p["loss"] == pytest.approx(j["loss"], rel=1e-2)
        assert p["grad_norm"] == pytest.approx(j["grad_norm"], rel=3e-2)
        assert p["lr"] == pytest.approx(j["lr"], rel=1e-6)
        if cfg.family == "moe":
            assert p["aux"] > 0 and p["aux"] == pytest.approx(j["aux"], rel=1e-2)


@pytest.mark.parametrize("arch,key", [("whisper-small", "frames"), ("pixtral-12b", "embeds")])
def test_trainer_refuses_what_its_data_cannot_feed(arch, key, tmp_path):
    """The port refuses at construction, naming the batch key; the
    reference's trainer fails on the same key at its first step."""

    with pytest.raises(ValueError, match=repr(key)):
        Trainer(get_config(arch).reduced(), device="cpu",
                tcfg=TrainerConfig(steps=1, global_batch=2, seq_len=16, ckpt_dir=str(tmp_path / "p")))
    jt = JTrainer(jax_config(arch).reduced(), make_host_mesh(),
                  tcfg=JTrainerConfig(steps=1, global_batch=2, seq_len=16, ckpt_dir=str(tmp_path / "j")))
    with pytest.raises(KeyError, match=key):
        jt.run()


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-1.3b"])
def test_train_cli_trains_the_family(arch, tmp_path, capsys):
    out = train_cli.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "3",
                          "--seq", "32", "--ckpt-dir", str(tmp_path)])
    assert json.loads(capsys.readouterr().out) == out
    assert set(out) == {"arch", "device_class", "exec_backend", "class_sharded", "shard_classes",
                        "steps", "first_loss", "last_loss", "restarts", "wall_s", "chunk_sizes"}
    assert out["arch"] == get_config(arch).reduced().name
    assert out["steps"] == 3 and out["restarts"] == 0 and out["class_sharded"] is False
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])
