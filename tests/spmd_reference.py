"""The reference's side of the sharded family tests
(``tests/test_torch_spmd_{moe,ssm,encdec}.py``): its trainer on a host
mesh, its gradients and logits, and the MoE routing captured from its
eager forward (``jax.lax.top_k`` under ``jax.disable_jit``, the layer
scans unrolled) to be forced on both sides, as
``tests/test_torch_train_families.py`` forces it."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np

from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.models import model_zoo as JZ
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.runtime.trainer import Trainer as JTrainer
from repro.runtime.trainer import TrainerConfig as JTrainerConfig

from test_torch_train import _flat, _reference_params  # noqa: F401 (re-exported)
from test_torch_train_families import NO_EXCESS, _unrolled_scan

BF16_TOL = dict(rtol=2e-2, atol=2e-2)
LOSS_RTOL, NORM_RTOL, GRAD_RTOL = 1e-2, 3e-2, 0.03


@contextlib.contextmanager
def routing(ids=None):
    """``jax.lax.top_k`` recording its ids into ``ids`` (a list) or, given
    a list, returning them in call order; ``jax.lax.scan`` unrolled so the
    layers call it once each, in order.  Yields the list."""

    real_top_k, real_scan = jax.lax.top_k, jax.lax.scan
    forced = ids is not None
    ids = list(ids) if forced else []
    calls = [0]

    def top_k(probs, k):
        if not forced:
            out = real_top_k(probs, k)
            ids.append(np.array(out[1]))
            return out
        idx = jnp.asarray(ids[calls[0]])
        calls[0] += 1
        return jnp.take_along_axis(probs, idx, axis=-1), idx

    jax.lax.top_k, jax.lax.scan = top_k, _unrolled_scan
    try:
        yield ids
    finally:
        jax.lax.top_k, jax.lax.scan = real_top_k, real_scan


def captured(fn, *args):
    """``(fn(*args), ids)``: run eagerly, the routing recorded."""

    with jax.disable_jit(), routing() as ids:
        out = fn(*args)
    return out, ids


def value_and_grad(jcfg, jparams, batch, ids=None):
    """The reference's loss, aux and flat gradients (no remat), compiled
    with excess precision off, its routing forced to ``ids`` when given."""

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    f = jax.value_and_grad(JZ.make_loss_fn(jcfg, remat=False), has_aux=True)
    with (routing(ids) if ids is not None else contextlib.nullcontext()):
        compiled = jax.jit(f).lower(jparams, jbatch).compile(compiler_options=NO_EXCESS)  # repro: noqa=RPR003 -- one compile a family
    (loss, metrics), grads = compiled(jparams, jbatch)
    return {"loss": float(loss), "aux": float(metrics.get("aux", 0.0)),
            "grads": _flat(jax.tree.map(np.asarray, grads))}


def trainer(jcfg, mesh, tcfg, opt, ckpt_dir):
    """The reference's trainer on a host mesh ``(data, model)``:
    ``(params, history, states)``, its initial params (numpy), its history
    and its ``(params, opt_state)`` before each step (numpy copies: the
    step donates them)."""

    jt = JTrainer(jcfg, jax_host_mesh(data=mesh[0], model=mesh[1]), opt_cfg=JAdamWConfig(**opt),
                  tcfg=JTrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=100, **tcfg))
    params = jax.tree.map(np.asarray, jt.params)
    jt._checkpoint = lambda: None
    states, step = [], jt.train_step

    def record(params, opt_state, batch):
        states.append(jax.tree.map(lambda a: np.array(a, copy=True), (params, opt_state)))
        return step(params, opt_state, batch)

    jt.train_step = record
    return params, jt.run(), states


def prefill_logits(jcfg, jparams, batch):
    """The forward's logits, eager, and the routing it took."""

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    out, ids = captured(JZ.make_prefill_fn(jcfg), jparams, jbatch)
    return np.asarray(out.astype(jnp.float32)), ids


def decode_logits(jcfg, jparams, tokens, prefill_len, seq_len, *, cross=None, ids=None):
    """A bulk prefill of ``prefill_len`` tokens and one decode step over a
    cache of ``seq_len``, eager: the step's logits and the routing taken
    (forced to ``ids`` when given).  ``cross``: the enc-dec's frames, whose
    cross K/V fill the state first."""

    state = JZ.init_decode_state(jcfg, tokens.shape[0], seq_len)
    if cross is not None:
        from repro.models import encdec as JE
        from repro.models import layers as JL

        enc = JE.encode(jparams, jcfg, jnp.asarray(cross))
        xcfg = JE._acfg(jcfg, causal=False)
        ks, vs = zip(*(JL.encode_cross_kv(jax.tree.map(lambda a: a[i], jparams["dec_blocks"])["xkv"],
                                          enc, xcfg) for i in range(jcfg.n_layers)))
        state = dict(state, cross_k=jnp.stack(ks).astype(state["cross_k"].dtype),
                     cross_v=jnp.stack(vs).astype(state["cross_v"].dtype))
    toks = jnp.asarray(tokens)

    def run():
        st = state
        if prefill_len:
            _, st = JZ.make_prefill_fn(jcfg, with_cache=True)(
                jparams, {"tokens": toks[:, :prefill_len]}, st, 0)
        return JZ.make_decode_fn(jcfg)(jparams, {"tokens": toks[:, prefill_len:prefill_len + 1]},
                                       st, prefill_len)[0]

    with jax.disable_jit(), routing(ids) as got:
        out = run()
    return np.asarray(out.astype(jnp.float32)), got


def rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def check_trainer(want, got, steps: int) -> None:
    """The port's free-running losses and its replayed steps (each from the
    reference's state before it) against the reference's history."""

    import pytest

    assert len(got["history"]) == len(got["replay"]) == len(want) == steps
    for j, p, r in zip(want, got["history"], got["replay"]):
        assert p["loss"] == pytest.approx(j["loss"], rel=LOSS_RTOL)
        assert r["loss"] == pytest.approx(j["loss"], rel=LOSS_RTOL)
        assert r["grad_norm"] == pytest.approx(j["grad_norm"], rel=NORM_RTOL)
        assert r["lr"] == pytest.approx(j["lr"], rel=1e-6)
        if j.get("aux"):
            assert r["aux"] > 0 and r["aux"] == pytest.approx(j["aux"], rel=LOSS_RTOL)


def run_meshes(plans: dict) -> dict:
    """``{name: (mesh, cases)}`` -> rank 0's ``spmd_workers.family_run``
    results a mesh, the meshes' ranks spawned side by side."""

    from concurrent.futures import ThreadPoolExecutor

    import spmd_workers as W
    from repro_torch.launch.mesh import spawn_ranks

    with ThreadPoolExecutor(len(plans)) as pool:
        futures = {name: pool.submit(spawn_ranks, W.family_run, mesh[0] * mesh[1],
                                     {"mesh": mesh, "cases": cases}, device="cpu", timeout=300)
                   for name, (mesh, cases) in plans.items()}
        return {name: f.result()[0] for name, f in futures.items()}
