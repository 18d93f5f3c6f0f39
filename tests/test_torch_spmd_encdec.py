"""The enc-dec family's sharded step on CPU ranks against the reference.

``gloo`` ranks spawned by ``launch.mesh.spawn_ranks`` run reduced
whisper-small on the meshes (data=2, model=2) and (data=1, model=4) (4
heads: split 4 ways), from the reference's parameters;
``tests/spmd_workers.py`` holds the rank function (``family_run``).  Its
vocab is set to 255, which neither mesh's ``model`` axis divides, as
whisper-small's 51,865 is not divided by 2 or 16: the reference's
``_drop_indivisible`` replicates the tied ``embed`` over ``model`` and the
logits stay whole.  At (2,2) the reduced vocab of 256 runs too (the tied
head vocab-parallel).  The encoder's and decoder's self-attention and the
cross-attention run through ``layers.apply_attention_tp``, the GELU MLPs
through ``layers.apply_mlp_tp``.  Held (the reference's trainer cannot
train whisper: its data gives no frames):

  * step-0 gradients within 0.03 relative L2 of ``jax.value_and_grad``'s
    (compiled with excess precision off), leaf by leaf, the loss within
    2e-3, at (2,2) also with both streams sequence-sharded;
  * ``trainer.sharded_train_step`` on ``make_loss_fn(cfg, mesh=)``: its
    loss within 1% and its ``grad_norm`` within 3% of the reference's
    loss and gradients' norm;
  * the prefill (encoder + decoder forward) logits, and a decode step's
    after the cross K/V are filled and a bulk prefill of 4, within
    ``BF16_TOL`` (the cross K/V's encoder positions split over ``model``
    as ``cache_pspec`` splits them);
  * the GEMM funnel's and the attention's calls a rank equal one card's
    (the decode's cross-attention through ``dispatch_flash_attention``).
"""

import dataclasses

import jax
import numpy as np
import pytest

import spmd_reference as R
from repro.configs import get_config as jax_config
from repro.models import model_zoo as JZ
from repro_torch.configs import get_config
from repro_torch.models import transformer as T

ARCH = "whisper-small"
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
VOCABS = {"whole": 255, "split": 256}       # "split" at (2,2) only
B, S, PREFILL_LEN, SEQ_LEN = 4, 16, 4, 16


def _cfgs(vocab):
    jcfg = dataclasses.replace(jax_config(ARCH).reduced(), vocab=vocab)
    return jcfg, dataclasses.replace(get_config(ARCH).reduced(), vocab=vocab)


def _cells():
    return [(v, m) for v in VOCABS for m in MESHES if v == "whole" or m == "2x2"]


@pytest.fixture(scope="module")
def reference():
    out = {}
    for name, vocab in VOCABS.items():
        jcfg, _ = _cfgs(vocab)
        jparams = JZ.init_params(jax.random.PRNGKey(0), jcfg)
        rng = np.random.default_rng(13)
        frames = rng.normal(size=(B, jcfg.enc_frames, jcfg.d_model)).astype(np.float32)
        batch = {"frames": frames,
                 **{k: rng.integers(0, vocab, (B, S)).astype(np.int32) for k in ("tokens", "labels")}}
        tokens = rng.integers(0, vocab, (B, PREFILL_LEN + 1)).astype(np.int32)
        grads = R.value_and_grad(jcfg, jparams, batch)
        out[name] = {
            "params": jax.tree.map(np.asarray, jparams), "batch": batch, "tokens": tokens,
            "grads": grads,
            "norm": float(np.sqrt(sum(np.sum(np.square(g)) for g in grads["grads"].values()))),
            "prefill": R.prefill_logits(jcfg, jparams, {"frames": frames, "tokens": tokens})[0],
            "decode": R.decode_logits(jcfg, jparams, tokens, PREFILL_LEN, SEQ_LEN, cross=frames)[0],
        }
    return out


@pytest.fixture(scope="module")
def port(reference):
    plans = {}
    for mesh_name, mesh in MESHES.items():
        cases = []
        for name, vocab in VOCABS.items():
            if (name, mesh_name) not in _cells():
                continue
            ref = reference[name]
            cases.append({
                "name": name, "cfg": _cfgs(vocab)[1], "params": ref["params"],
                "grads": {"batch": ref["batch"], "ids": None, "seq_shard": mesh_name == "2x2"},
                "step": ref["batch"],
                "prefill": {"batch": {"frames": ref["batch"]["frames"], "tokens": ref["tokens"]},
                            "ids": None},
                "decodes": {"decode": {"tokens": ref["tokens"], "frames": ref["batch"]["frames"],
                                       "prefill_len": PREFILL_LEN, "seq_len": SEQ_LEN}},
            })
        plans[mesh_name] = (mesh, cases)
    return R.run_meshes(plans)


@pytest.mark.parametrize("vocab,mesh", _cells())
def test_sharded_encdec_gradients_match_reference(vocab, mesh, reference, port):
    want, res = reference[vocab]["grads"], port[mesh][vocab]
    runs = [res["grads"]] + ([res["grads_seq_shard"]] if "grads_seq_shard" in res else [])
    for got in runs:
        assert abs(got["loss"] - want["loss"]) <= 2e-3
        flat = R._flat(got["grads"])
        assert set(flat) == set(want["grads"])
        for key, jg in want["grads"].items():
            g = flat[key].float().numpy()
            assert g.shape == jg.shape, key
            assert R.rel_l2(g, jg) <= R.GRAD_RTOL, (mesh, key, R.rel_l2(g, jg))


@pytest.mark.parametrize("vocab,mesh", _cells())
def test_sharded_encdec_gradient_step_matches_reference(vocab, mesh, reference, port):
    step = port[mesh][vocab]["step"]
    assert step["loss"] == pytest.approx(reference[vocab]["grads"]["loss"], rel=R.LOSS_RTOL)
    assert step["grad_norm"] == pytest.approx(reference[vocab]["norm"], rel=R.NORM_RTOL)


@pytest.mark.parametrize("vocab,mesh", _cells())
def test_sharded_encdec_prefill_and_decode_logits_match_reference(vocab, mesh, reference, port):
    res, ref = port[mesh][vocab], reference[vocab]
    np.testing.assert_allclose(res["prefill"]["logits"].float().numpy(), ref["prefill"], **R.BF16_TOL)
    np.testing.assert_allclose(res["decode"]["logits"].float().numpy(), ref["decode"], **R.BF16_TOL)
    # Every product of the step through the funnel, as one card's: per
    # decoder layer q, k, v, o, the cross q and o, the MLP's two, and the
    # tied head; the forward adds the encoder's six a layer and the cross
    # K/V's two a decoder layer.
    cfg = _cfgs(VOCABS[vocab])[1]
    assert res["decode"]["gemm_calls"] == 8 * cfg.n_layers + 1
    assert res["prefill"]["gemm_calls"] == 6 * cfg.enc_layers + 10 * cfg.n_layers + 1
    assert res["decode"]["specs"]["cross_k"][2] == ("model",)
    # One card's attention calls: a decode step's cross-attention a decoder
    # layer (its split encoder positions gathered whole first), the
    # forward's three a decoder layer and one an encoder layer.
    assert res["decode"]["flash_calls"] == cfg.n_layers
    assert res["prefill"]["flash_calls"] == cfg.enc_layers + 2 * cfg.n_layers
