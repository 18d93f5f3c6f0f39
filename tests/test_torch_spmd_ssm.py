"""The Mamba2 and hybrid families' sharded step on CPU ranks against the
reference.

``gloo`` ranks spawned by ``launch.mesh.spawn_ranks`` run reduced
mamba2-1.3b and reduced zamba2-2.7b (two groups of two Mamba2 layers,
each followed by the weight-shared attention block) on the meshes
(data=2, model=2) and (data=1, model=4) (8 SSM heads, 4 attention heads:
both split 4 ways), from the reference's parameters;
``tests/spmd_workers.py`` holds the rank function (``family_run``).  The
Mamba2 block runs column-parallel ``wz`` / ``wx`` / ``wdt`` (its heads
over ``model``), ``wbc`` whole, its gated RMSNorm's mean over the whole
``d_inner``, ``out_proj`` row-parallel.  Held:

  * the trainer's losses within 1% of the reference's ``Trainer`` on the
    same host mesh, and each step replayed from the reference's state
    before it: loss within 1%, ``grad_norm`` within 3%, the learning rate
    exactly;
  * step-0 gradients within 0.03 relative L2 of ``jax.value_and_grad``'s
    (compiled with excess precision off), leaf by leaf;
  * the prefill logits and a decode step's after a bulk prefill of 4
    within ``BF16_TOL``;
  * a planted fault (each rank's gated RMSNorm taking its own mean)
    moves those prefill logits past ``BF16_TOL``;
  * a decode step at a batch of 1, the SSM states' heads (and zamba2's
    shared ring) split over ``(data, model)`` at (2,2);
  * the GEMM funnel's calls a rank equal one card's (the Mamba2
    projections are plain products on both).
"""

import numpy as np
import pytest

import spmd_reference as R
from repro_torch.configs import get_config
from repro_torch.models import transformer as T

ARCHS = ("mamba2-1.3b", "zamba2-2.7b")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
TCFG = dict(steps=2, global_batch=4, seq_len=16)
OPT = dict(lr=1e-3, total_steps=2, warmup_steps=2)
B, S, PREFILL_LEN, SEQ_LEN = 4, 16, 4, 16


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = {}
    for arch in ARCHS:
        jcfg, jparams = R._reference_params(arch)
        rng = np.random.default_rng(11)
        batch = {k: rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32) for k in ("tokens", "labels")}
        tokens = rng.integers(0, jcfg.vocab, (B, PREFILL_LEN + 1)).astype(np.int32)
        one = rng.integers(0, jcfg.vocab, (1, PREFILL_LEN + 1)).astype(np.int32)
        rec = {"params": R.jax.tree.map(np.asarray, jparams), "batch": batch, "tokens": tokens,
               "one_tokens": one, "grads": R.value_and_grad(jcfg, jparams, batch),
               "prefill": R.prefill_logits(jcfg, jparams, {"tokens": tokens})[0],
               "decode": R.decode_logits(jcfg, jparams, tokens, PREFILL_LEN, SEQ_LEN)[0],
               "one": R.decode_logits(jcfg, jparams, one, PREFILL_LEN, SEQ_LEN)[0],
               "train": {name: R.trainer(jcfg, mesh, TCFG, OPT,
                                         str(tmp_path_factory.mktemp(f"j{arch}{name}")))
                         for name, mesh in MESHES.items()}}
        out[arch] = rec
    return out


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    plans = {}
    for name, mesh in MESHES.items():
        cases = []
        for arch in ARCHS:
            ref, cfg = reference[arch], get_config(arch).reduced()
            tparams, _, states = ref["train"][name]
            cases.append({"name": arch + ":train", "cfg": cfg, "params": tparams,
                          "train": {"tcfg": TCFG, "opt": OPT, "states": states,
                                    "ckpt_dir": str(tmp_path_factory.mktemp(f"p{arch}{name}"))}})
            cases.append({
                "name": arch, "cfg": cfg, "params": ref["params"],
                "grads": {"batch": ref["batch"], "ids": None},
                "prefill": {"batch": {"tokens": ref["tokens"]}, "ids": None, "local_norm": True},
                "decodes": {
                    "decode": {"tokens": ref["tokens"], "prefill_len": PREFILL_LEN,
                               "seq_len": SEQ_LEN},
                    "one": {"tokens": ref["one_tokens"], "prefill_len": PREFILL_LEN,
                            "seq_len": SEQ_LEN},
                }})
        plans[name] = (mesh, cases)
    return R.run_meshes(plans)


CELLS = [(a, m) for a in ARCHS for m in MESHES]


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_sharded_ssm_trainer_matches_reference_trainer(arch, mesh, reference, port):
    R.check_trainer(reference[arch]["train"][mesh][1], port[mesh][arch + ":train"], TCFG["steps"])


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_sharded_ssm_gradients_match_reference(arch, mesh, reference, port):
    want, got = reference[arch]["grads"], port[mesh][arch]["grads"]
    assert abs(got["loss"] - want["loss"]) <= 2e-3
    flat = R._flat(got["grads"])
    assert set(flat) == set(want["grads"])
    for key, jg in want["grads"].items():
        g = flat[key].float().numpy()
        assert g.shape == jg.shape, key
        assert R.rel_l2(g, jg) <= R.GRAD_RTOL, (mesh, key, R.rel_l2(g, jg))


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_sharded_ssm_prefill_and_decode_logits_match_reference(arch, mesh, reference, port):
    res, ref = port[mesh][arch], reference[arch]
    np.testing.assert_allclose(res["prefill"]["logits"].float().numpy(), ref["prefill"], **R.BF16_TOL)
    np.testing.assert_allclose(res["decode"]["logits"].float().numpy(), ref["decode"], **R.BF16_TOL)
    cfg = get_config(arch).reduced()
    one_card = sum(calls for _, calls in T.gemm_shapes(cfg))
    assert res["prefill"]["gemm_calls"] == res["decode"]["gemm_calls"] == one_card


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_local_mean_norm_fault_fails_the_logit_hold(arch, mesh, reference, port):
    # The gated RMSNorm's mean taken over a rank's half or quarter of
    # d_inner (a planted fault) moves the prefill logits past the
    # tolerance the sharded step is held to above.
    got = port[mesh][arch]["prefill_local_norm"]["logits"].float().numpy()
    want = reference[arch]["prefill"]
    assert not np.allclose(got, want, **R.BF16_TOL), (mesh, float(np.abs(got - want).max()))


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_batch_of_one_decode_matches_reference(arch, mesh, reference, port):
    res = port[mesh][arch]["one"]
    np.testing.assert_allclose(res["logits"].float().numpy(), reference[arch]["one"], **R.BF16_TOL)
    # A batch of 1: the SSM state's heads over the dp axes and model.
    assert res["ssm_spec"][2] == (("data", "model") if mesh == "2x2" else ("model",))
    assert res["ssm_spec"][1] is None if mesh == "2x2" else True
