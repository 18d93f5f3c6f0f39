"""The MoE family's sharded step on CPU ranks against the reference.

``gloo`` ranks spawned by ``launch.mesh.spawn_ranks`` run reduced
qwen2-moe-a2.7b (a shared expert; ``rs_output`` off: the experts' partial
sums all-reduced) and reduced mixtral-8x7b (``rs_output``: reduce-scattered
over D; its sliding window of 8 makes every decode cache a ring) on the
meshes (data=2, model=2) and (data=1, model=4) (4 heads a config: both
split 4 ways), from the reference's parameters; ``tests/spmd_workers.py``
holds the rank function (``family_run``).  Held:

  * the trainer's losses within 1% of the reference's ``Trainer`` on the
    same host mesh (each routing on its own), and each step replayed from
    the reference's state before it: loss within 1%, ``grad_norm`` within
    3%, the learning rate exactly (free-running, the reference's own
    trainer moves its step-1 ``grad_norm`` by 2.6% between meshes (1,1)
    and (2,2));
  * step-0 gradients within 0.03 relative L2 of ``jax.value_and_grad``'s,
    leaf by leaf, and the router's aux loss, with the reference's routing
    forced on both sides (``tests/test_torch_train_families.py``'s
    reason: a last-bit difference flips a top-k choice); at (2,2) also
    with the stream sequence-sharded;
  * the prefill logits and a decode step's after a bulk prefill of 4
    within ``BF16_TOL``, routing forced;
  * mixtral's decode at a batch of 1 past its window (its ring of 8 split
    over ``(data, model)`` at (2,2));
  * a decode step of 12 rows whose merged routing group overflows its
    capacity (every row's top 2 forced to experts 0 and 1: 12 decisions
    each against 8 slots): the rows are routed as the reference's one
    group of 12, not as each dp rank's 6;
  * the GEMM funnel's calls a rank equal one card's.
"""

import numpy as np
import pytest

import spmd_reference as R
from repro.configs import get_config as jax_config
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import RankMesh
from repro_torch.models import transformer as T

ARCHS = ("qwen2-moe-a2.7b", "mixtral-8x7b")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
TCFG = dict(steps=2, global_batch=4, seq_len=16)
OPT = dict(lr=1e-3, total_steps=2, warmup_steps=2)
B, S, PREFILL_LEN, SEQ_LEN = 4, 16, 4, 16
RING_LEN = 9           # mixtral's batch of 1: 9 tokens into a ring of 8, then a step
OVERFLOW_ROWS = 12


def _overflow_ids(cfg):
    """Every row's top 2 at experts 0 and 1, one (1, 12, 2) array a layer."""

    ids = np.tile(np.array([0, 1], np.int32), (1, OVERFLOW_ROWS, 1))
    return [ids] * cfg.n_layers


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = {}
    for arch in ARCHS:
        jcfg, jparams = R._reference_params(arch)
        rng = np.random.default_rng(7)
        batch = {k: rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32) for k in ("tokens", "labels")}
        _, ids = R.captured(lambda p, b: R.JZ.make_loss_fn(jcfg, remat=False)(p, b), jparams,
                            {k: R.jnp.asarray(v) for k, v in batch.items()})
        assert len(ids) == jcfg.n_layers
        tokens = rng.integers(0, jcfg.vocab, (B, PREFILL_LEN + 1)).astype(np.int32)
        prefill, prefill_ids = R.prefill_logits(jcfg, jparams, {"tokens": tokens})
        decode, decode_ids = R.decode_logits(jcfg, jparams, tokens, PREFILL_LEN, SEQ_LEN)
        rec = {"params": R.jax.tree.map(np.asarray, jparams), "batch": batch, "ids": ids,
               "grads": R.value_and_grad(jcfg, jparams, batch, ids), "tokens": tokens,
               "prefill": prefill, "prefill_ids": prefill_ids, "decode": decode,
               "decode_ids": decode_ids}
        over = rng.integers(0, jcfg.vocab, (OVERFLOW_ROWS, 1)).astype(np.int32)
        rec["overflow_tokens"] = over
        rec["overflow"], _ = R.decode_logits(jcfg, jparams, over, 0, 8, ids=_overflow_ids(jcfg))
        if jcfg.swa_window:
            one = rng.integers(0, jcfg.vocab, (1, RING_LEN + 1)).astype(np.int32)
            rec["one_tokens"] = one
            rec["one"], rec["one_ids"] = R.decode_logits(jcfg, jparams, one, RING_LEN, SEQ_LEN)
        rec["train"] = {}
        for name, mesh in MESHES.items():
            rec["train"][name] = R.trainer(jcfg, mesh, TCFG, OPT,
                                           str(tmp_path_factory.mktemp(f"j{arch}{name}")))
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
            decodes = {
                "decode": {"tokens": ref["tokens"], "prefill_len": PREFILL_LEN, "seq_len": SEQ_LEN,
                           "ids": ref["decode_ids"]},
                "overflow": {"tokens": ref["overflow_tokens"], "prefill_len": 0, "seq_len": 8,
                             "ids": _overflow_ids(cfg)},
            }
            if "one" in ref:
                decodes["one"] = {"tokens": ref["one_tokens"], "prefill_len": RING_LEN,
                                  "seq_len": SEQ_LEN, "ids": ref["one_ids"]}
            cases.append({"name": arch, "cfg": cfg, "params": ref["params"],
                          "grads": {"batch": ref["batch"], "ids": ref["ids"],
                                    "seq_shard": name == "2x2"},
                          "prefill": {"batch": {"tokens": ref["tokens"]}, "ids": ref["prefill_ids"]},
                          "decodes": decodes})
        plans[name] = (mesh, cases)
    return R.run_meshes(plans)


CELLS = [(a, m) for a in ARCHS for m in MESHES]


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_sharded_moe_trainer_matches_reference_trainer(arch, mesh, reference, port):
    R.check_trainer(reference[arch]["train"][mesh][1], port[mesh][arch + ":train"], TCFG["steps"])


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_sharded_moe_gradients_match_reference(arch, mesh, reference, port):
    want = reference[arch]["grads"]
    cfg = get_config(arch).reduced()
    runs = [port[mesh][arch]["grads"]]
    if "grads_seq_shard" in port[mesh][arch]:
        runs.append(port[mesh][arch]["grads_seq_shard"])
    for got in runs:
        assert got["route_calls"] == cfg.n_layers
        assert abs(got["loss"] - want["loss"]) <= 2e-3
        assert got["aux"] == pytest.approx(want["aux"], rel=1e-3)
        flat = R._flat(got["grads"])
        assert set(flat) == set(want["grads"])
        for key, jg in want["grads"].items():
            g = flat[key].float().numpy()
            assert g.shape == jg.shape, key
            assert R.rel_l2(g, jg) <= R.GRAD_RTOL, (mesh, key, R.rel_l2(g, jg))


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_sharded_moe_prefill_and_decode_logits_match_reference(arch, mesh, reference, port):
    res, ref = port[mesh][arch], reference[arch]
    np.testing.assert_allclose(res["prefill"]["logits"].float().numpy(), ref["prefill"], **R.BF16_TOL)
    np.testing.assert_allclose(res["decode"]["logits"].float().numpy(), ref["decode"], **R.BF16_TOL)
    cfg = get_config(arch).reduced()
    one_card = sum(calls for _, calls in T.gemm_shapes(cfg))
    assert res["prefill"]["gemm_calls"] == res["decode"]["gemm_calls"] == one_card


@pytest.mark.parametrize("mesh", list(MESHES))
def test_ring_decode_at_a_batch_of_one_matches_reference(mesh, reference, port):
    res, ref = port[mesh]["mixtral-8x7b"]["one"], reference["mixtral-8x7b"]
    np.testing.assert_allclose(res["logits"].float().numpy(), ref["one"], **R.BF16_TOL)
    # The ring's 8 slots split over the dp axes and model: 2 a rank.
    assert res["specs"]["k"][2] == ("data", "model") if mesh == "2x2" else ("model",)


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_overflowing_decode_group_matches_reference(arch, mesh, reference, port):
    got = port[mesh][arch]["overflow"]["logits"].float().numpy()
    want = reference[arch]["overflow"]
    np.testing.assert_allclose(got, want, **R.BF16_TOL)
    # Rows 8-11 lost both experts to the capacity of 8: their logits are
    # not those of rows routed in a group of 6, which keeps them.
    assert np.abs(want[8:] - want[:4]).max() > 0


def test_sharded_moe_collective_bytes_equal_dry_run(port):
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    shape = ShapeSpec("spmd", TCFG["seq_len"], TCFG["global_batch"], "train")
    rec = D.run_cell(cfg, shape, mesh=RankMesh.abstract(("data", "model"), MESHES["2x2"]),
                     seq_shard=False, write=False)
    assert rec["ok"], rec.get("error")
    got = port["2x2"]["qwen2-moe-a2.7b:train"]["history"][0]
    assert got["collective_bytes"] == pytest.approx(rec["hlo_cost"]["by_collective"])
    assert rec["hlo_cost"]["gemm_calls"] == got["gemm_calls"]
