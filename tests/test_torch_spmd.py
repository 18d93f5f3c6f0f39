"""The sharded step on CPU ranks against the reference's on the same mesh.

``gloo`` ranks spawned by ``launch.mesh.spawn_ranks`` (a ``FileStore`` in
a temporary directory, no port) run reduced internlm2-1.8b on the meshes
(data=2, model=2), (data=1, model=4) — 2 KV heads under 4 model ranks:
wk holds half a head a rank and the KV heads are gathered whole — and
(pod=2, data=2, model=2), from the reference's parameters
(``convert.train_state_from_jax(..., mesh=)``); ``tests/spmd_workers.py``
holds the rank function.  The reference's ``Trainer`` runs on the same
host meshes (the conftest's 8 XLA devices).  Held, as in
``tests/test_torch_train.py``:

  * losses within 1% and ``grad_norm`` within 3% of the reference's
    trainer, step by step, and the learning rate exactly;
  * the gathered gradients of step 0 within 0.03 relative L2 of
    ``jax.value_and_grad``'s, leaf by leaf (at (2,2,2) also with the
    stream sequence-sharded, the reference's dry-run setting);
  * the prefill logits and one decode step's (a cache of 32 positions,
    split over ``model``) within ``BF16_TOL`` of the reference's;
  * every product through the GEMM funnel: 4n - 1 calls a step a rank;
  * the (2,2) run within 1e-3 of the one-process port's losses;
  * a checkpoint written on (2,2) restores on (4,1) and on one process,
    and the (2,2) trainer resharded to (4,1) takes the step the (4,1)
    trainer restored from that checkpoint takes (losses within 1e-5);
  * a rank's collective bytes a step equal the dry-run's count for the
    same cell on the abstract (2,2) mesh;
  * the context-parallel split (6 heads over 4 model ranks) against the
    one-process port: loss, gradients, prefill logits.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.models import model_zoo as JZ
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.runtime.trainer import Trainer as JTrainer
from repro.runtime.trainer import TrainerConfig as JTrainerConfig

import spmd_workers as W
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.convert import train_state_from_jax
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import RankMesh, spawn_ranks
from repro_torch.models import model_zoo as Z
from repro_torch.optim import adamw as O
from repro_torch.runtime.trainer import Trainer, TrainerConfig

BF16_TOL = dict(rtol=2e-2, atol=2e-2)
TCFG = dict(steps=2, global_batch=4, seq_len=16)
OPT = dict(lr=1e-3, total_steps=2, warmup_steps=2)
MESHES = {"2x2": (2, 2, 0), "1x4": (1, 4, 0), "2x2x2": (2, 2, 2)}
SEQ_LEN, PREFILL_LEN = 32, 8


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's trainer on each host mesh, and its step-0
    gradients, prefill and decode logits from the same parameters."""

    jcfg = jax_config(W.ARCH).reduced()
    runs, params = {}, None
    for name, (data, model, pod) in MESHES.items():
        jt = JTrainer(jcfg, jax_host_mesh(data=data, model=model, pod=pod),
                      opt_cfg=JAdamWConfig(**OPT),
                      tcfg=JTrainerConfig(ckpt_dir=str(tmp_path_factory.mktemp(f"j{name}")),
                                          ckpt_every=100, **TCFG))
        if params is None:
            params = jax.tree.map(np.asarray, jt.params)
        jt._checkpoint = lambda: None  # nothing written: the port's checkpoints are held below
        runs[name] = jt.run()
    batch0 = jt.data.batch(0, TCFG["global_batch"], TCFG["seq_len"])
    jparams = jax.tree.map(jax.numpy.asarray, params)
    (_, _), grads = jax.value_and_grad(JZ.make_loss_fn(jcfg), has_aux=True)(jparams, batch0)
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab, (4, PREFILL_LEN + 1)).astype(np.int32)
    prefill = JZ.make_prefill_fn(jcfg)(jparams, {"tokens": tokens})
    state = JZ.init_decode_state(jcfg, 4, SEQ_LEN)
    _, state = JZ.make_prefill_fn(jcfg, with_cache=True)(jparams, {"tokens": tokens[:, :PREFILL_LEN]},
                                                         state, 0)
    step, _ = JZ.make_decode_fn(jcfg)(jparams, {"tokens": tokens[:, PREFILL_LEN:]}, state,
                                      PREFILL_LEN)
    return {"runs": runs, "params": params, "grads": _flat(jax.tree.map(np.asarray, grads)),
            "tokens": tokens, "prefill": np.asarray(prefill.astype(np.float32)),
            "decode": np.asarray(step.astype(np.float32))}


def _cp_case():
    """A config whose 6 query heads 4 model ranks cannot split."""

    cfg = dataclasses.replace(get_config(W.ARCH).reduced(), n_heads=6)
    gen = torch.Generator().manual_seed(0)
    params = Z.init_params(cfg, gen, "cpu", dtype=torch.float32)
    serve = O.tree_map(lambda p: p.to(torch.bfloat16) if p.ndim >= 2 else p, params)
    rng = np.random.default_rng(5)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32))
             for k in ("tokens", "labels")}
    return {"cfg": cfg, "params": params, "serve": serve, "batch": batch}


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    """Each mesh's spawned run (rank 0's results) and the one-process port."""

    tokens = torch.from_numpy(reference["tokens"])
    out = {}
    for name, mesh in MESHES.items():
        plan = {"mesh": mesh, "params": reference["params"], "tcfg": TCFG, "opt": OPT,
                "tokens": tokens, "prefill_len": PREFILL_LEN, "seq_len": SEQ_LEN,
                "ckpt_dir": str(tmp_path_factory.mktemp(f"ckpt{name}"))}
        if name == "2x2":
            plan["reshard"] = (4, 1, 0)
        if name == "2x2x2":
            plan["seq_shard_grads"] = True
        if name == "1x4":
            plan["cp"] = _cp_case()
        world = mesh[0] * mesh[1] * (mesh[2] or 1)
        out[name] = spawn_ranks(W.mesh_run, world, plan, device="cpu", timeout=180)[0]
        out[name]["ckpt_dir"] = plan["ckpt_dir"]
    cfg = get_config(W.ARCH).reduced()
    params, opt_state = train_state_from_jax(reference["params"], None, device="cpu")
    one = Trainer(cfg, opt_cfg=O.AdamWConfig(**OPT), device="cpu", params=params,
                  opt_state=opt_state,
                  tcfg=TrainerConfig(ckpt_dir=str(tmp_path_factory.mktemp("one")), ckpt_every=100,
                                     **TCFG))
    out["one"] = []
    for step in range(TCFG["steps"]):
        batch, _ = one.next_batch(step)
        out["one"].append({k: float(v) for k, v in one.train_step(batch).items()})
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_trainer_matches_reference_trainer(mesh, reference, port):
    want, got = reference["runs"][mesh], port[mesh]["history"]
    assert len(got) == len(want) == TCFG["steps"]
    for j, p in zip(want, got):
        assert p["loss"] == pytest.approx(j["loss"], rel=1e-2)
        assert p["grad_norm"] == pytest.approx(j["grad_norm"], rel=3e-2)
        assert p["lr"] == pytest.approx(j["lr"], rel=1e-6)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_gradients_match_reference(mesh, reference, port):
    runs = [port[mesh]["grads"]] + ([port[mesh]["grads_seq_shard"]]
                                    if "grads_seq_shard" in port[mesh] else [])
    for _, grads in runs:
        got = _flat(grads)
        assert set(got) == set(reference["grads"])
        for key, jg in reference["grads"].items():
            g = got[key].float().numpy()
            assert g.shape == jg.shape, key
            rel = np.linalg.norm(g - jg) / max(np.linalg.norm(jg), 1e-12)
            assert rel <= 0.03, (mesh, key, rel)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_prefill_and_decode_logits_match_reference(mesh, reference, port):
    prefill, step = port[mesh]["logits"]
    np.testing.assert_allclose(prefill.float().numpy(), reference["prefill"], **BF16_TOL)
    np.testing.assert_allclose(step.float().numpy(), reference["decode"], **BF16_TOL)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_every_product_goes_through_the_funnel(mesh, port):
    cfg = get_config(W.ARCH).reduced()
    n = 7 * cfg.n_layers + 1  # q, k, v, o, gate, up, down a layer and the LM head
    for h in port[mesh]["history"]:
        assert h["gemm_calls"] == 4 * n - 1
    data, model, pod = MESHES[mesh]
    assert port[mesh]["local_batch_rows"] == TCFG["global_batch"] // (data * (pod or 1))
    wk = port[mesh]["specs"]["blocks"]["attn"]["wk"]
    assert wk[-1] == ("model" if model > 1 else None)  # 2 KV heads: split only in columns


def test_two_by_two_matches_one_process(port):
    for one, two in zip(port["one"], port["2x2"]["history"]):
        assert two["loss"] == pytest.approx(one["loss"], rel=1e-3)


def test_checkpoint_restores_across_meshes_and_reshard_matches(port, tmp_path):
    run = port["2x2"]
    assert run["restored_step"] == TCFG["steps"]
    assert run["resharded_loss"] == pytest.approx(run["restored_loss"], abs=1e-5)
    # The same checkpoint on one process: the full tensors, bitwise.
    cfg = get_config(W.ARCH).reduced()
    one = Trainer(cfg, device="cpu", tcfg=TrainerConfig(ckpt_dir=run["ckpt_dir"], **TCFG))
    one._restart()
    assert one.step == TCFG["steps"]
    for key, want in _flat(run["params_at_ckpt"]).items():
        assert torch.equal(_flat(one.params)[key].detach(), want), key


def test_collective_bytes_equal_dry_run(port):
    cfg = get_config(W.ARCH).reduced()
    shape = ShapeSpec("spmd", TCFG["seq_len"], TCFG["global_batch"], "train")
    for name in ("2x2", "2x2x2"):
        data, model, pod = MESHES[name]
        axes = ("pod", "data", "model") if pod else ("data", "model")
        sizes = (pod, data, model) if pod else (data, model)
        rec = D.run_cell(cfg, shape, mesh=RankMesh.abstract(axes, sizes), seq_shard=False,
                         write=False)
        assert rec["ok"], rec.get("error")
        got = port[name]["history"][0]["collective_bytes"]
        assert got == pytest.approx(rec["hlo_cost"]["by_collective"]), name
        assert rec["hlo_cost"]["gemm_calls"] == port[name]["history"][0]["gemm_calls"]


def test_context_parallel_heads_match_one_process(port):
    case = _cp_case()
    cfg = case["cfg"]
    params = O.tree_map(lambda p: p.requires_grad_(True), case["params"])
    loss, _, grads = O.value_and_grad(Z.make_loss_fn(cfg), params, case["batch"])
    logits = Z.make_prefill_fn(cfg)(case["serve"], {"tokens": case["batch"]["tokens"]})
    got_loss, got_grads, got_logits = port["1x4"]["cp"]
    assert got_loss == pytest.approx(float(loss), rel=1e-3)
    want = _flat(grads)
    for key, g in _flat(got_grads).items():
        rel = float((g - want[key]).norm() / want[key].norm().clamp(min=1e-12))
        assert rel <= 0.03, (key, rel)
    np.testing.assert_allclose(got_logits.float().numpy(), logits.float().numpy(), **BF16_TOL)
