"""The class-sharded step a rank a pod: ``torch.distributed`` ranks on the
CPU (``gloo``, spawned by ``launch.mesh.spawn_ranks``; the rank function
is ``tests/spmd_workers.pod_run``) against the pods as streams in one
process and against the reference's mixed step on the conftest's 8 host
devices, at reduced internlm2 from the reference's parameters.

Held:

  * the mixed gradient step at (pod=2, 1, 1) bitwise equal to the port's
    stream step at 2 pods (the epilogue's sums are ``a + b`` either way),
    for ``n_micro`` 1 and 2, and within ``test_torch_class_sharded.py``'s
    tolerances of the reference's (loss and metrics within 2e-3, each
    gradient leaf within 0.03 relative L2);
  * the engine, dense and paged, over more requests than slots with mixed
    lengths and an EOS: tokens bitwise equal to the stream engine's and
    identical on both ranks; each rank holds half the stream engine's KV
    bytes; the engine's ``generate`` equal to the one-shot path on ranks;
  * the DAS split identical on both ranks under different per-rank
    ``pod_time_hook``s (each rank's own pod's time, gathered), and the
    trainer's losses and params bitwise the stream trainer's;
  * ``compressed_crosspod_mean`` on ranks equal to the reference's under
    its ``shard_map`` (means and residuals within 1e-6) and bitwise to the
    stream form on per-pod trees;
  * both CLIs under a world of 2 print one summary with ``class_sharded``;
  * at (pod=2, data=2, 1), world 4, a pod's two ranks give equal results
    (the reference's replication), equal to the world-2 step's;
  * the route rule (``launch.mesh.pod_route``, ``resolve_pods``, the
    trainer's ``auto``) over world, cards and backend, without ranks.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import collectives as JC
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.models import model_zoo as JZ
from repro.runtime.trainer import build_class_sharded_grad_step as jax_grad_step

import spmd_workers as W
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as M
from repro_torch.launch.mesh import RankMesh, choose_backend, make_host_mesh, spawn_ranks
from repro_torch.models import model_zoo as Z
from repro_torch.optim import adamw as O
from repro_torch.runtime import trainer as TR
from repro_torch.runtime.serving import ServingEngine

from test_torch_class_sharded import GRAD_RTOL, LOSS_ATOL, NO_EXCESS, _grad_fixture
from test_torch_train import _flat

torch.set_num_threads(1)

ARCH = "internlm2-1.8b"
PROMPTS, GEN, SEQ_CAP = 6, 4, 12
POD_TIMES = ([1.0, 3.0], [5.0, 3.0])  # each rank's hook; gathered: [1.0, 3.0]


def _stream_pods():
    return make_host_mesh(pod=2, device="cpu")


def _requests(vocab):
    rng = np.random.default_rng(3)
    return [(rng.integers(0, vocab, int(rng.integers(2, 7)), dtype=np.int32), int(n))
            for n in rng.integers(1, 6, size=10)]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The world-2 ranks' results and what the test holds them to."""

    jcfg, jparams, jam, jbw, cfg, params, am, batch = _grad_fixture()
    params_np = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(1)
    g = {"a": rng.normal(size=(8, 5)).astype(np.float32),
         "b": {"c": rng.normal(size=(7,)).astype(np.float32)}}
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (PROMPTS, 4), dtype=np.int32)
    plan = {"params": params_np, "batch": {k: v.numpy() for k, v in batch.items()},
            "n_micro": (1, 2), "serve": True, "reqs": _requests(cfg.vocab), "eos_id": 7,
            "prompts": prompts, "gen": GEN, "seq_cap": SEQ_CAP, "pod_times": POD_TIMES,
            "ckpt_dir": str(tmp_path_factory.mktemp("pod_ranks") / "ckpt"),
            "crosspod": {"g": g, "e": jax.tree.map(lambda x: (x * 1e-3).astype(np.float32), g)}}
    ranks = spawn_ranks(W.pod_run, 2, plan, device="cpu", timeout=300)
    return {"ranks": ranks, "plan": plan, "jcfg": jcfg, "jparams": jparams, "jam": jam,
            "jbw": jbw, "cfg": cfg, "params": params, "am": am, "batch": batch}


def _equal_trees(a, b) -> bool:
    la, lb = O.tree_leaves(a), O.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("n_micro", [1, 2])
def test_grad_step_on_ranks_is_bitwise_the_stream_step(world2, n_micro):
    cfg, params, batch = world2["cfg"], world2["params"], world2["batch"]
    step = TR.build_class_sharded_grad_step(Z.make_loss_fn(cfg), W.grad_asym(), _stream_pods(),
                                            n_micro=n_micro)
    loss, metrics, grads = step(params, batch)
    for r in world2["ranks"]:
        got = r["grad"][n_micro]
        assert got["mixed"] and got["pod"] == r["pod"] == r["rank"]
        assert got["backends"] == ["cuda", "cuda_lean"]
        assert {c for c, _ in got["trace"]} == {("big", "little")[r["pod"]]}
        assert torch.equal(got["loss"], loss)
        assert set(got["metrics"]) == set(metrics)
        assert all(torch.equal(got["metrics"][k], metrics[k]) for k in metrics)
        assert _equal_trees(got["grads"], grads)
        # One pod's rows: the forward and backward's products of its program only.
        assert got["gemm_calls"] == n_micro * (4 * (7 * cfg.n_layers + 1) - 1)
        # What moves: the dry-run's count for the cell on the abstract mesh.
        assert got["bytes"] == _dry_train(cfg)["hlo_cost"]["by_collective"]


def _dry_train(cfg):
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun as D

    rec = D.run_cell(cfg, ShapeSpec("pod_ranks", 16, 8, "train"), little_spec="h100-little",
                     mesh=RankMesh.abstract(("pod", "data", "model"), (2, 1, 1)), write=False)
    assert rec["ok"], rec.get("error")
    return rec


@pytest.mark.parametrize("n_micro", [1, 2])
def test_grad_step_on_ranks_matches_reference(world2, n_micro):
    w = world2
    jstep = jax_grad_step(JZ.make_loss_fn(w["jcfg"]), w["jam"], jax_host_mesh(pod=2), n_micro=n_micro)
    jbatch = {k: jnp.asarray(v) for k, v in w["jbw"].arrays.items()}
    compiled = jax.jit(jstep).lower(w["jparams"], jbatch).compile(compiler_options=NO_EXCESS)
    jloss, jmetrics, jgrads = compiled(w["jparams"], jbatch)
    got = w["ranks"][0]["grad"][n_micro]
    assert abs(float(got["loss"]) - float(jloss)) <= LOSS_ATOL
    for key in jmetrics:
        assert abs(float(got["metrics"][key]) - float(jmetrics[key])) <= LOSS_ATOL, key
    jflat, flat = _flat(jax.tree.map(np.asarray, jgrads)), _flat(got["grads"])
    assert set(jflat) == set(flat)
    for key, jg in jflat.items():
        rel = np.linalg.norm(flat[key].float().numpy() - jg) / max(np.linalg.norm(jg), 1e-12)
        assert rel <= GRAD_RTOL, (key, rel)


@pytest.mark.parametrize("paged", ["off", "on"])
def test_engine_on_ranks_is_bitwise_the_stream_engine(world2, paged):
    cfg, plan = world2["cfg"], world2["plan"]
    serving = params_from_jax(plan["params"], cfg, device="cpu")
    eng = ServingEngine(cfg, serving, W.serve_asym(), seq_cap=SEQ_CAP, device="cpu",
                        class_sharded="on", pod_time_hook=None, slots_per_pod=3, paged=paged,
                        page_size=4, eos_id=plan["eos_id"])
    assert not eng.ranks
    want = W.serve_requests(eng, plan["reqs"])
    kv = eng.kv_stats()
    r0, r1 = (r["engine"][paged] for r in world2["ranks"])
    assert r0["tokens"] == r1["tokens"] == want
    for r, got in zip(world2["ranks"], (r0, r1)):
        assert got["kv"]["pod"] == r["pod"]
        key = "kv_bytes" if paged == "off" else "arena_kv_bytes"
        assert 2 * got["kv"]["pod_kv_bytes"] == kv[key] == got["kv"][key]
        assert got["health"]["pod"] == r["pod"] and got["health"]["completed"] == len(plan["reqs"])
        if paged == "off":
            assert got["state_rows"] and all(n == 3 for n in got["state_rows"])


def test_engine_generate_on_ranks_equals_the_one_shot_path(world2):
    cfg, plan = world2["cfg"], world2["plan"]
    serving = params_from_jax(plan["params"], cfg, device="cpu")
    eng = ServingEngine(cfg, serving, W.serve_asym(), seq_cap=SEQ_CAP, device="cpu",
                        class_sharded="on", pod_time_hook=None,
                        slots_per_pod=W.serve_asym().batch_layout(PROMPTS).c_max)
    want = eng.generate(plan["prompts"], GEN)
    for r in world2["ranks"]:
        assert np.array_equal(r["generate"], want)
        assert np.array_equal(r["one_shot"], want)


def test_das_split_and_trainer_on_ranks(world2, tmp_path):
    r0, r1 = (r["das"] for r in world2["ranks"])
    assert r0["rates"] == r1["rates"] and r0["sizes"] == r1["sizes"]
    assert torch.equal(r0["params"], r1["params"])
    # The one-process trainer with the gathered times: the same split, the
    # same losses and params, bitwise.
    cfg = world2["cfg"]
    params, _ = train_state_from_jax(world2["plan"]["params"], None, device="cpu")
    gathered = [POD_TIMES[0][0], POD_TIMES[1][1]]
    tr = TR.Trainer(cfg, tcfg=TR.TrainerConfig(steps=2, global_batch=8, seq_len=16, ckpt_every=100,
                                               ckpt_dir=str(tmp_path), class_sharded=True),
                    asym=W.serve_asym(), device="cpu", mesh=_stream_pods(), params=params,
                    pod_time_hook=lambda step: gathered,
                    opt_cfg=O.AdamWConfig(lr=1e-3, total_steps=2, warmup_steps=1))
    hist = tr.run()
    assert [float(r) for r in tr.asym.scheduler.rates] == r0["rates"]
    assert tr.asym.batch_layout(8).sizes == r0["sizes"] != W.serve_asym().batch_layout(8).sizes
    assert [h["loss"] for h in hist] == r0["losses"]
    assert torch.equal(O.tree_leaves(tr.params)[0], r0["params"])


def test_compressed_crosspod_mean_on_ranks(world2):
    plan = world2["plan"]["crosspod"]
    jmean, jerr = JC.compressed_crosspod_mean(jax.tree.map(jnp.asarray, plan["g"]),
                                              jax.tree.map(jnp.asarray, plan["e"]),
                                              jax_host_mesh(pod=2))
    for r in world2["ranks"]:
        mean, err = r["crosspod_same"]
        for key, jm in _flat(jax.tree.map(np.asarray, jmean)).items():
            np.testing.assert_allclose(_flat(mean)[key].numpy(), jm, rtol=1e-6, atol=1e-6)
        for key, je in _flat(jax.tree.map(np.asarray, jerr)).items():
            np.testing.assert_allclose(_flat(err)[key].numpy(), je, rtol=1e-6, atol=1e-6)
    # Per-pod trees: bitwise the stream form's mean and residuals.
    from repro_torch.distributed import collectives as C

    g = O.tree_map(torch.from_numpy, plan["g"])
    trees = [O.tree_map(lambda t, p=p: t * (1 - 3 * p), g) for p in (0, 1)]
    mean, errs = C.compressed_crosspod_mean(trees, [C.init_error_feedback(t) for t in trees],
                                            _stream_pods())
    for r in world2["ranks"]:
        got_mean, got_err = r["crosspod_own"]
        assert _equal_trees(got_mean, mean) and _equal_trees(got_err, errs[r["pod"]])


def test_clis_on_ranks(world2):
    r0, r1 = world2["ranks"]
    for r in (r0, r1):
        s = r["serve_cli"]
        assert s["class_sharded"] is True and s["device_class"] == "mixed" and s["pod_ranks"] == 2
        assert [c[1] for c in s["shard_classes"]] == ["big", "little"]
        t = r["train_cli"]
        assert t["class_sharded"] is True and [c[1] for c in t["shard_classes"]] == ["big", "little"]
        assert t["steps"] == 2 and np.isfinite(t["last_loss"])
    assert r0["serve_cli"]["sample"] == r1["serve_cli"]["sample"]
    assert r0["train_cli"]["last_loss"] == r1["train_cli"]["last_loss"]


def test_wide_pods_replicate_their_program(world2):
    """(pod=2, data=2, model=1), world 4: each pod's program replicated over
    its two ranks, the epilogue reducing over ``pod`` only."""

    plan = dict(world2["plan"], n_micro=(1,), serve=False, data=2)
    ranks = spawn_ranks(W.pod_run, 4, plan, device="cpu", timeout=300)
    want = world2["ranks"][0]["grad"][1]
    for r in ranks:
        assert r["shape"] == {"pod": 2, "data": 2, "model": 1}
        assert r["pod"] == r["rank"] // 2
        got = r["grad"][1]
        assert torch.equal(got["loss"], want["loss"]) and _equal_trees(got["grads"], want["grads"])


# ---------------------------------------------------------------------------
# The route rule, without ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode, world, cards, want", [
    ("on", 1, 0, "streams"),        # one process: the pods as streams
    ("on", 2, 1, "ranks"),          # a rank a pod, sharing the card over gloo
    ("on", 2, 2, "ranks"),          # a rank a pod, a card each over nccl
    ("auto", 1, 4, None),           # one process: auto stays off
    ("auto", 2, 1, None),           # two ranks on one card: off
    ("auto", 2, 2, "ranks"),        # the reference's device_count() >= n_pods
    ("auto", 4, 4, None),           # a world that is not a rank a pod
    ("off", 2, 2, None),
])
def test_pod_route_over_world_cards_and_backend(monkeypatch, mode, world, cards, want):
    for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    backend = choose_backend(0, world, device="cuda")[0] if world > 1 else None
    assert M.pod_route(mode, 2, 2, world, backend) == want
    # The CPU's ranks are gloo: auto never takes them there.
    cpu = choose_backend(0, world, device="cpu")[0] if world > 1 else None
    assert M.pod_route("auto", 2, 2, world, cpu) is None


def test_pod_route_refuses_what_on_cannot_run():
    with pytest.raises(ValueError, match="need a world of 2 ranks; the process group has 4"):
        M.pod_route("on", 2, 2, 4, "gloo")
    with pytest.raises(ValueError, match="more than one device class"):
        M.pod_route("on", 1, 2, 2, "nccl")
    assert M.pod_route("auto", 1, 2, 2, "nccl") is None
    with pytest.raises(ValueError, match="class_sharded='sometimes'"):
        M.pod_route("sometimes", 2, 2, 1, None)


def test_resolve_pods_reads_a_launchers_world(monkeypatch):
    """A launcher's world of 4 under ``on`` raises before any rank is made;
    under ``auto`` with one card it is the single program; one process
    gives streams."""

    asym = W.serve_asym()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for k, v in {"WORLD_SIZE": "4", "RANK": "1", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "4"}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="the process group has 4"):
        M.resolve_pods("on", asym, "cuda")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert M.resolve_pods("auto", asym, "cuda") is None
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert isinstance(M.resolve_pods("on", asym, "cpu"), M.PodMesh)


@pytest.mark.parametrize("transport, sizes, flag, want", [
    ("nccl", (2, 1, 1), None, True),     # a rank a pod, a card each
    ("gloo", (2, 1, 1), None, False),    # ranks sharing a card: auto is off
    ("gloo", (2, 1, 1), True, True),     # on: taken
    ("nccl", (2, 2, 1), None, False),    # pods wider than a rank: only when asked
    ("gloo", (2, 2, 1), True, True),     # ... and then replicated
])
def test_trainer_auto_rule_on_rank_meshes(transport, sizes, flag, want):
    mesh = RankMesh(("pod", "data", "model"), sizes, 0, torch.device("cpu"), transport)
    t = types.SimpleNamespace(tcfg=TR.TrainerConfig(class_sharded=flag), asym=W.serve_asym(),
                              mesh=mesh)
    assert TR.Trainer.class_sharded_enabled(t) is want


def test_pod_view_and_manual_constrain():
    x = {"t": torch.arange(12).reshape(4, 3), "w": torch.ones(2)}
    spec = {"t": SH.PodSplit(0), "w": None}
    v = SH.pod_view(x, spec, 2, 1)
    assert torch.equal(v["t"], x["t"][2:]) and v["t"].data_ptr() == x["t"][2:].data_ptr()
    assert v["w"] is x["w"]
    assert SH.split_pods(x, spec, 2)[1]["t"].data_ptr() == v["t"].data_ptr()
    mesh = RankMesh.abstract(("pod", "data", "model"), (2, 2, 1))
    assert SH.constrain(mesh, (8, 4), (("pod", "data"), None)) == SH.P(("pod", "data"), None)
    assert SH.constrain(mesh, (8, 4), (("pod", "data"), None), manual=("pod",)) == \
        SH.P(("data",), None)
