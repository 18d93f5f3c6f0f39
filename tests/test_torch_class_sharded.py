"""Port vs reference: the class-sharded mixed step — ``execution.class_sharded``
and ``AsymmetricMesh.class_sharded``, the pod specs, the collectives and the
trainer's mixed gradient step — on the CPU at reduced sizes.

The reference runs on the 8 forced host devices of ``tests/conftest.py``
(its ``shard_map`` over a 2-pod mesh); the port's pods run in turn on the
CPU, where they have no streams.  Tolerances:

  * Within the port, bitwise: each pod's rows equal the same rows run
    alone under that pod's class context, and the single-class fallback
    equals the single-context call.
  * The GEMM step against the reference's on the same fp32 inputs: both
    accumulate in fp32 in other orders, rtol = atol = 1e-4 (the fp32
    tolerance of ``tests/test_backend_parity.py``).
  * The reduced internlm2 decode step's logits: rtol = atol = 2e-2, the
    bf16 drift between the packages (``test_torch_model.py``).
  * The mixed gradient step against the reference's (compiled with
    ``xla_allow_excess_precision`` off, as ``test_torch_train_families.py``
    does): the loss within 2e-3, each gradient leaf within 0.03 relative
    L2 — that file's tolerances.
  * The mixed gradients against the manual per-pod split: rtol 1e-6,
    atol 1e-7, not bitwise (the reference's own test of it is not bitwise
    either): the split weighs each pod with a Python float, the epilogue
    with an fp32 tensor.
  * The collectives: the int8 codes and scales bitwise (the same fp32
    division and round-half-even), the means within 1e-6.
"""

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_config
from repro.core import blocking as JB
from repro.core.asymmetric import AsymmetricMesh as JMesh
from repro.core.asymmetric import DeviceClass as JDeviceClass
from repro.core.asymmetric import biglittle_classes as jax_classes
from repro.data.pipeline import AsymmetricBatcher as JBatcher
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.distributed import collectives as JC
from repro.distributed import sharding as JSH
from repro.kernels.ops import gemm as jgemm
from repro.launch import serve as jax_serve
from repro.launch import train as jax_train
from repro.launch.mesh import make_host_mesh as jax_host_mesh
from repro.models import model_zoo as JZ
from repro.runtime.trainer import build_class_sharded_grad_step as jax_grad_step

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.core import blocking as B
from repro_torch.core import execution as X
from repro_torch.core.asymmetric import AsymmetricMesh, DeviceClass, biglittle_classes
from repro_torch.data.pipeline import AsymmetricBatcher, SyntheticLM
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import gemm as G
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import choose_backend, make_host_mesh, make_production_mesh, rank_device
from repro_torch.models import model_zoo as Z
from repro_torch.optim import adamw as O
from repro_torch.runtime import trainer as TR
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from repro_torch.tuning import cache as TC

from test_torch_train import _flat

torch.set_num_threads(1)

ARCH = "internlm2-1.8b"
FP32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
LOSS_ATOL, GRAD_RTOL = 2e-3, 0.03
NO_EXCESS = {"xla_allow_excess_precision": False}


def _pods(n=2):
    return make_host_mesh(pod=n, device="cpu")


def _rand(rng, shape, dtype=torch.bfloat16):
    return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32).to(dtype)


def _gemm_step(am, mesh):
    return am.class_sharded(lambda x, w: ops.gemm(x, w), mesh=mesh,
                            in_specs=(SH.PodSplit(0), None), out_specs=SH.PodSplit(0))


# ---------------------------------------------------------------------------
# Per-shard routing: each pod runs its own class's program
# ---------------------------------------------------------------------------


def test_each_shard_runs_its_own_tuned_config(tmp_path, monkeypatch):
    """Distinct tuned entries per class: pod 0 computes with big's block
    config and pod 1 with little's — by provenance, and bitwise against
    the plain version called with that class's config."""

    m = k = n = 128
    big_cfg = B.BlockConfig(bm=128, bk=128, bn=64)
    little_cfg = B.BlockConfig(bm=64, bk=128, bn=128)
    cache = TC.TuningCache(path=str(tmp_path / "cache.json"))
    for spec, cfg in ((B.H100, big_cfg), (B.H100_LITTLE, little_cfg)):
        cache.put(spec.name, "bfloat16", m, k, n, cfg)
    cache.save()
    monkeypatch.setenv(TC.ENV_VAR, cache.path)

    am = AsymmetricMesh(biglittle_classes(chips_per_pod=1), tree_shape=(m, k, n),
                        backend="torch_ref")  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    step = _gemm_step(am, _pods())
    assert step.mixed
    assert [(p.pod, p.device_class, p.block_source) for p in step.provenance] \
        == [(0, "big", "tuned"), (1, "little", "tuned")]
    for prov, cfg in zip(step.provenance, (big_cfg, little_cfg)):
        assert (prov.block.bm, prov.block.bk, prov.block.bn) == (cfg.bm, cfg.bk, cfg.bn)

    rng = np.random.default_rng(7)
    x, w = _rand(rng, (2 * m, k)), _rand(rng, (k, n))  # pod-major: big [:m], little [m:]
    out = step(x, w)
    assert torch.equal(out[:m], G.gemm_plain(x[:m], w, big_cfg))
    assert torch.equal(out[m:], G.gemm_plain(x[m:], w, little_cfg))
    assert big_cfg != little_cfg
    assert set(step.trace_log) == {("big", "tuned"), ("little", "tuned")}
    step(x, w)  # the same signature again: nothing new is logged
    assert len(step.trace_log) == 2


def test_mixed_step_runs_two_kernel_variants(monkeypatch):
    """One step, two micro-kernels: at 1024³ the little class's tree takes
    the lean kernel, so the big pod's rows go through ``gemm_cuda`` and
    the little pod's through ``gemm_cuda_lean`` (their plain versions on
    the CPU), each bitwise equal to its rows run alone under its class."""

    am = AsymmetricMesh(biglittle_classes(chips_per_pod=1), tree_shape=(1024, 1024, 1024),
                        backend="cuda")  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    assert am.class_backends() == {"big": "cuda", "little": "cuda_lean"}
    step = _gemm_step(am, _pods())
    assert [(p.pod, p.device_class, p.backend) for p in step.provenance] \
        == [(0, "big", "cuda"), (1, "little", "cuda_lean")]
    calls = []
    for name in ("cuda", "cuda_lean"):
        real = X.BACKENDS[name]
        monkeypatch.setitem(X.BACKENDS, name,
                            lambda *a, _n=name, _f=real: calls.append(_n) or _f(*a))
    rng = np.random.default_rng(8)
    x, w = _rand(rng, (2 * 96, 160)), _rand(rng, (160, 72))
    out = step(x, w)
    assert calls == ["cuda", "cuda_lean"]
    for pod, cls in enumerate(("big", "little")):
        with am.execution_context(cls):
            alone = ops.gemm(x[pod * 96:(pod + 1) * 96], w)
        assert torch.equal(out[pod * 96:(pod + 1) * 96], alone), cls


def test_gemm_step_matches_reference():
    """The same fp32 inputs through the reference's mixed GEMM step (the
    interpret-mode kernels) and the port's (the plain versions)."""

    rng = np.random.default_rng(9)
    x = rng.normal(size=(256, 128)).astype(np.float32)
    w = rng.normal(size=(128, 128)).astype(np.float32)
    jam = JMesh(jax_classes(chips_per_pod=1), tree_shape=(128, 128, 128),
                backend="pallas_interpret")  # repro_torch: noqa=RPR005 -- the reference's backend name (repro.core.execution.BACKENDS)
    jstep = jam.class_sharded(lambda a, b: jgemm(a, b), mesh=jax_host_mesh(pod=2),
                              in_specs=(P("pod"), P()), out_specs=P("pod"))
    want = np.asarray(jax.jit(jstep)(jnp.asarray(x), jnp.asarray(w)))
    am = AsymmetricMesh(biglittle_classes(chips_per_pod=1), tree_shape=(128, 128, 128),
                        backend="torch_ref")  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    step = _gemm_step(am, _pods())
    got = step(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, **FP32_TOL)
    assert [(p.pod, p.device_class) for p in step.provenance] \
        == [(p.pod, p.device_class) for p in jstep.provenance]


# ---------------------------------------------------------------------------
# Fallbacks and validation
# ---------------------------------------------------------------------------


def test_fallback_is_bitwise_the_single_context_call():
    am = AsymmetricMesh([DeviceClass("only", chips_per_pod=1, n_pods=2)],
                        tree_shape=(128, 128, 128),
                        backend="matmul")  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    step = _gemm_step(am, _pods())
    assert not step.mixed
    rng = np.random.default_rng(10)
    x, w = _rand(rng, (256, 128)), _rand(rng, (128, 128))
    with am.execution_context():
        want = ops.gemm(x, w)
    assert torch.equal(step(x, w), want)
    assert step.trace_log == [("only", "analytical")]


@pytest.mark.parametrize("mesh", [make_host_mesh(device="cpu"), make_host_mesh(pod=1, device="cpu")],
                         ids=["no-pod-axis", "one-pod"])
def test_a_mesh_without_pods_falls_back(mesh):
    am = AsymmetricMesh(biglittle_classes(chips_per_pod=1))
    step = _gemm_step(am, mesh)
    assert not step.mixed
    assert [p.device_class for p in step.provenance] == ["big", "big"]


def test_validation():
    ctxs = [X.default_context()]
    with pytest.raises(ValueError, match="out of range"):
        X.class_sharded(lambda x: x, mesh=_pods(), contexts=ctxs, pod_class=[0, 1],
                        in_specs=(SH.PodSplit(0),), out_specs=SH.PodSplit(0))
    two = [X.default_context(device_class="a"), X.default_context(device_class="b")]
    with pytest.raises(ValueError, match="size"):
        X.class_sharded(lambda x: x, mesh=_pods(), contexts=two, pod_class=[0, 1, 1],
                        in_specs=(SH.PodSplit(0),), out_specs=SH.PodSplit(0))
    with pytest.raises(ValueError, match="no 'pod' axis|has no"):
        X.class_sharded(lambda x: x, mesh=make_host_mesh(device="cpu"), contexts=two,
                        pod_class=[0, 1], in_specs=(SH.PodSplit(0),), out_specs=SH.PodSplit(0))
    with pytest.raises(ValueError, match="at least one"):
        X.class_sharded(lambda x: x, mesh=_pods(), contexts=[], pod_class=[0],
                        in_specs=(SH.PodSplit(0),), out_specs=SH.PodSplit(0))


def test_meshes():
    mesh = _pods(2)
    assert mesh.shape == {"pod": 2, "data": 1, "model": 1} and mesh.n_pods == 2
    assert mesh.pod_streams() == [None, None]  # the CPU: the pods run in turn
    assert make_host_mesh(device="cpu").axis_names == ("data", "model")
    # A data or model axis above 1 is a mesh of ranks: it needs the process
    # group whose ranks it spans (tests/test_torch_spmd.py spawns them).
    with pytest.raises(ValueError, match="initialised process group"):
        make_host_mesh(data=2, device="cpu")
    # The production meshes, the reference's axes and sizes; abstract (rank
    # 0, no groups, on the meta device) outside a launcher's world.
    for multi, ref in ((False, jax.sharding.AbstractMesh((16, 16), ("data", "model"))),
                       (True, jax.sharding.AbstractMesh((2, 16, 16), ("pod", "data", "model")))):
        mesh = make_production_mesh(multi_pod=multi)
        assert mesh.axis_names == tuple(ref.axis_names)
        assert mesh.shape == dict(ref.shape)
        assert mesh.is_abstract and mesh.rank == 0 and mesh.device.type == "meta"
        assert mesh.world == (512 if multi else 256)


@pytest.mark.parametrize("env, world, cards, launcher, want", [
    # 256 ranks over 32 nodes of 8 cards under a launcher: a card each.
    ({"LOCAL_RANK": "5", "LOCAL_WORLD_SIZE": "8"}, 256, 8, True, ("nccl", 5)),
    # 16 ranks a node on 8 cards: two share a card.
    ({"LOCAL_RANK": "13", "LOCAL_WORLD_SIZE": "16"}, 256, 8, True, ("gloo", 13)),
    # Spawned on one node (a FileStore): every rank is on this node.
    ({}, 4, 1, False, ("gloo", 3)),
    ({}, 4, 4, False, ("nccl", 3)),
    # A parent's launcher variables do not describe ranks spawned here.
    ({"LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "1"}, 4, 1, False, ("gloo", 3)),
])
def test_backend_is_chosen_per_node(monkeypatch, env, world, cards, launcher, want):
    for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    backend, local_rank, why = choose_backend(3, world, device="cuda", launcher=launcher)
    assert (backend, local_rank) == want and why
    assert choose_backend(3, world, device="cpu", launcher=launcher)[0] == "gloo"
    assert rank_device(local_rank, "cuda") == torch.device("cuda", local_rank % cards)


# ---------------------------------------------------------------------------
# The pod specs: where the reference puts P("pod"), the port splits
# ---------------------------------------------------------------------------


def test_pod_specs_place_the_split_where_the_reference_does():
    am = AsymmetricMesh(biglittle_classes(chips_per_pod=1))
    jam = JMesh(jax_classes(chips_per_pod=1))
    idx, spec = SH.pod_class_specs(am)
    jidx, jspec = JSH.pod_class_specs(jam)
    assert list(idx) == list(jidx) == [0, 1] and spec == SH.PodSplit(0) and jspec == P("pod")
    assert SH.pod_batch_specs({"tokens": 0, "mask": 0}) == \
        {"tokens": SH.PodSplit(0), "mask": SH.PodSplit(0)}
    state = {"k": np.zeros((2, 4, 3)), "m": {"ssm": np.zeros((2, 4, 3, 5))}}
    jspecs = JSH.pod_state_specs(jax.tree.map(jnp.asarray, state))
    specs = SH.pod_state_specs(state)
    for key, jsp, sp in (("k", jspecs["k"], specs["k"]), ("ssm", jspecs["m"]["ssm"], specs["m"]["ssm"])):
        assert tuple(jsp).index("pod") == sp.dim, key
    (jin, jout), (pin, pout) = JSH.pod_decode_specs({"k": jnp.zeros((2, 4))}, batch_keys=("tokens", "live")), \
        SH.pod_decode_specs({"k": np.zeros((2, 4))}, batch_keys=("tokens", "live"))
    assert jin[0] == P() and pin[0] is None
    assert set(jin[1]) == set(pin[1]) and jin[3] == P("pod") and pin[3] == SH.PodSplit(0)
    assert jout[0] == P("pod") and pout[0] == SH.PodSplit(0)


def test_split_makes_views_and_stitch_keeps_in_place_state():
    state = {"k": torch.arange(24.0).reshape(2, 4, 3)}
    batch = {"tokens": torch.arange(4).reshape(4, 1)}
    views: dict = {}
    shards = SH.split_pods((batch, state), (SH.PodSplit(0), SH.pod_state_specs(state)), 2, views)
    assert [s[1]["k"].shape for s in shards] == [(2, 2, 3), (2, 2, 3)]
    assert shards[1][1]["k"].data_ptr() == state["k"].data_ptr() + 2 * 3 * 4  # a view, no copy
    assert torch.equal(shards[1][0]["tokens"], batch["tokens"][2:])
    for i, (_, st) in enumerate(shards):
        st["k"].add_(100 * (i + 1))  # each pod writes its lanes in place
    joined = SH.stitch_pods([st for _, st in shards], SH.pod_state_specs(state), views)
    assert joined["k"] is state["k"]  # no whole-state copy
    assert float(state["k"][0, 0, 0]) == 100 and float(state["k"][0, 2, 0]) == 206
    new = SH.stitch_pods([torch.ones(2, 1), torch.zeros(2, 1)], SH.PodSplit(0))
    assert new.tolist() == [[1.0], [1.0], [0.0], [0.0]]
    with pytest.raises(ValueError, match="does not split"):
        SH.split_pods(torch.zeros(3, 2), SH.PodSplit(0), 2)


# ---------------------------------------------------------------------------
# The decode step against the reference's
# ---------------------------------------------------------------------------


def test_mixed_decode_step_matches_reference():
    """The reduced internlm2's prompts, laid out pod-major, through both
    packages' mixed decode step (bulk prefill through it): the last
    position's logits."""

    jcfg, cfg = jax_config(ARCH).reduced(), get_config(ARCH).reduced()
    jparams = JZ.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    am = AsymmetricMesh(biglittle_classes(chips_per_pod=1), batch_tile=1,
                        backend="cuda")  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    jam = JMesh(jax_classes(chips_per_pod=1), batch_tile=1)
    layout, jlayout = am.batch_layout(6), jam.batch_layout(6)
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (6, 5), dtype=np.int32)
    padded, order = serve.pad_requests(prompts, layout)
    jpadded, jorder = jax_serve.pad_requests(prompts, jlayout)
    assert np.array_equal(padded[order], jpadded[jorder])
    seq = 8

    jstep = jax_serve.mixed_decode_step(jcfg, jam, jax_host_mesh(pod=2), jpadded.shape[0], seq)
    jlogits, _ = jax.jit(JZ.bulk_prefill_from_decode(jstep))(
        jparams, {"tokens": jnp.asarray(jpadded)}, JZ.init_decode_state(jcfg, jpadded.shape[0], seq),
        jnp.int32(0))
    step = serve.mixed_decode_step(cfg, am, _pods(), padded.shape[0], seq)
    assert step.mixed and [p.backend for p in step.provenance] == ["cuda", "cuda_lean"]
    with torch.no_grad():
        logits, _ = Z.bulk_prefill_from_decode(step)(
            params, {"tokens": torch.from_numpy(padded)},
            Z.init_decode_state(cfg, padded.shape[0], seq, device="cpu"), 0)
    got = logits[torch.from_numpy(order)].float().numpy()
    want = np.asarray(jlogits[jnp.asarray(jorder)].astype(jnp.float32))
    np.testing.assert_allclose(got, want, **BF16_TOL)
    assert {c for c, _ in step.trace_log} == {"big", "little"}


# ---------------------------------------------------------------------------
# The trainer's mixed gradient step
# ---------------------------------------------------------------------------


def _grad_fixture(seed=0):
    """Two classes at a 2:1 ratio, ``sas`` over tiles of 2: 6 rows of 16
    tokens lay out as 4 + 2 valid rows in pods of 4, the little pod half
    padding (its second micro-batch at ``n_micro=2`` all padding)."""

    jcfg, cfg = jax_config(ARCH).reduced(), get_config(ARCH).reduced()
    jparams = JZ.init_params(jax.random.PRNGKey(seed), jcfg)
    params, _ = train_state_from_jax(jax.tree.map(np.asarray, jparams), None, device="cpu")
    jam = JMesh([JDeviceClass("big", chips_per_pod=1),
                 JDeviceClass("little", chips_per_pod=1, rel_throughput=0.5, spec=JB.TPU_LITTLE)],
                strategy="sas", batch_tile=2)
    am = AsymmetricMesh([DeviceClass("big", spec=B.hopper_spec()),
                         DeviceClass("little", rel_throughput=0.5, spec=B.hopper_spec(little=True))],
                        strategy="sas", batch_tile=2,
                        backend="cuda")  # repro: noqa=RPR005 -- the port's backend name (repro_torch.core.execution.BACKENDS)
    jbw = JBatcher(JSyntheticLM(vocab=jcfg.vocab, seed=0), jam).batch(0, 6, 16)
    bw = AsymmetricBatcher(SyntheticLM(vocab=cfg.vocab, seed=0), am).batch(0, 6, 16)
    assert bw.layout.sizes == jbw.layout.sizes == [4, 2] and bw.layout.c_max == 4
    for key in bw.arrays:
        assert np.array_equal(bw.arrays[key], jbw.arrays[key]), key
    batch = {k: torch.from_numpy(v) for k, v in bw.arrays.items()}
    return jcfg, jparams, jam, jbw, cfg, params, am, batch


@pytest.mark.parametrize("n_micro", [1, 2])
def test_grad_step_matches_reference(n_micro):
    jcfg, jparams, jam, jbw, cfg, params, am, batch = _grad_fixture()
    jstep = jax_grad_step(JZ.make_loss_fn(jcfg), jam, jax_host_mesh(pod=2), n_micro=n_micro)
    jbatch = {k: jnp.asarray(v) for k, v in jbw.arrays.items()}
    compiled = jax.jit(jstep).lower(jparams, jbatch).compile(compiler_options=NO_EXCESS)
    jloss, jmetrics, jgrads = compiled(jparams, jbatch)
    step = TR.build_class_sharded_grad_step(Z.make_loss_fn(cfg), am, _pods(), n_micro=n_micro)
    assert step.mixed and [p.backend for p in step.provenance] == ["cuda", "cuda_lean"]
    loss, metrics, grads = step(params, batch)
    assert abs(float(loss) - float(jloss)) <= LOSS_ATOL
    assert set(metrics) == set(jmetrics)
    for key in metrics:
        assert abs(float(metrics[key]) - float(jmetrics[key])) <= LOSS_ATOL, key
    jflat, flat = _flat(jax.tree.map(np.asarray, jgrads)), _flat(grads)
    assert set(jflat) == set(flat)
    for key, jg in jflat.items():
        g = flat[key].float().numpy()
        rel = np.linalg.norm(g - jg) / max(np.linalg.norm(jg), 1e-12)
        assert rel <= GRAD_RTOL, (key, rel)


def test_mixed_grads_equal_the_manual_per_pod_split():
    """Each pod's rows alone under its own class, weighted by their valid
    tokens: the mixed step's loss and gradients (within rtol 1e-6)."""

    *_, cfg, params, am, batch = _grad_fixture()
    loss_fn = Z.make_loss_fn(cfg)
    c = 4
    outs = []
    for pod, cls in enumerate(("big", "little")):
        sub = {k: v[pod * c:(pod + 1) * c] for k, v in batch.items()}
        with am.execution_context(cls):
            loss, _, g = O.value_and_grad(loss_fn, params, sub)
        outs.append((float(sub["mask"].sum()), loss, g))
    total = sum(w for w, _, _ in outs)
    manual = O.tree_map(lambda *gs: sum(w / total * g for (w, _, _), g in zip(outs, gs)),
                        *[g for *_, g in outs])
    step = TR.build_class_sharded_grad_step(loss_fn, am, _pods())
    loss, _, grads = step(params, batch)
    assert float(loss) == pytest.approx(sum(w / total * float(l) for w, l, _ in outs), rel=1e-6)
    for a, b in zip(O.tree_leaves(grads), O.tree_leaves(manual)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


def test_mixed_loss_matches_the_global_masked_mean():
    *_, cfg, params, am, batch = _grad_fixture()
    loss_fn = Z.make_loss_fn(cfg)
    with am.execution_context():
        l_plain, _, _ = O.value_and_grad(loss_fn, params, batch)
    for n_micro in (1, 2):
        step = TR.build_class_sharded_grad_step(loss_fn, am, _pods(), n_micro=n_micro)
        l_mix, _, _ = step(params, batch)
        assert float(l_mix) == pytest.approx(float(l_plain), rel=1e-5), n_micro


def _trainer(tmp_path, asym, mesh=None, flag=None, steps=3):
    return Trainer(get_config(ARCH).reduced(), device="cpu", mesh=mesh, asym=asym,
                   tcfg=TrainerConfig(steps=steps, global_batch=8, seq_len=32, ckpt_dir=str(tmp_path),
                                      ckpt_every=steps, class_sharded=flag),
                   opt_cfg=O.AdamWConfig(lr=1e-3, total_steps=steps, warmup_steps=1))


def _two_classes(**kw):
    return AsymmetricMesh([DeviceClass("fast", chips_per_pod=1),
                           DeviceClass("slow", chips_per_pod=1, rel_throughput=0.5)], **kw)


def test_trainer_auto_gate_and_force(tmp_path):
    assert _trainer(tmp_path, _two_classes(), _pods()).class_sharded_enabled()  # auto, pods
    t = _trainer(tmp_path, _two_classes())  # no pod axis: auto stays off
    assert not t.class_sharded_enabled() and t.class_sharded_step is None
    with pytest.raises(ValueError, match="class_sharded=True"):
        _trainer(tmp_path, _two_classes(), flag=True)
    with pytest.raises(ValueError, match="class_sharded=True"):
        _trainer(tmp_path, AsymmetricMesh([DeviceClass("only", n_pods=2)]), _pods(), flag=True)
    assert not _trainer(tmp_path, _two_classes(), _pods(), flag=False).class_sharded_enabled()
    assert not _trainer(tmp_path, None, _pods(), flag=True).class_sharded_enabled()


def test_trainer_runs_and_exposes_provenance(tmp_path):
    t = _trainer(tmp_path, _two_classes(strategy="ca-das", batch_tile=1), _pods())
    assert [(p.pod, p.device_class) for p in t.class_sharded_step.provenance] \
        == [(0, "fast"), (1, "slow")]
    hist = t.run()
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    assert {c for c, _ in t.class_sharded_step.trace_log} == {"fast", "slow"}


def test_reshard_to_a_mesh_without_pods_gives_the_single_class_step(tmp_path):
    mixed = _trainer(tmp_path / "a", _two_classes(), _pods())
    single = _trainer(tmp_path / "b", _two_classes())
    batch, _ = mixed.next_batch(0)
    mixed.reshard(make_host_mesh(device="cpu"))
    assert mixed.class_sharded_step is None and not mixed.class_sharded_enabled()
    got, want = mixed.train_step(batch), single.train_step(batch)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert all(torch.equal(a, b) for a, b in zip(O.tree_leaves(mixed.params),
                                                 O.tree_leaves(single.params)))
    mixed.reshard(_pods())
    assert mixed.class_sharded_step is not None and mixed.class_sharded_step.mixed


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def _reference_train_summary(monkeypatch, capsys, tmp_path, *extra):
    argv = ["train", "--arch", ARCH, "--reduced", "--steps", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path / "j"), *extra]
    monkeypatch.setattr("sys.argv", argv)
    jax_train.main()
    return json.loads(capsys.readouterr().out)


def test_train_cli_class_sharded_on(monkeypatch, capsys, tmp_path):
    extra = ("--heterogeneous", "--class-sharded", "on")
    want = _reference_train_summary(monkeypatch, capsys, tmp_path, *extra)
    got = train_cli.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--steps", "2",
                          "--seq", "16", "--ckpt-dir", str(tmp_path / "p"), *extra])
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(got))
    assert set(got) == set(want)
    assert got["class_sharded"] is want["class_sharded"] is True
    assert [list(s[:3]) for s in got["shard_classes"]] == [s[:3] for s in want["shard_classes"]]
    assert [s[1] for s in got["shard_classes"]] == ["big", "little"]
    assert got["steps"] == 2 and got["chunk_sizes"] == want["chunk_sizes"]
    with pytest.raises(ValueError, match="--mesh 16x16 needs 256 ranks"):
        train_cli.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--mesh", "16x16"])


def _defaults(parser) -> dict:
    return {a.dest: a.default for a in parser._actions if a.dest != "help"}


def _reference_parser(module, monkeypatch) -> argparse.ArgumentParser:
    """The parser the reference's ``main`` builds, caught at ``parse_args``."""

    seen = {}

    def catch(self, *args, **kwargs):
        seen["parser"] = self
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(SystemExit):
        module.main()
    monkeypatch.undo()
    return seen["parser"]


@pytest.mark.parametrize("name", ["train", "serve"])
def test_cli_defaults_match_the_reference(name, monkeypatch):
    """Every flag the two CLIs share has the same default, apart from the
    checkpoint directory's name (the port's lies under the temporary
    directory)."""

    ref = _defaults(_reference_parser({"train": jax_train, "serve": jax_serve}[name], monkeypatch))
    port = _defaults({"train": train_cli, "serve": serve}[name].build_parser())
    shared = (set(ref) & set(port)) - {"ckpt_dir"}
    assert {"seq", "class_sharded", "strategy"} & shared
    assert {k: port[k] for k in shared} == {k: ref[k] for k in shared}
    if name == "train":
        assert port["seq"] == 128 and {"mesh", "class_sharded"} <= shared


# ---------------------------------------------------------------------------
# The collectives
# ---------------------------------------------------------------------------


def test_int8_quantization_matches_reference():
    x = np.random.default_rng(0).normal(size=(4, 33)).astype(np.float32)
    q, s = C.quantize_int8(torch.from_numpy(x))
    jq, js = JC.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(C.dequantize_int8(q, s).numpy(),
                                  np.asarray(JC.dequantize_int8(jq, js)))


def test_compressed_crosspod_mean_matches_reference():
    """The reference's pods see one replicated tree; the port takes that
    tree once per pod: the same mean and residuals."""

    rng = np.random.default_rng(1)
    g = {"a": rng.normal(size=(8, 5)).astype(np.float32), "b": {"c": rng.normal(size=(7,)).astype(np.float32)}}
    e = jax.tree.map(lambda x: (x * 1e-3).astype(np.float32), g)
    jmean, jerr = JC.compressed_crosspod_mean(jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, e),
                                              jax_host_mesh(pod=2))
    tg = O.tree_map(torch.from_numpy, g)
    te = O.tree_map(torch.from_numpy, e)
    mean, errs = C.compressed_crosspod_mean([tg, tg], [te, te], _pods())
    for key, jm in _flat(jax.tree.map(np.asarray, jmean)).items():
        np.testing.assert_allclose(_flat(mean)[key].numpy(), jm, rtol=1e-6, atol=1e-6)
    for err in errs:
        for key, je in _flat(jax.tree.map(np.asarray, jerr)).items():
            np.testing.assert_allclose(_flat(err)[key].numpy(), je, rtol=1e-6, atol=1e-6)
    # Two pods with different gradients: the mean of their dequantized codes.
    g2 = O.tree_map(lambda t: -2 * t, tg)
    zero = C.init_error_feedback(tg)
    mean2, _ = C.compressed_crosspod_mean([tg, g2], [zero, zero], _pods())
    want = O.tree_map(lambda a, b: (C.dequantize_int8(*C.quantize_int8(a))
                                    + C.dequantize_int8(*C.quantize_int8(b))) / 2, tg, g2)
    for a, b in zip(O.tree_leaves(mean2), O.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)
    # A mesh without the pod axis passes the one pod's tree through.
    same, err = C.compressed_crosspod_mean([tg], [te], make_host_mesh(device="cpu"))
    assert same is tg and err == [te]


def test_int8_roundtrip_error_bounded():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(128,)).astype(np.float32))
    q, s = C.quantize_int8(x)
    assert float((C.dequantize_int8(q, s) - x).abs().max()) <= float(s) * 0.5 + 1e-7


def test_error_feedback_keeps_the_long_run_mean_unbiased():
    g_true = torch.from_numpy(np.random.default_rng(1).normal(size=(64,)).astype(np.float32)) * 1e-3
    err = torch.zeros_like(g_true)
    total = torch.zeros_like(g_true)
    for _ in range(200):
        q, s = C.quantize_int8(g_true + err)
        g_hat = C.dequantize_int8(q, s)
        err = g_true + err - g_hat
        total = total + g_hat
    np.testing.assert_allclose((total / 200).numpy(), g_true.numpy(), rtol=0.05, atol=1e-6)


def test_shard_weight_counts_valid_tokens():
    assert float(TR._shard_weight({"mask": torch.tensor([[1.0, 0.0], [1.0, 1.0]])})) == 3.0
    assert float(TR._shard_weight({"tokens": torch.zeros(5, 2)})) == 5.0
    assert dataclasses.is_dataclass(X.ShardProvenance)
