"""Port vs reference: AdamW, the data pipeline and the checkpointer.

The same numpy inputs from a seed go through both packages.  Tolerances:
the AdamW update is fp32 arithmetic in the reference's order, held at
rtol 1e-6 (a few fp32 ulps: ``pow`` and the reductions round in other
places) over three updates; the schedule at rtol 1e-6; the data arrays
and the checkpoints' arrays bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.core.asymmetric import AsymmetricMesh as JAsymmetricMesh
from repro.core.asymmetric import DeviceClass as JDeviceClass
from repro.data import pipeline as JP
from repro.optim import adamw as JO

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.asymmetric import AsymmetricMesh, DeviceClass
from repro_torch.data import pipeline as P
from repro_torch.optim import adamw as O

RTOL = 1e-6


def _tree(rng):
    """Leaves of every kind the trainer updates: a matrix, a stacked
    ``(L, d)`` norm weight (decayed: ndim 2), a vector (not decayed)."""

    return {"blocks": {"w": rng.normal(size=(3, 8, 6)).astype(np.float32),
                       "ln": rng.normal(size=(3, 8)).astype(np.float32)},
            "final_norm": rng.normal(size=(8,)).astype(np.float32)}


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.asarray(tree.detach() if isinstance(tree, torch.Tensor) else tree)


def _assert_close(got, want, **tol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_close(got[k], want[k], **tol)
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), **tol)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("clip", [1.0, None])
def test_adamw_update_matches_reference(clip):
    rng = np.random.default_rng(0)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip)
    params = _tree(rng)
    jp = jax.tree.map(jnp.asarray, params)
    tp = O.tree_map(torch.from_numpy, params)
    js, ts = JO.init_opt_state(jp), O.init_opt_state(tp)
    for _ in range(3):
        grads = jax.tree.map(lambda x: (rng.normal(size=x.shape) * 3).astype(np.float32), params)
        jp, js, jm = JO.adamw_update(jp, jax.tree.map(jnp.asarray, grads), js, JO.AdamWConfig(**cfg))
        tp, ts, tm = O.adamw_update(tp, O.tree_map(torch.from_numpy, grads), ts, O.AdamWConfig(**cfg))
        _assert_close(_np_tree(tp), jax.tree.map(np.asarray, jp), rtol=RTOL, atol=0)
        for key in ("m", "v"):
            _assert_close(_np_tree(ts[key]), jax.tree.map(np.asarray, js[key]), rtol=RTOL, atol=0)
        assert int(ts["step"]) == int(js["step"])
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=RTOL)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_schedule_matches_reference(schedule):
    cfg = dict(lr=0.3, warmup_steps=10, total_steps=100, schedule=schedule)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        want = float(JO.lr_at(JO.AdamWConfig(**cfg), jnp.int32(step)))
        got = O.lr_at(O.AdamWConfig(**cfg), torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=RTOL)
        np.testing.assert_allclose(float(O.lr_at(O.AdamWConfig(**cfg), step)), want, rtol=RTOL)


def test_clip_and_global_norm_match_reference():
    rng = np.random.default_rng(1)
    grads = _tree(rng)
    want_clipped, want_norm = JO.clip_by_global_norm(jax.tree.map(jnp.asarray, grads), 1.0)
    clipped, norm = O.clip_by_global_norm(O.tree_map(torch.from_numpy, grads), 1.0)
    np.testing.assert_allclose(float(norm), float(want_norm), rtol=RTOL)
    _assert_close(_np_tree(clipped), jax.tree.map(np.asarray, want_clipped), rtol=RTOL, atol=0)
    assert float(O.global_norm(clipped)) <= 1.0 + 1e-5
    small = {"a": torch.full((4,), 0.1)}
    assert torch.equal(O.clip_by_global_norm(small, 1.0)[0]["a"], small["a"])


def test_adamw_reduces_a_quadratic():
    cfg = O.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0, total_steps=100,
                        schedule="constant")
    params = {"w": torch.tensor([3.0, -2.0])}
    state = O.init_opt_state(params)
    for _ in range(60):
        params, state, _ = O.adamw_update(params, {"w": 2 * params["w"]}, state, cfg)
    assert float(params["w"].abs().max()) < 0.5


def test_grad_accumulation_is_the_mean_over_micro_batches():
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.normal(size=(8, 4)), dtype=torch.float32)
    y = torch.as_tensor(rng.normal(size=(8, 2)), dtype=torch.float32)
    p = {"w": torch.ones((4, 2), requires_grad=True)}

    def loss_fn(params, batch):
        loss = torch.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)
        return loss, {"l": loss}

    l1, m1, g1 = O.accumulate_gradients(loss_fn, p, {"x": x, "y": y}, 1)
    l4, m4, g4 = O.accumulate_gradients(loss_fn, p, {"x": x, "y": y}, 4)
    np.testing.assert_allclose(float(l1), float(l4), rtol=1e-5)
    np.testing.assert_allclose(g1["w"].numpy(), g4["w"].numpy(), rtol=1e-4)
    last, _ = loss_fn(p, {"x": x[6:], "y": y[6:]})
    assert float(m4["l"]) == pytest.approx(float(last.detach()))  # the last micro-batch's metrics
    with pytest.raises(ValueError, match="does not divide"):
        O.accumulate_gradients(loss_fn, p, {"x": x, "y": y}, 3)


# ---------------------------------------------------------------------------
# The data pipeline
# ---------------------------------------------------------------------------


def test_synthetic_and_memmap_sources_equal_reference(tmp_path):
    for step in (0, 5):
        a = P.SyntheticLM(vocab=100, seed=7).batch(step, 4, 16)
        b = JP.SyntheticLM(vocab=100, seed=7).batch(step, 4, 16)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 500, size=4000).astype(np.uint16).tofile(path)
    for step in (0, 3):
        a = P.MemmapLM(str(path), vocab=500).batch(step, 3, 32)
        b = JP.MemmapLM(str(path), vocab=500).batch(step, 3, 32)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
    got = [x["tokens"] for x in P.batches(P.SyntheticLM(50, 1), 2, 8, steps=3, start_step=2)]
    want = [x["tokens"] for x in JP.batches(JP.SyntheticLM(50, 1), 2, 8, steps=3, start_step=2)]
    for x, y in zip(got, want, strict=True):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("strategy", ["sas", "ca-das", "sss"])
def test_asymmetric_batcher_equals_reference(strategy):
    classes = lambda DC: [DC("a", chips_per_pod=2), DC("b", chips_per_pod=1, rel_throughput=0.5)]  # noqa: E731
    mesh = AsymmetricMesh(classes(DeviceClass), strategy=strategy, batch_tile=2)
    jmesh = JAsymmetricMesh(classes(JDeviceClass), strategy=strategy, batch_tile=2)
    bw = P.AsymmetricBatcher(P.SyntheticLM(50, 1), mesh).batch(3, 10, 8)
    jbw = JP.AsymmetricBatcher(JP.SyntheticLM(50, 1), jmesh).batch(3, 10, 8)
    assert isinstance(bw, P.BatchWithLayout)
    assert bw.layout.sizes == jbw.layout.sizes and bw.layout.c_max == jbw.layout.c_max
    assert set(bw.arrays) == set(jbw.arrays) == {"tokens", "labels", "mask"}
    for k in bw.arrays:
        np.testing.assert_array_equal(bw.arrays[k], jbw.arrays[k])
        assert bw.arrays[k].dtype == jbw.arrays[k].dtype
    logical = P.SyntheticLM(50, 1).batch(3, 10, 8)
    mask = bw.arrays["mask"][:, 0] > 0
    np.testing.assert_array_equal(bw.arrays["tokens"][mask], logical["tokens"])
    assert bw.arrays["mask"].sum() == 10 * 8


# ---------------------------------------------------------------------------
# The checkpointer
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_save=False)
    tree = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.tensor(3.5)}}
    for step in (1, 2, 3):
        ck.save(step, tree, extra={"restarts": step})
    assert ck.committed_steps() == [2, 3]
    out, manifest = ck.restore(tree, device="cpu")
    assert torch.equal(out["a"], tree["a"]) and torch.equal(out["b"]["c"], tree["b"]["c"])
    assert out["b"]["c"].shape == ()
    assert manifest["step"] == 3 and manifest["extra"] == {"restarts": 3}
    assert set(manifest["keys"]) == {"a", "b/c"}


def test_checkpoint_async_save(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=True)
    ck.save(1, {"w": torch.ones((128, 128))})
    ck.wait()
    assert ck.latest_step() == 1
    ck.save(2, {"w": torch.zeros((128, 128))})
    out, manifest = ck.restore({"w": ((128, 128), torch.float32)})  # joins the write first
    assert manifest["step"] == 2 and not out["w"].any()


def test_checkpoint_restore_specific_step_and_reject_shapes(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=0, async_save=False)
    ck.save(1, {"w": torch.tensor(1.0)})
    ck.save(2, {"w": torch.tensor(2.0)})
    out, _ = ck.restore({"w": torch.tensor(0.0)}, step=1)
    assert float(out["w"]) == 1.0
    ck.save(3, {"w": torch.ones((2,))})
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore({"w": torch.ones((3,))})
    with pytest.raises(TypeError, match="bf16"):
        ck.save(4, {"w": torch.ones((2,), dtype=torch.bfloat16)})
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore({"w": torch.ones(1)})


def test_checkpoints_cross_between_packages(tmp_path):
    rng = np.random.default_rng(3)
    tree = {"params": _tree(rng), "opt": {"step": np.int32(7), "m": _tree(rng)}}
    JCheckpointer(str(tmp_path / "j"), async_save=False).save(5, jax.tree.map(jnp.asarray, tree))
    got, manifest = Checkpointer(str(tmp_path / "j")).restore(
        O.tree_map(torch.from_numpy, O.tree_map(np.asarray, tree)), device="cpu")
    assert manifest["step"] == 5
    _assert_close(_np_tree(got), tree, rtol=0, atol=0)
    assert got["opt"]["step"].dtype == torch.int32 and got["opt"]["step"].shape == ()

    Checkpointer(str(tmp_path / "p"), async_save=False).save(
        6, O.tree_map(torch.from_numpy, O.tree_map(np.asarray, tree)))
    jgot, jmanifest = JCheckpointer(str(tmp_path / "p")).restore(jax.tree.map(jnp.asarray, tree))
    assert jmanifest["step"] == 6
    _assert_close(jax.tree.map(np.asarray, jgot), tree, rtol=0, atol=0)
    for key in ("j", "p"):
        names = sorted(p.name for p in (tmp_path / key / f"step_0000000{5 if key == 'j' else 6}").iterdir())
        assert names == ["COMMITTED", "manifest.json", "shard_p0000.npz"]


# ---------------------------------------------------------------------------
# Train states of every family
# ---------------------------------------------------------------------------


def _reference_train_state(arch):
    """The reference's reduced fp32 params and an AdamW state one update in
    (``m`` and ``v`` non-zero), as numpy trees."""

    from repro.configs import get_config as jax_config
    from repro.models import model_zoo as JZ

    jcfg = jax_config(arch).reduced()
    params = JZ.init_params(jax.random.PRNGKey(0), jcfg)
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.25), params)
    params, opt, _ = JO.adamw_update(params, grads, JO.init_opt_state(params), JO.AdamWConfig())
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, opt)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-1.3b", "zamba2-2.7b", "whisper-small"])
def test_train_state_from_jax_carries_every_family(arch):
    """The MoE stacks, the Mamba2 leaves, the hybrid's unstacked shared
    block and the enc-dec's two stacks become fp32 masters that require
    grad, bitwise equal, with ``m``, ``v`` and ``step``."""

    from repro_torch.convert import train_state_from_jax

    params, opt = _reference_train_state(arch)
    got, got_opt = train_state_from_jax(params, opt, device="cpu")
    _assert_close(_np_tree(got), params, rtol=0, atol=0)
    _assert_close(_np_tree(got_opt), opt, rtol=0, atol=0)
    assert all(p.dtype == torch.float32 and p.requires_grad for p in O.tree_leaves(got))
    assert not any(t.requires_grad for t in O.tree_leaves({"m": got_opt["m"], "v": got_opt["v"]}))
    assert got_opt["step"].dtype == torch.int32 and int(got_opt["step"]) == 1


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-1.3b"])
def test_family_train_states_cross_between_packages(arch, tmp_path):
    """A reduced train state saved by either package's checkpointer, in the
    trainers' ``{"params", "opt"}`` layout, restores in the other bitwise."""

    from repro_torch.convert import train_state_from_jax

    params, opt = _reference_train_state(arch)
    tree = {"params": params, "opt": opt}
    port = dict(zip(("params", "opt"), train_state_from_jax(params, opt, device="cpu")))
    JCheckpointer(str(tmp_path / "j"), async_save=False).save(3, jax.tree.map(jnp.asarray, tree))
    got, manifest = Checkpointer(str(tmp_path / "j")).restore(port, device="cpu")
    assert manifest["step"] == 3
    _assert_close(_np_tree(got), tree, rtol=0, atol=0)

    Checkpointer(str(tmp_path / "p"), async_save=False).save(4, port)
    jgot, jmanifest = JCheckpointer(str(tmp_path / "p")).restore(jax.tree.map(jnp.asarray, tree))
    assert jmanifest["step"] == 4
    _assert_close(jax.tree.map(np.asarray, jgot), tree, rtol=0, atol=0)
