"""The port's sharding rules against the reference's, leaf by leaf.

``repro_torch.distributed.sharding`` carries the reference's name-based
FSDP / tensor-parallel rules over the port's ``P`` tuples.  For all ten
configs at the meshes (1,1), (2,2), (2,2,2), 16x16 and 2x16x16 (as
``jax.sharding.AbstractMesh`` on the reference's side, an abstract
``RankMesh`` on the port's):

  * every param leaf's spec after ``_drop_indivisible`` (FSDP on and
    off), and its full shape;
  * the decode caches' ``cache_pspec`` for every decode shape, and the
    batches' ``batch_pspec``;
  * the activation specs of ``constrain``, ``constrain_batch`` (with and
    without ``seq_shard``, with a vocab tail, under manual axes) and
    ``constrain_qkv_context_parallel`` — the reference's captured from
    ``with_sharding_constraint``.

Last, a rank's shards of the reference's converted parameters are
bitwise the full arrays' slices.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jax_config
from repro.distributed import sharding as JSH
from repro.models import model_zoo as JZ

from repro_torch.configs import get_config, list_configs
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import spmd
from repro_torch.launch.mesh import RankMesh
from repro_torch.models import model_zoo as Z

MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


def _meshes(name):
    sizes, axes = MESHES[name]
    return AbstractMesh(sizes, axes), RankMesh.abstract(axes, sizes)


def _norm(spec) -> tuple:
    """A spec as a tuple of axis tuples (a 1-tuple and its name alike,
    trailing replicated dims dropped), for either package's spec."""

    out = [tuple(e) if isinstance(e, tuple) else (() if e is None else (e,)) for e in spec]
    while out and out[-1] == ():
        out.pop()
    return tuple(out)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@functools.lru_cache(maxsize=None)
def _reference_params(arch):
    return jax.eval_shape(lambda: JZ.init_params(jax.random.PRNGKey(0), jax_config(arch)))


def _reference_flat(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf for path, leaf in flat}


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "tp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list_configs())
def test_param_specs_match_reference(arch, mesh, fsdp):
    jmesh, pmesh = _meshes(mesh)
    want = {k: _norm(s.spec)
            for k, s in _reference_flat(JSH.shard_params(_reference_params(arch), jmesh,
                                                         fsdp=fsdp)).items()}
    shapes = {k: tuple(s.shape) for k, s in _reference_flat(_reference_params(arch)).items()}
    params = Z.init_params(get_config(arch), None, "meta", dtype=torch.float32)
    got_specs = _flat(SH.shard_params(params, pmesh, fsdp=fsdp))
    got_shapes = {k: tuple(v.shape) for k, v in _flat(params).items()}
    assert got_shapes == shapes
    assert set(got_specs) == set(want)
    for key, spec in got_specs.items():
        assert isinstance(spec, SH.P)
        assert _norm(spec) == want[key], key
    # The specs the port's model_zoo uses are the same tree.
    assert {k: _norm(v) for k, v in _flat(Z.param_specs(get_config(arch), pmesh, fsdp=fsdp)).items()} \
        == want


@pytest.mark.parametrize("mesh", list(MESHES))
def test_cache_and_batch_specs_match_reference(mesh):
    jmesh, pmesh = _meshes(mesh)
    for arch in list_configs():
        cfg, jcfg = get_config(arch), jax_config(arch)
        for shape in cfg.shapes(include_skipped=True):
            assert _norm(SH.batch_pspec(pmesh, shape.global_batch)) == \
                _norm(JSH.batch_pspec(jmesh, shape.global_batch))
            if shape.kind != "decode":
                continue
            jstate = jax.eval_shape(lambda: JZ.decode_state_spec(jcfg, shape.global_batch,
                                                                 shape.seq_len))
            pstate = Z.decode_state_spec(cfg, shape.global_batch, shape.seq_len)
            jflat, pflat = _reference_flat(jstate), _flat(pstate)
            assert set(jflat) == set(pflat)
            for key, leaf in jflat.items():
                assert tuple(pflat[key].shape) == tuple(leaf.shape)
                assert _norm(SH.cache_pspec(pmesh, tuple(leaf.shape))) == \
                    _norm(JSH.cache_pspec(jmesh, leaf.shape)), (arch, shape.name, key)
        batch = JZ.batch_spec(jcfg, cfg.shapes()[0])
        pspecs = SH.batch_sharding(pmesh, {k: torch.empty(v.shape, device="meta")
                                           for k, v in batch.items()})
        for k, v in batch.items():
            jspec = JSH.batch_pspec(jmesh, v.shape[0])
            assert _norm(pspecs[k]) == _norm(tuple(jspec) + (None,) * (len(v.shape) - 1))


def _captured_specs(monkeypatch, jmesh, seq_shard, calls):
    """Run ``calls(constrain_fns)`` on the reference with its mesh
    installed; return the specs it passed to ``with_sharding_constraint``
    (``None`` where it made no constraint)."""

    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(_norm(s.spec)) or x)
    JSH.use_mesh_for_activations(jmesh, seq_shard=seq_shard)
    out = []
    for fn in calls:
        before = len(seen)
        fn()
        out.append(seen[before:] if len(seen) > before else None)
    JSH.use_mesh_for_activations(None)
    return out


def _activation_cases(n_heads_list=(16, 24, 32, 40)):
    cases = []
    for b, s in ((256, 4096), (32, 32768), (128, 1), (1, 524288), (3, 8)):
        cases.append(("batch", (b, s, 2048), {}))
        cases.append(("batch", (b, s, 92544), {"extra": ("model",)}))
        cases.append(("batch", (b, s, 2048), {"allow_seq": False}))
        cases.append(("batch", (b, s), {}))
        for h in n_heads_list:
            cases.append(("qkv", ((b, s, h, 128), (b, s, 8, 128), (b, s, 8, 128)), {"n_heads": h}))
        cases.append(("generic", (b, s, 2048), {"spec": (("pod", "data"), "model", None)}))
        cases.append(("generic", (b, s, 2048), {"spec": ("data", None, "model")}))
    return cases


def _run_reference(case):
    kind, shape, kw = case
    if kind == "batch":
        return lambda: JSH.constrain_batch(jax.ShapeDtypeStruct(shape, jnp.bfloat16), **kw)
    if kind == "qkv":
        q, k, v = (jax.ShapeDtypeStruct(s, jnp.bfloat16) for s in shape)
        return lambda: JSH.constrain_qkv_context_parallel(q, k, v, kw["n_heads"])
    return lambda: JSH.constrain(jax.ShapeDtypeStruct(shape, jnp.bfloat16), kw["spec"])


def _run_port(case, mesh, seq_shard, manual=()):
    kind, shape, kw = case
    if kind == "batch":
        spec = SH.constrain_batch(mesh, shape, seq_shard=seq_shard, manual=manual, **kw)
        return None if spec is None else [_norm(spec)]
    if kind == "qkv":
        specs = SH.constrain_qkv_context_parallel(mesh, *shape, kw["n_heads"], manual=manual)
        return None if specs is None else [_norm(s) for s in specs]
    return [_norm(SH.constrain(mesh, shape, kw["spec"], manual=manual))]


@pytest.mark.parametrize("seq_shard", [False, True], ids=["plain", "seq_shard"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_activation_specs_match_reference(monkeypatch, mesh, seq_shard):
    jmesh, pmesh = _meshes(mesh)
    cases = _activation_cases()
    want = _captured_specs(monkeypatch, jmesh, seq_shard, [_run_reference(c) for c in cases])
    assert [_run_port(c, pmesh, seq_shard) for c in cases] == want
    # Under manual axes (the class-sharded body) the pod axis leaves every spec.
    with JSH.activation_manual_axes(("pod",)):
        want = _captured_specs(monkeypatch, jmesh, seq_shard, [_run_reference(c) for c in cases])
    assert [_run_port(c, pmesh, seq_shard, ("pod",)) for c in cases] == want
    # The sharded step's own decisions are these specs.
    lay = spmd.Layout(pmesh, {}, seq_shard)
    dp = SH.axes_size(pmesh, SH.dp_axes(pmesh))
    for kind, shape, kw in cases:
        if kind == "batch" and len(shape) == 3 and not kw and shape[0] % dp == 0:
            spec = SH.constrain_batch(pmesh, shape, seq_shard=seq_shard)
            assert lay.seq_sharded((shape[0] // dp, *shape[1:])) == (spec[1] == "model")
        if kind == "qkv" and shape[0][0] % dp == 0:
            q = shape[0]
            cfg = types.SimpleNamespace(n_heads=q[2], n_kv_heads=shape[1][2], d_head=q[3])
            assert lay.context_parallel(q[0] // dp, q[1], cfg) == (_run_port(
                (kind, shape, kw), pmesh, seq_shard) is not None)


def test_no_mesh_no_constraint():
    assert SH.constrain_batch(None, (8, 16, 64)) is None
    assert SH.constrain(None, (8, 16), ("data", None)) is None
    assert SH.constrain_qkv_context_parallel(None, (8, 16, 6, 16), (8, 16, 2, 16), (8, 16, 2, 16),
                                             6) is None


def test_local_shapes_and_slices_tile_the_tensor():
    # Every element lands in the shards of exactly as many ranks as the
    # spec leaves its dims replicated over.
    sizes, axes = (2, 2, 2), ("pod", "data", "model")
    x = torch.arange(8 * 12 * 4).reshape(8, 12, 4)
    for spec in (SH.P(("pod", "data"), "model"), SH.P(None, ("data", "model"), None),
                 SH.P("model", None, "pod"), SH.P()):
        seen = torch.zeros_like(x)
        for rank in range(8):
            mesh = RankMesh.abstract(axes, sizes, rank=rank)
            part = SH.local_slice(x, spec, mesh)
            assert tuple(part.shape) == SH.local_shape(tuple(x.shape), spec, mesh)
            seen += torch.isin(x, part).long()
        shards = int(np.prod([SH.axes_size(RankMesh.abstract(axes, sizes), e) for e in spec]))
        assert bool((seen == 8 // shards).all()), spec


@pytest.mark.parametrize("mesh", ["2x2", "2x2x2"])
def test_converted_shards_are_bitwise_slices(mesh):
    sizes, axes = MESHES[mesh]
    jcfg, cfg = jax_config("internlm2-1.8b").reduced(), get_config("internlm2-1.8b").reduced()
    tree = jax.tree.map(np.asarray, JZ.init_params(jax.random.PRNGKey(0), jcfg))
    full_serve = _flat(params_from_jax(tree, cfg, device="cpu"))
    full_train = _flat(train_state_from_jax(tree, None, device="cpu")[0])
    for rank in range(int(np.prod(sizes))):
        pmesh = RankMesh.abstract(axes, sizes, rank=rank)
        coords = dict(zip(axes, np.unravel_index(rank, sizes)))
        for fsdp, full, got in (
                (False, full_serve, _flat(params_from_jax(tree, cfg, device="cpu", mesh=pmesh))),
                (True, full_train, _flat(train_state_from_jax(tree, None, device="cpu", cfg=cfg,
                                                              mesh=pmesh)[0]))):
            specs = _flat(Z.param_specs(cfg, pmesh, fsdp=fsdp))
            for key, t in got.items():
                ref = full[key]
                idx = []
                for dim, e in enumerate(tuple(specs[key]) + (None,) * (ref.ndim - len(specs[key]))):
                    names = () if e is None else (e if isinstance(e, tuple) else (e,))
                    n = int(np.prod([dict(zip(axes, sizes))[a] for a in names])) if names else 1
                    i = 0
                    for a in names:
                        i = i * dict(zip(axes, sizes))[a] + int(coords[a])
                    c = ref.shape[dim] // n
                    idx.append(slice(i * c, (i + 1) * c))
                want = ref[tuple(idx)]
                assert t.dtype == want.dtype and tuple(t.shape) == tuple(want.shape), key
                assert torch.equal(t.detach(), want.detach()), (key, rank)
