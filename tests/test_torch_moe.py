"""Port vs reference: the MoE family and sliding-window (ring) decode.

The configs are the reference's ``reduced()`` qwen2-moe-a2.7b (4 experts,
top-2, a 64-wide shared expert, qkv biases) and mixtral-8x7b (4 experts,
top-2, a window of 8).  Weights are the reference's, carried over by
``convert.params_from_jax``; inputs are drawn with numpy from a seed.

**The routing-aware rule.**  Router probabilities sit close together, so
any last-bit difference between two float routes (XLA against torch here)
can flip a top-k choice, an O(1) change in that token's output.  So:

  * the top-k expert ids are compared exactly, and the share of routing
    decisions that agree must be at least ``MIN_AGREE`` = 0.9 (a route
    that dispatched differently by design, not by rounding, would agree on
    about 2/4 of the decisions at these sizes);
  * outputs and logits are held to tolerance only where routing cannot
    have differed: a token depends on the decisions before it in its
    routing group (capacity positions count in group order) and on its own
    row's earlier tokens, so only the tokens before the first differing
    decision (in any layer; at decode, at any earlier step) are compared;
  * the routing was captured from both packages as they ran (the
    reference's ``jax.lax.top_k`` under ``jax.disable_jit``, the port's
    ``moe.route``), never re-derived, and at least ``MIN_COMPARED`` = 0.5
    of the tokens must be comparable.

Tolerances: bf16 outputs and logits at rtol = atol = 2e-2 (as in
``tests/test_backend_parity.py``), fp32 router probabilities at 1e-5, the
aux loss at 1e-4 relative.  Within the port the contracts are bitwise:
two calls, paged == dense engine on the gather route, engine == one-shot
over the padded batch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model_zoo as JZ
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.runtime import serving as JS

from repro_torch.configs import get_config, list_configs, reference_fields
from repro_torch.convert import params_from_jax
from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes
from repro_torch.launch import serve
from repro_torch.models import model_zoo as Z
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.runtime import serving as S

torch.set_num_threads(1)

ARCHS = ["qwen2-moe-a2.7b", "mixtral-8x7b"]
TOL = dict(rtol=2e-2, atol=2e-2)
PROB_TOL = 1e-5
MIN_AGREE = 0.9
MIN_COMPARED = 0.5


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg = jax_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    jparams = JZ.init_params(jax.random.PRNGKey(0), jcfg)
    if jcfg.qkv_bias:  # zeros at init: draw them so the bias path carries values
        rng = np.random.default_rng(5)
        attn = dict(jparams["blocks"]["attn"])
        for name in ("bq", "bk", "bv"):
            attn[name] = jnp.asarray(rng.normal(0, 0.5, attn[name].shape), jnp.float32)
        jparams = {**jparams, "blocks": {**jparams["blocks"], "attn": attn}}
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


class _Capture:
    """Routing decisions as each package computed them, call by call."""

    def __init__(self, monkeypatch):
        self.jax, self.torch = [], []
        real_top_k, real_route = jax.lax.top_k, M.route

        def top_k(probs, k):
            out = real_top_k(probs, k)
            if not isinstance(probs, jax.core.Tracer):  # concrete under jax.disable_jit
                self.jax.append((np.asarray(probs), np.asarray(out[1]), np.asarray(out[0])))
            return out

        def route(p, x, cfg):
            out = real_route(p, x, cfg)
            self.torch.append((out[2].numpy(), out[1].numpy()))
            return out

        monkeypatch.setattr(jax.lax, "top_k", top_k)
        monkeypatch.setattr(M, "route", route)

    def idx(self):
        """(calls, groups, tokens, k) expert ids of both packages."""

        return (np.stack([c[1] for c in self.jax]), np.stack([c[1] for c in self.torch]))


def _comparable(jidx, tidx, steps: int = 1):
    """Tokens no differing decision can reach: ``jidx``/``tidx`` are (steps x
    layers, groups, tokens, k) expert ids in call order; returns the
    agreeing share and a (steps, groups, tokens) mask of the tokens before
    the first difference in their group, at this step or any earlier one."""

    agree = jidx == tidx
    share = float(agree.mean())
    tok_ok = agree.all(-1).reshape(steps, -1, *agree.shape[1:3]).all(1)  # (steps, G, tokens)
    first = np.where(tok_ok.all(-1), tok_ok.shape[-1], np.argmin(tok_ok, axis=-1))  # (steps, G)
    first = np.minimum.accumulate(first, axis=0)
    mask = np.arange(tok_ok.shape[-1])[None, None, :] < first[..., None]
    return share, mask


def _bf16(rng, shape):
    x = rng.normal(0, 1, shape).astype(np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32), **TOL)


def test_configs_match_reference():
    for arch in ARCHS:
        assert arch in list_configs()
        full, jfull = get_config(arch), jax_config(arch)
        assert reference_fields(dataclasses.asdict(full)) == dataclasses.asdict(jfull)
        small, jsmall = get_config(arch).reduced(), jax_config(arch).reduced()
        assert reference_fields(dataclasses.asdict(small)) == dataclasses.asdict(jsmall)
        assert full.param_count() == jfull.param_count()
        assert M.moe_active_params(full.moe) == JM.moe_active_params(jfull.moe)
    q = get_config("qwen2-moe-a2.7b")
    assert (q.n_layers, q.d_model, q.n_heads, q.n_kv_heads, q.vocab, q.moe.n_experts,
            q.moe.top_k, q.moe.d_ff_expert, q.moe.d_ff_shared) == \
        (24, 2048, 16, 16, 151936, 60, 4, 1408, 5632)


def test_capacity_and_merge_rules_match_reference():
    for cfg in (get_config(a).moe for a in ARCHS):
        jcfg = JM.MoEConfig(**dataclasses.asdict(cfg))
        for tokens in (1, 2, 7, 8, 12, 24, 48, 176, 2048):
            assert M._capacity(tokens, cfg) == JM._capacity(tokens, jcfg), tokens
    # The engine's slot table: 12 rows at decode are one group of 12, cap 8.
    assert M._merge(12, 1) == 12 and M._capacity(12, get_config("qwen2-moe-a2.7b").moe) == 8
    assert M._merge(10, 30) == 5 and M._merge(2, 2048) == 1 and M._merge(1, 1) == 1


@pytest.mark.parametrize("shape", [(2, 24), (12, 1), (3, 9)], ids=["rows", "decode-12", "odd"])
def test_apply_moe_matches_reference(model, monkeypatch, shape):
    jcfg, jparams, cfg, params = model
    layer = 1
    jp = jax.tree.map(lambda a: a[layer], jparams["blocks"]["moe"])
    p = T.layer_params(params["blocks"]["moe"], layer)
    jx, x = _bf16(np.random.default_rng(sum(shape)), shape + (cfg.d_model,))
    cap = _Capture(monkeypatch)
    with jax.disable_jit():
        jy, jaux = JM.apply_moe(jp, jx, jcfg.moe)
    with torch.no_grad():
        y, aux = M.apply_moe(p, x, cfg.moe)
        again, _ = M.apply_moe(p, x, cfg.moe)
    assert torch.equal(y, again)  # determinism inside the port
    (jprobs, _, jtop), (probs, _) = cap.jax[0], cap.torch[0]
    np.testing.assert_allclose(probs, jprobs, rtol=0, atol=PROB_TOL)
    share, mask = _comparable(*cap.idx())
    assert share >= MIN_AGREE and mask.mean() >= MIN_COMPARED, (share, mask.mean())
    b, s = shape
    merged = mask.reshape(b, s)
    _close(y.float().numpy()[merged], np.asarray(jy.astype(jnp.float32))[merged])
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-4)

    # The combine fed the reference's own routing (its top-k, renormalised
    # as the reference does): to tolerance everywhere.
    g = M._merge(b, s)
    xg = x.reshape(b // g, g * s, -1)
    jgate = jtop / np.maximum(jtop.sum(-1, keepdims=True), 1e-9)
    with torch.no_grad():
        fed = M.combine(p, xg, cfg.moe, torch.tensor(jgate), torch.tensor(cap.jax[0][1]))
    _close(fed.reshape(shape + (-1,)).float().numpy(), jy.astype(jnp.float32))


def test_capacity_drops_and_shared_expert(model, monkeypatch):
    """A router that sends every token to the same experts overflows their
    capacity: the dropped decisions contribute nothing, identically in both
    packages; with the routed experts silenced only the shared one is left."""

    jcfg, jparams, cfg, params = model
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["moe"])
    bias = np.zeros((cfg.d_model, cfg.moe.n_experts), np.float32)
    bias[:, :cfg.moe.top_k] = 0.5  # experts 0..k-1 win for any positive-mean token
    jp = {**jp, "router": jp["router"] + jnp.asarray(bias)}
    p = params_from_jax({"moe": jax.tree.map(np.asarray, jp)}, cfg, device="cpu")["moe"]
    rng = np.random.default_rng(3)
    x = np.abs(rng.normal(0, 1, (1, 32, cfg.d_model))).astype(np.float32)
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    with torch.no_grad():
        gate_w, idx, _ = M.route(p, tx, cfg.moe)
        pos = M.positions(idx, cfg.moe)
    cap = M._capacity(32, cfg.moe)
    assert int((pos >= cap).sum()) > 0  # decisions were dropped
    with torch.no_grad():
        y, _ = M.apply_moe(p, tx, cfg.moe)
    jy, _ = JM.apply_moe(jp, jx, jcfg.moe)
    _close(y.float().numpy(), jy.astype(jnp.float32))
    # A token whose every decision dropped gets the shared expert alone.
    silent = {**jp, "w2": jnp.zeros_like(jp["w2"])}
    ps = params_from_jax({"moe": jax.tree.map(np.asarray, silent)}, cfg, device="cpu")["moe"]
    with torch.no_grad():
        ys, _ = M.apply_moe(ps, tx, cfg.moe)
    jys, _ = JM.apply_moe(silent, jx, jcfg.moe)
    _close(ys.float().numpy(), jys.astype(jnp.float32))
    if not cfg.moe.d_ff_shared:
        assert not bool(ys.any())


def test_aux_loss_matches_reference(model):
    """The Switch loss at a uniform and a collapsed router (the reference's
    own extremes), and at the random one."""

    jcfg, jparams, cfg, params = model
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["moe"])
    jx, x = _bf16(np.random.default_rng(4), (2, 16, cfg.d_model))
    collapsed = np.zeros((cfg.d_model, cfg.moe.n_experts), np.float32)
    collapsed[:, 0] = 10.0
    for router in (jnp.zeros_like(jp["router"]), jnp.asarray(collapsed), jp["router"]):
        jpr = {**jp, "router": router}
        pr = params_from_jax({"moe": jax.tree.map(np.asarray, jpr)}, cfg, device="cpu")["moe"]
        _, jaux = JM.apply_moe(jpr, jx, jcfg.moe)
        with torch.no_grad():
            _, aux = M.apply_moe(pr, x, cfg.moe)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-4)


def test_forward_and_loss_match_reference(model, monkeypatch):
    jcfg, jparams, cfg, params = model
    b, s = 2, 24
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    cap = _Capture(monkeypatch)
    with jax.disable_jit():
        jlogits, jaux = JT.forward_lm(jparams, jcfg, {"tokens": jnp.asarray(batch["tokens"])},
                                      remat=False)
    with torch.no_grad():
        logits, aux = T.forward_lm(params, cfg, {"tokens": torch.from_numpy(batch["tokens"])})
    share, mask = _comparable(*cap.idx())
    assert share >= MIN_AGREE and mask.mean() >= MIN_COMPARED, (share, mask.mean())
    rows = mask.reshape(b, s)  # two rows of 24 merge into one routing group
    _close(logits.float().numpy()[rows], np.asarray(jlogits.astype(jnp.float32))[rows])
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-3)

    jloss, jm = JT.loss_fn(jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}, remat=False)
    loss, m = Z.make_loss_fn(cfg)(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(m["aux"]) > 0
    np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]), rtol=1e-3)
    np.testing.assert_allclose(float(m["ce"]), float(jm["ce"]), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-3, atol=1e-3)


def _decode_both(jcfg, jparams, cfg, params, monkeypatch, *, b, steps, seq, paged):
    """``steps`` decode steps of both packages from position 0 (past the
    window for mixtral), dense or through a page table; returns the logits,
    the final states and the captured routing."""

    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, (steps, b, 1)).astype(np.int32)
    extra, jextra = {}, {}
    if paged:
        ps = 4
        w = T.cache_len(cfg, seq) // ps
        table = rng.permutation(b * w + 3)[: b * w].reshape(b, w).astype(np.int32)
        extra, jextra = {"page_table": torch.from_numpy(table)}, {"page_table": jnp.asarray(table)}
        jstate = JZ.init_decode_state_paged(jcfg, b * w + 3, ps)
        state = Z.init_decode_state_paged(cfg, b * w + 3, ps, device="cpu")
    else:
        jstate = JZ.init_decode_state(jcfg, b, seq)
        state = Z.init_decode_state(cfg, b, seq, device="cpu")
    jdec, dec = JZ.make_decode_fn(jcfg), Z.make_decode_fn(cfg)
    cap = _Capture(monkeypatch)
    jl, tl = [], []
    for t in range(steps):
        pos = np.full((b,), t, np.int32)
        with jax.disable_jit():
            lg, jstate = jdec(jparams, {"tokens": jnp.asarray(toks[t]), **jextra}, jstate,
                              jnp.asarray(pos))
        with torch.no_grad():
            lt, state = dec(params, {"tokens": torch.from_numpy(toks[t]), **extra}, state,
                            torch.from_numpy(pos))
        jl.append(np.asarray(lg.astype(jnp.float32)))
        tl.append(lt.float().numpy())
    return np.stack(jl), np.stack(tl), jstate, state, cap


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_decode_matches_reference_past_the_window(model, monkeypatch, paged):
    jcfg, jparams, cfg, params = model
    b, steps, seq = 4, 14, 16  # mixtral's ring holds 8: positions 8..13 wrap
    jl, tl, jstate, state, cap = _decode_both(jcfg, jparams, cfg, params, monkeypatch,
                                              b=b, steps=steps, seq=seq, paged=paged)
    share, mask = _comparable(*cap.idx(), steps=steps)
    assert share >= MIN_AGREE and mask.mean() >= MIN_COMPARED, (share, mask.mean())
    ok = mask[:, 0, :]  # (steps, rows): one group of b rows a step
    _close(tl[:, :, 0][ok], jl[:, :, 0][ok])
    # Layer 0 sees the embedding, one norm and one projection: its cache is
    # bitwise equal, the ring's wrapped slots included.
    for name in ("pages_k", "pages_v") if paged else ("k", "v"):
        assert np.array_equal(state[name][0].float().numpy(),
                              np.asarray(jstate[name][0].astype(jnp.float32)))


def test_ring_decode_writes_pos_mod_window_and_paged_equals_dense(model):
    *_, cfg, params = model
    if cfg.swa_window is None:
        cfg = dataclasses.replace(cfg, swa_window=8)
    b, seq, ps = 3, 20, 4
    s_cache = T.cache_len(cfg, seq)
    assert s_cache == 8
    w = s_cache // ps
    table = torch.arange(b * w, dtype=torch.int32).reshape(b, w).flip(1).contiguous()
    dense = Z.init_decode_state(cfg, b, seq, device="cpu")
    pag = Z.init_decode_state_paged(cfg, b * w, ps, device="cpu")
    dec = Z.make_decode_fn(cfg)
    rng = np.random.default_rng(8)
    for t in range(seq - 2):
        tok = torch.from_numpy(rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32))
        pos = torch.full((b,), t, dtype=torch.int32)
        before = dense["k"].clone()
        with torch.no_grad():
            ld, dense = dec(params, {"tokens": tok}, dense, pos)
            lp, pag = dec(params, {"tokens": tok, "page_table": table}, pag, pos)
        assert torch.equal(ld, lp), t  # the gather route reads the same values
        changed = (dense["k"] != before).any(dim=(0, 3, 4))  # (rows, slots)
        assert changed[:, [j for j in range(s_cache) if j != t % s_cache]].sum() == 0
        slot = t % s_cache
        assert torch.equal(pag["pages_k"][:, table[:, slot // ps].long(), slot % ps],
                           dense["k"][:, :, slot])


def _engine(cfg, params, *, paged="off", **kw):
    asym = kw.pop("asym", None) or AsymmetricMesh(biglittle_classes(chips_per_pod=1),
                                                  strategy="ca-das", batch_tile=1)
    kw.setdefault("slots_per_pod", 3)
    return S.ServingEngine(cfg, params, asym, device="cpu", paged=paged, **kw)


def test_engine_paged_equals_dense_bitwise(model):
    *_, cfg, params = model
    rng = np.random.default_rng(9)
    reqs = [(rng.integers(0, cfg.vocab, int(rng.integers(2, 7)), dtype=np.int32), int(n))
            for n in rng.integers(1, 9, size=11)]
    out = {}
    for paged in ("off", "on"):
        eng = _engine(cfg, params, seq_cap=16, paged=paged, page_size=4, eos_id=int(reqs[0][0][0]))
        for prompt, n in reqs:
            eng.submit(prompt, n)
        out[paged] = sorted((c.rid, c.tokens.tolist(), c.stop) for c in eng.run())
        if paged == "on":
            kv = eng.kv_stats()
            # One private phantom lane a slot: capacity routing couples rows.
            assert kv["phantom_pages"] == eng.n_slots * kv["pages_per_slot"]
            assert kv["pages_live"] == kv["phantom_pages"]
    assert len(out["on"]) == len(reqs) and out["on"] == out["off"]


def test_engine_equals_one_shot_over_the_padded_batch(model):
    *_, cfg, params = model
    b, plen, gen = 5, 6, 7
    prompts = np.random.default_rng(10).integers(0, cfg.vocab, (b, plen), dtype=np.int32)
    asym = AsymmetricMesh(biglittle_classes(chips_per_pod=1), strategy="ca-das", batch_tile=1)
    layout = asym.batch_layout(b)
    eng = _engine(cfg, params, asym=asym, seq_cap=plen + gen, slots_per_pod=layout.c_max)
    got = eng.generate(prompts, gen)
    padded, order = serve.pad_requests(prompts, layout)
    with asym.execution_context():
        ref, _ = serve.generate(cfg, params, padded, gen, plen + gen, device="cpu")
    assert np.array_equal(got, ref[order])


def test_paged_auto_follows_the_reference_rule(model):
    *_, cfg, params = model
    assert _engine(cfg, params, seq_cap=8, paged="auto").paged
    for name in ("mamba2-1.3b", "zamba2-2.7b", "internlm2-1.8b", "mixtral-8x7b"):
        jc = jax_config(name)
        assert S._paged_supported(jc) == JS._paged_supported(jc), name
    mamba = dataclasses.replace(cfg, family="ssm")
    assert not S._paged_supported(mamba)[0]
    with pytest.raises(ValueError, match="paged='on'"):
        S.ServingEngine(mamba, params, AsymmetricMesh(biglittle_classes(chips_per_pod=1)),
                        seq_cap=8, device="cpu", paged="on")


def test_params_from_jax_carries_the_moe_params(model):
    jcfg, jparams, cfg, params = model
    moe, jmoe = params["blocks"]["moe"], jparams["blocks"]["moe"]
    e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
    assert tuple(moe["router"].shape) == (cfg.n_layers, d, e)
    assert tuple(moe["w1"].shape) == tuple(moe["w3"].shape) == (cfg.n_layers, e, d, f)
    assert tuple(moe["w2"].shape) == (cfg.n_layers, e, f, d)
    names = ["router", "w1", "w3", "w2"]
    if cfg.moe.d_ff_shared:
        assert tuple(moe["shared_gate"].shape) == (cfg.n_layers, d, 1)
        names.append("shared_gate")
        assert moe["shared"]["w2"].dtype == torch.bfloat16
    for name in names:
        assert moe[name].dtype == torch.bfloat16, name
        want = np.asarray(jmoe[name].astype(jnp.bfloat16).astype(jnp.float32))
        assert np.array_equal(moe[name].float().numpy(), want), name
    assert params["blocks"]["ln2"].dtype == torch.float32
    if cfg.qkv_bias:
        assert params["blocks"]["attn"]["bq"].dtype == torch.float32


def test_port_init_params_for_moe(model):
    *_, cfg, _ = model
    p = Z.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    moe = p["blocks"]["moe"]
    assert "mlp" not in p["blocks"]
    assert tuple(moe["w1"].shape) == (cfg.n_layers, cfg.moe.n_experts, cfg.d_model,
                                      cfg.moe.d_ff_expert)
    assert abs(moe["router"].float().std().item() - 0.02) < 0.004
    assert abs(moe["w1"].float().std().item() - cfg.d_model ** -0.5) < 0.02
    again = Z.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["blocks"]["moe"]["w2"], moe["w2"])
    shapes = T.gemm_shapes(cfg)
    per_layer = 4 + (3 if cfg.moe.d_ff_shared else 0)
    assert sum(c for _, c in shapes) == per_layer * cfg.n_layers + 1


@pytest.mark.parametrize("extra", [(), ("--paged", "on"), ("--one-shot", "--device-class", "little")],
                         ids=["engine", "paged", "one-shot-little"])
def test_serve_cli_runs_the_moe_family(model, extra):
    *_, cfg, _ = model
    arch = cfg.name.removesuffix("-smoke")
    got = serve.main(["--device", "cpu", "--arch", arch, "--reduced", "--batch", "4",
                      "--prompt-len", "4", "--gen-len", "4", *extra])
    assert got["arch"] == cfg.name and got["generated"] == 4
    if "--one-shot" not in extra:
        assert got["engine"]["completed"] == 4
        assert got["engine"]["kv_pool"]["paged"] == ("--paged" in extra)


def test_score_and_profile_clis_take_the_moe_family(model, tmp_path):
    from repro_torch.launch import profile_decode, score

    *_, cfg, _ = model
    arch = cfg.name.removesuffix("-smoke")
    got = score.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
                      "--seq-len", "16"])
    assert got["aux"] > 0 and got["loss"] == pytest.approx(got["ce"] + got["aux"], rel=1e-5)
    rec = profile_decode.main(["--device", "cpu", "--arch", arch, "--reduced", "--batch", "2",
                               "--prompt-len", "2", "--gen-len", "4",
                               "--out", str(tmp_path / "p.json")])
    assert sum(s["per_step"] for s in rec["block_search"]["shapes"]) == \
        sum(c for _, c in T.gemm_shapes(cfg))
    assert rec["dense"]["trace"]["steps"] == 1
