"""Port vs reference: the Mamba2 block and the SSM / hybrid families.

The reference's parameters (``model_zoo.init_params``) cross over through
``convert.params_from_jax``; every other input is drawn with numpy from a
seed and handed to both packages, on the CPU.  The configs are the
reference's ``reduced()`` ones: mamba2-1.3b at 4 layers, d 64, d_state
16, 8 heads of 16, chunk 8; zamba2-2.7b the same Mamba2 blocks in 2
groups of 2, each followed by the shared 4/4-head attention+GLU block.
The reference's outputs are built once per module (its reduced zamba2
takes seconds to trace).

Tolerances: bf16 outputs and logits at rtol = atol = 2e-2 and the loss at
1e-3, as ``tests/test_torch_forward.py`` holds them (the frameworks round
bf16 products at other places).  The fp32 pieces fed fp32 inputs (the
conv, the chunked scan and its final state) at rtol = atol = 1e-4: only
the order of fp32 sums differs.  The chunked scan against itself at
another chunk size at 1e-4 too (the same arithmetic, regrouped); the
decode recurrence against the full-sequence block at 2e-2 (the forward
rounds the scan's output to bf16 before adding ``D · x``, the recurrence
does not).  The decode state after the reference's steps: layer 0's
Mamba2 state (before any drift) at 1e-4, every layer's leaves in L2 within ``STATE_REL`` = 2e-2
of its norm (the fp32 state sums inputs that the bf16 residual stream
carries from the layers below; a few of its small elements move by more
than 2e-2 of themselves).  Engine tokens: a row's first token that differs from the
reference's must be one whose top-2 logit gap in the reference is below
``MARGIN`` (such a token may flip, and what follows it diverge), and three
quarters of the tokens must agree before any flip.  At mixed prompt
lengths in one admission round the port serves each request the tokens
it serves that prompt alone, bitwise, and the reference's engine serving
it alone under that margin rule; the reference's own mixed round lets
the recurrent state absorb the pad steps, and its tokens are not the
port's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core.asymmetric import AsymmetricMesh as JMesh
from repro.core.asymmetric import biglittle_classes as jax_classes
from repro.models import model_zoo as JZ
from repro.models import ssm as JS
from repro.runtime.serving import ServingEngine as JaxEngine

from repro_torch.configs import SSMConfig, get_config, reference_fields
from repro_torch.convert import params_from_jax
from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes
from repro_torch.launch import serve
from repro_torch.models import model_zoo as Z
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.runtime.serving import ServingEngine

torch.set_num_threads(1)

TOL = dict(rtol=2e-2, atol=2e-2)
LOSS_TOL = dict(rtol=1e-3, atol=1e-3)
FP32_TOL = dict(rtol=1e-4, atol=1e-4)
STATE_REL = 2e-2
MARGIN = 0.04  # > 2 x the largest logit drift between the packages (~0.016 here)
ARCHS = ("mamba2-1.3b", "zamba2-2.7b")
B, S_LEN = 2, 24
N_REQ, PLEN, GEN = 6, 6, 6


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.array(x, np.float32)).to(dtype)


def _j(x, dtype=jnp.float32):
    return jnp.asarray(np.asarray(x, np.float32), dtype)


def _jax_engine(jcfg, jparams, **kw):
    mesh = JMesh(jax_classes(chips_per_pod=1), strategy="ca-das", batch_tile=1)
    kw.setdefault("slots_per_pod", mesh.batch_layout(N_REQ).c_max)
    return JaxEngine(jcfg, jparams, mesh, class_sharded="off", **kw)


def _engine(cfg, params, *, backend="matmul", **kw):
    mesh = AsymmetricMesh(biglittle_classes(chips_per_pod=1), strategy="ca-das", batch_tile=1,
                          backend=backend)
    kw.setdefault("slots_per_pod", mesh.batch_layout(N_REQ).c_max)
    return ServingEngine(cfg, params, mesh, device="cpu", **kw)


def _mixed_prompts(vocab):
    rng = np.random.default_rng(0)
    return (rng.integers(0, vocab, 3).astype(np.int32), rng.integers(0, vocab, 8).astype(np.int32))


def _serve(engine, prompts, gen):
    rids = [engine.submit(p, gen) for p in prompts]
    done = {c.rid: c.tokens.tolist() for c in engine.run()}
    return [done[r] for r in rids]


def _margins(jcfg, jparams, tokens, plen, gen):
    """Top-2 logit gap behind every generated token, teacher-forced
    through the reference's decode recurrence on its own tokens."""

    dec = jax.jit(JZ.make_decode_fn(jcfg))
    state = JZ.init_decode_state(jcfg, len(tokens), plen + gen)
    margins = []
    for t in range(plen + gen - 1):
        logits, state = dec(jparams, {"tokens": jnp.asarray(tokens[:, t:t + 1])}, state,
                            jnp.int32(t))
        if t >= plen - 1:
            top2 = np.sort(_np(logits[:, 0]), axis=-1)[:, -2:]
            margins.append(top2[:, 1] - top2[:, 0])
    return np.stack(margins, axis=1)  # (rows, gen)


def _reference_margins(jcfg, jparams, tokens):
    return _margins(jcfg, jparams, tokens, PLEN, GEN)  # (N_REQ, GEN)


def _agree_by_margin(got, want, margins, plen) -> int:
    """The margin rule on one row: a first differing generated token
    only where the reference's top-2 gap there is below ``MARGIN``;
    returns the tokens that agree before it."""

    differ = np.nonzero(np.asarray(got[plen:]) != np.asarray(want[plen:]))[0]
    if len(differ):
        first = differ[0]
        assert margins[first] < MARGIN, (first, margins[first])
        return int(first)
    return len(want) - plen


@pytest.fixture(scope="module", params=ARCHS)
def zoo(request):
    """One reduced model in both packages and the reference's outputs on
    it: forward logits and loss, the decode steps' logits, engine tokens
    at equal and at mixed prompt lengths."""

    arch = request.param
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jparams = JZ.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (B, S_LEN)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S_LEN)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    want = {"logits": _np(jax.jit(JZ.make_prefill_fn(jcfg))(jparams, {"tokens": jb["tokens"]}))}
    want["loss"] = float(jax.jit(JZ.make_loss_fn(jcfg))(jparams, jb)[0])
    dec = jax.jit(JZ.make_decode_fn(jcfg))
    state = JZ.init_decode_state(jcfg, B, S_LEN)
    steps = []
    for t in range(S_LEN):
        lg, state = dec(jparams, {"tokens": jb["tokens"][:, t:t + 1]}, state, jnp.int32(t))
        steps.append(_np(lg))
    want["decode"] = np.concatenate(steps, axis=1)
    want["decode_state"] = jax.tree.map(_np, state)
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (N_REQ, PLEN), dtype=np.int32)
    want["prompts"] = prompts
    want["engine"] = _jax_engine(jcfg, jparams, seq_cap=PLEN + GEN).generate(prompts, GEN)
    want["margins"] = _reference_margins(jcfg, jparams, want["engine"])
    mixed = _mixed_prompts(cfg.vocab)
    want["alone"] = [_serve(_jax_engine(jcfg, jparams, seq_cap=24, slots_per_pod=2), [p], 6)[0]
                     for p in mixed]
    want["alone_margins"] = [_margins(jcfg, jparams, np.asarray([t], np.int32), len(p), 6)[0]
                             for t, p in zip(want["alone"], mixed)]
    want["mixed"] = _serve(_jax_engine(jcfg, jparams, seq_cap=24, slots_per_pod=2), mixed, 6)
    return {"arch": arch, "jcfg": jcfg, "jparams": jparams, "cfg": cfg, "params": params,
            "toks": toks, "labels": labels, "want": want}


# ---------------------------------------------------------------------------
# The Mamba2 block's pieces, on random inputs
# ---------------------------------------------------------------------------

SSM_CFG = SSMConfig(d_model=32, d_state=8, headdim=8, expand=2, n_groups=1, chunk=4)
JSSM_CFG = JS.SSMConfig(**{f: getattr(SSM_CFG, f) for f in
                           ("d_model", "d_state", "headdim", "expand", "n_groups", "d_conv", "chunk")})


def _block_params(seed=0):
    """Reference Mamba2 params at SSM_CFG (fp32 masters), with random rates
    and gates so that every path carries information."""

    p = JS.init_mamba2(jax.random.PRNGKey(seed), JSSM_CFG)
    rng = np.random.default_rng(seed)
    for name, scale in (("dt_bias", 0.5), ("A_log", 0.5), ("D", 1.0), ("norm_w", 1.0),
                        ("conv_b_x", 0.3), ("conv_b_bc", 0.3)):
        p[name] = jnp.asarray(rng.normal(scale=scale, size=p[name].shape), jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, {"blocks": {"mamba": p}}),
                         get_config("mamba2-1.3b"), device="cpu")["blocks"]["mamba"]
    return p, tp


def test_causal_conv_both_forms_match_reference():
    rng = np.random.default_rng(0)
    u = rng.normal(size=(2, 10, 12)).astype(np.float32)
    w = rng.normal(scale=0.5, size=(4, 12)).astype(np.float32)
    b = rng.normal(scale=0.3, size=(12,)).astype(np.float32)
    want, _ = JS._causal_conv(_j(u), _j(w), _j(b), 4)
    got, none = S._causal_conv(_t(u), _t(w), _t(b), 4)
    assert none is None and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **FP32_TOL)
    # The decode form on a bf16 step with a bf16 history, fp32 weights.
    hist = rng.normal(size=(2, 3, 12)).astype(np.float32)
    step = u[:, :1]
    want, want_hist = JS._causal_conv(_j(step, jnp.bfloat16), _j(w), _j(b), 4,
                                      conv_state=_j(hist, jnp.bfloat16))
    got, got_hist = S._causal_conv(_t(step, torch.bfloat16), _t(w), _t(b), 4,
                                   conv_state=_t(hist, torch.bfloat16))
    assert got.shape == (2, 1, 12) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    assert np.array_equal(_np(got_hist), _np(want_hist))


def _scan_inputs(seed, b=2, s=16, h=4, p=8, n=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)  # softplus > 0
    a = -np.exp(rng.normal(scale=0.5, size=(h,))).astype(np.float32)
    bm = rng.normal(size=(b, s, 1, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, 1, n)).astype(np.float32)
    h0 = rng.normal(size=(b, h, n, p)).astype(np.float32)
    return x, dt, a, bm, cm, h0


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_reference(with_state):
    x, dt, a, bm, cm, h0 = _scan_inputs(1)
    cfg = SSMConfig(d_model=16, d_state=8, headdim=8, chunk=4)
    jcfg = JS.SSMConfig(d_model=16, d_state=8, headdim=8, chunk=4)
    want, want_state = JS._ssd_chunked(_j(x), _j(dt), _j(a), _j(bm), _j(cm), jcfg,
                                       init_state=_j(h0) if with_state else None)
    got, got_state = S._ssd_chunked(_t(x), _t(dt), _t(a), _t(bm), _t(cm), cfg,
                                    init_state=_t(h0) if with_state else None)
    np.testing.assert_allclose(_np(got), _np(want), **FP32_TOL)
    np.testing.assert_allclose(_np(got_state), _np(want_state), **FP32_TOL)


def test_ssd_chunked_is_invariant_to_the_chunk_size():
    x, dt, a, bm, cm, _ = _scan_inputs(2)
    outs = [S._ssd_chunked(_t(x), _t(dt), _t(a), _t(bm), _t(cm),
                           SSMConfig(d_model=16, d_state=8, headdim=8, chunk=q)) for q in (2, 4, 16)]
    for y, st in outs[1:]:
        np.testing.assert_allclose(_np(y), _np(outs[0][0]), **FP32_TOL)
        np.testing.assert_allclose(_np(st), _np(outs[0][1]), **FP32_TOL)
    with pytest.raises(ValueError, match="not divisible"):
        S._ssd_chunked(_t(x[:, :6]), _t(dt[:, :6]), _t(a), _t(bm[:, :6]), _t(cm[:, :6]),
                       SSMConfig(d_model=16, d_state=8, headdim=8, chunk=4))


def test_ssd_chunked_masks_the_decay_before_its_products():
    """Steep decays: above the diagonal exp(seg) overflows fp32, and the
    scan must still be finite and equal the reference."""

    x, dt, a, bm, cm, _ = _scan_inputs(3)
    a = a * 40.0
    cfg = SSMConfig(d_model=16, d_state=8, headdim=8, chunk=16)
    got, st = S._ssd_chunked(_t(x), _t(dt), _t(a), _t(bm), _t(cm), cfg)
    want, _ = JS._ssd_chunked(_j(x), _j(dt), _j(a), _j(bm), _j(cm),
                              JS.SSMConfig(d_model=16, d_state=8, headdim=8, chunk=16))
    assert torch.isfinite(got).all() and torch.isfinite(st).all()
    np.testing.assert_allclose(_np(got), _np(want), **FP32_TOL)


def test_apply_and_decode_mamba2_match_reference():
    jp, tp = _block_params(0)
    rng = np.random.default_rng(4)
    xin = rng.normal(size=(2, 8, SSM_CFG.d_model)).astype(np.float32)
    want, want_state = JS.apply_mamba2(jp, _j(xin, jnp.bfloat16), JSSM_CFG)
    got, got_state = S.apply_mamba2(tp, _t(xin, torch.bfloat16), SSM_CFG)
    assert got.dtype == torch.bfloat16 and got_state.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(got_state), _np(want_state), **TOL)

    jstate = JS.init_mamba2_state(2, JSSM_CFG)
    tstate = S.init_mamba2_state(2, SSM_CFG, device="cpu")
    for t in range(4):
        step = xin[:, t:t + 1]
        want, jstate = JS.decode_mamba2(jp, _j(step, jnp.bfloat16), JSSM_CFG, jstate)
        got, same = S.decode_mamba2(tp, _t(step, torch.bfloat16), SSM_CFG, tstate)
        assert same is tstate  # written in place
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    for name in ("ssm", "conv_x", "conv_bc"):
        assert tstate[name].dtype == {"ssm": torch.float32}.get(name, torch.bfloat16)
        np.testing.assert_allclose(_np(tstate[name]), _np(jstate[name]), **TOL)


def test_decode_recurrence_matches_the_full_sequence():
    """The port's token-by-token recurrence against its own chunked
    forward (two chunks), output and final state."""

    _, tp = _block_params(1)
    xin = _t(np.random.default_rng(5).normal(size=(2, 8, SSM_CFG.d_model)), torch.bfloat16)
    full, final = S.apply_mamba2(tp, xin, SSM_CFG)
    state = S.init_mamba2_state(2, SSM_CFG, device="cpu")
    steps = [S.decode_mamba2(tp, xin[:, t:t + 1], SSM_CFG, state)[0] for t in range(8)]
    np.testing.assert_allclose(_np(torch.cat(steps, 1)), _np(full), **TOL)
    np.testing.assert_allclose(_np(state["ssm"]), _np(final), **TOL)


# ---------------------------------------------------------------------------
# The reduced models against the reference
# ---------------------------------------------------------------------------


def test_reduced_configs_match_reference(zoo):
    cfg, jcfg = zoo["cfg"], zoo["jcfg"]
    assert {k: v for k, v in reference_fields(vars(cfg)).items() if k != "ssm"} == \
        {k: v for k, v in vars(jcfg).items() if k != "ssm"}
    assert reference_fields(vars(cfg.ssm)) == vars(jcfg.ssm)
    full, jfull = get_config(zoo["arch"]), jax_config(zoo["arch"])
    assert reference_fields(vars(full.ssm)) == vars(jfull.ssm)
    assert full.param_count() == jfull.param_count()


def test_forward_logits_and_loss_match_reference(zoo):
    cfg, params, want = zoo["cfg"], zoo["params"], zoo["want"]
    toks, labels = torch.as_tensor(zoo["toks"]), torch.as_tensor(zoo["labels"])
    logits = Z.make_prefill_fn(cfg)(params, {"tokens": toks})
    assert logits.shape == (B, S_LEN, cfg.vocab) and logits.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(logits), want["logits"], **TOL)
    loss, metrics = Z.make_loss_fn(cfg)(params, {"tokens": toks, "labels": labels})
    np.testing.assert_allclose(float(loss), want["loss"], **LOSS_TOL)
    assert float(metrics["aux"]) == 0.0


def test_decode_steps_and_state_match_reference(zoo):
    cfg, params, want = zoo["cfg"], zoo["params"], zoo["want"]
    toks = torch.as_tensor(zoo["toks"])
    state = Z.init_decode_state(cfg, B, S_LEN, device="cpu")
    dec = Z.make_decode_fn(cfg)
    steps = []
    with torch.no_grad():
        for t in range(S_LEN):
            lg, out = dec(params, {"tokens": toks[:, t:t + 1]}, state, t)
            assert out is state  # repro_torch: noqa=RPR001 -- checks the step updated the state in place
            steps.append(lg)
    np.testing.assert_allclose(_np(torch.cat(steps, 1)), want["decode"], **TOL)
    ref = want["decode_state"]
    assert set(state) == set(ref) and set(state["mamba"]) == {"ssm", "conv_x", "conv_bc"}
    leaves = [(state["mamba"][k], ref["mamba"][k]) for k in ("ssm", "conv_x", "conv_bc")]
    for got, want_leaf in leaves:  # layer 0 sees no drift yet
        np.testing.assert_allclose(_np(got[0]), want_leaf[0], **FP32_TOL)
    if cfg.shared_attn_every:
        n_groups = cfg.n_layers // cfg.shared_attn_every
        leaves += [(state[k], ref[k]) for k in ("shared_k", "shared_v")]
        assert ref["shared_k"].shape == (n_groups, B, S_LEN, cfg.n_kv_heads, cfg.head_dim)
    for got, want_leaf in leaves:
        assert tuple(got.shape) == want_leaf.shape
        for layer in range(got.shape[0]):
            err = np.linalg.norm(_np(got[layer]) - want_leaf[layer])
            assert err <= STATE_REL * np.linalg.norm(want_leaf[layer]), layer


def test_engine_tokens_match_reference_engine(zoo):
    cfg, params, want = zoo["cfg"], zoo["params"], zoo["want"]
    eng = _engine(cfg, params, seq_cap=PLEN + GEN, paged="auto")
    assert not eng.paged  # "auto" keeps the recurrent state dense
    got = eng.generate(want["prompts"], GEN)
    assert got.shape == want["engine"].shape and np.array_equal(got[:, :PLEN], want["prompts"])
    compared = 0
    for row in range(N_REQ):
        differ = np.nonzero(got[row, PLEN:] != want["engine"][row, PLEN:])[0]
        if len(differ):  # a flip only where the reference itself was close to one
            first = differ[0]
            assert want["margins"][row, first] < MARGIN, (row, first, want["margins"][row, first])
        compared += differ[0] if len(differ) else GEN
    assert compared >= N_REQ * GEN * 3 // 4, f"only {compared} tokens agreed before a flip"
    kv = eng.kv_stats()
    assert kv == {"paged": False, "kv_bytes": sum(
        x.numel() * x.element_size() for x in jax.tree.leaves(eng.state))}


def test_engine_at_mixed_prompt_lengths_serves_each_prompt_as_alone(zoo):
    """One admission round of a 3- and an 8-token prompt: the bulk prefill
    keeps each row's recurrent state through the pad steps past its
    prompt, so every request gets the port's own tokens for its prompt
    served alone, bitwise, and the reference engine's for that prompt
    alone under the margin rule.  The reference's mixed round lets the
    state absorb the pad steps: its short request's tokens are not the
    port's."""

    cfg, params, want = zoo["cfg"], zoo["params"], zoo["want"]
    mixed = _mixed_prompts(cfg.vocab)
    alone = [_serve(_engine(cfg, params, seq_cap=24, slots_per_pod=2), [p], 6)[0] for p in mixed]
    together = _serve(_engine(cfg, params, seq_cap=24, slots_per_pod=2), mixed, 6)
    assert together == alone
    assert alone[0] == want["alone"][0]  # the short prompt alone: bitwise the reference's
    agreed = 0
    for got, ref, margins, p in zip(together, want["alone"], want["alone_margins"], mixed):
        agreed += _agree_by_margin(got, ref, margins, len(p))
    assert agreed >= len(mixed) * 6 * 3 // 4, f"only {agreed} tokens agreed before a flip"
    assert together[0][:4] == want["mixed"][0][:4]  # the first generated token is the prompt's own
    assert together[0] != want["mixed"][0]  # the reference's round absorbed the pad steps


def test_kv_cache_prefill_at_mixed_prompt_lengths_is_unchanged():
    """Reduced internlm2 (a KV cache, no recurrent leaves): the bulk
    prefill at mixed prompt lengths is bitwise the loop without the
    recurrent-state keep, logits and cache, and its engine's mixed round
    serves each prompt its tokens alone."""

    jcfg, cfg = jax_config("internlm2-1.8b").reduced(), get_config("internlm2-1.8b").reduced()
    params = params_from_jax(jax.tree.map(np.asarray, JZ.init_params(jax.random.PRNGKey(0), jcfg)),
                             cfg, device="cpu")
    rng = np.random.default_rng(3)
    plens = torch.tensor([3, 8, 5, 8], dtype=torch.int32)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 8)).astype(np.int32))
    dec = Z.make_decode_fn(cfg)
    with torch.no_grad():
        got, got_state = Z.bulk_prefill_from_decode(dec)(
            params, {"tokens": tokens}, Z.init_decode_state(cfg, 4, 12, device="cpu"), 0, plens=plens)
        state, logits = Z.init_decode_state(cfg, 4, 12, device="cpu"), None
        for t in range(8):
            lg, state = dec(params, {"tokens": tokens[:, t:t + 1]}, state, t)
            logits = lg if logits is None else torch.where((plens - 1 == t)[:, None, None], lg, logits)
    assert torch.equal(got, logits)
    assert all(torch.equal(got_state[k], state[k]) for k in state)
    mixed = _mixed_prompts(cfg.vocab)
    alone = [_serve(_engine(cfg, params, seq_cap=24, slots_per_pod=2), [p], 6)[0] for p in mixed]
    assert _serve(_engine(cfg, params, seq_cap=24, slots_per_pod=2), mixed, 6) == alone


@pytest.mark.parametrize("backend", ["matmul", "cuda"])
def test_engine_equals_one_shot_over_the_padded_batch(zoo, backend):
    cfg, params, want = zoo["cfg"], zoo["params"], zoo["want"]
    eng = _engine(cfg, params, seq_cap=PLEN + GEN, backend=backend)
    got = eng.generate(want["prompts"], GEN)
    mesh = AsymmetricMesh(biglittle_classes(chips_per_pod=1), strategy="ca-das", batch_tile=1,
                          backend=backend)
    padded, order = serve.pad_requests(want["prompts"], mesh.batch_layout(N_REQ))
    with mesh.execution_context():
        ref, _ = serve.generate(cfg, params, padded, GEN, PLEN + GEN, device="cpu")
    assert np.array_equal(ref[order], got)


def test_engine_refuses_paged_on_and_gemm_count(zoo):
    cfg, params = zoo["cfg"], zoo["params"]
    with pytest.raises(ValueError, match="paged='on'"):
        _engine(cfg, params, seq_cap=8, paged="on")
    with pytest.raises(ValueError, match="recurrent state has no pages"):
        Z.init_decode_state_paged(cfg, 4, 4, device="cpu")
    # One decode step's ops.gemm calls: the LM head, plus the shared
    # block's seven a group for the hybrid.
    every = cfg.shared_attn_every
    want = 1 + (7 * (cfg.n_layers // every) if every else 0)
    assert sum(c for _, c in T.gemm_shapes(cfg)) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_serves_the_recurrent_families(arch):
    for extra in ([], ["--paged", "auto"], ["--one-shot", "--device-class", "little"]):
        summary = serve.main(["--device", "cpu", "--arch", arch, "--reduced", "--batch", "3",
                              "--prompt-len", "4", "--gen-len", "3", *extra])
        assert summary["generated"] == 3 and summary["device"] == "cpu"
        if "engine" in summary:
            assert summary["engine"]["kv_pool"]["paged"] is False
    with pytest.raises(ValueError, match="recurrent|hybrid"):
        serve.main(["--device", "cpu", "--arch", arch, "--reduced", "--paged", "on"])


@pytest.mark.parametrize("arch", ARCHS)
def test_score_cli_runs_the_recurrent_families(arch):
    from repro_torch.launch import score as SC

    summary = SC.main(["--arch", arch, "--reduced", "--device", "cpu", "--seq-len", "16"])
    assert summary["logits"] == [2, 16, 256] and np.isfinite(summary["loss"])
