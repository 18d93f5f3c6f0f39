"""Port vs reference: the reduced internlm2 decode step, dense and paged.

The reference's parameters (``model_zoo.init_params``) cross over through
``convert.params_from_jax``; tokens, positions and page tables are drawn
with numpy from a seed and handed to both packages.  The reduced config is
the reference's ``reduced()``: 4 layers, d 64, 4/2 heads of 16, vocab 256.

Tolerance: the logits are bf16 (the LM head returns the compute dtype),
held at rtol = atol = 2e-2 as in ``tests/test_backend_parity.py``.  The
two frameworks round bf16 products at other places, and four layers of
bf16 residual stream carry that drift into the logits (layer 0's cache,
before any drift, is bitwise equal).  Within the port
the bulk prefill's caches equal the token-by-token replay bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model_zoo as JZ
from repro.runtime.paging import SENTINEL

from repro_torch.configs import get_config, reference_fields
from repro_torch.convert import params_from_jax
from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes
from repro_torch.models import model_zoo as Z
from repro_torch.models import transformer as T

torch.set_num_threads(1)

TOL = dict(rtol=2e-2, atol=2e-2)
ARCH = "internlm2-1.8b"


@pytest.fixture(scope="module")
def model():
    jcfg = jax_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jparams = JZ.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def test_reduced_config_matches_reference(model):
    jcfg, _, cfg, _ = model
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.vocab) \
        == (4, 64, 4, 2, 16, 256)
    for field in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab",
                  "rope_theta", "norm_eps", "qkv_bias", "swa_window", "family"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    full, jfull = get_config(ARCH), jax_config(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads, full.head_dim,
            full.d_ff, full.vocab) == (24, 2048, 16, 8, 128, 8192, 92544)
    assert reference_fields(vars(full)) == {k: v for k, v in vars(jfull).items()}


def test_params_from_jax_layout_and_dtypes(model):
    _, jparams, cfg, params = model
    assert tuple(params["blocks"]["attn"]["wq"].shape) == (4, 64, 64)       # (L, in, out)
    assert tuple(params["blocks"]["mlp"]["w2"].shape) == (4, cfg.d_ff, 64)
    assert params["blocks"]["attn"]["wk"].dtype == torch.bfloat16
    assert params["lm_head"].dtype == params["embed"].dtype == torch.bfloat16
    for norm in (params["blocks"]["ln1"], params["blocks"]["ln2"], params["final_norm"]):
        assert norm.dtype == torch.float32
    want = np.asarray(jparams["blocks"]["attn"]["wq"].astype(jnp.bfloat16).astype(jnp.float32))
    assert np.array_equal(params["blocks"]["attn"]["wq"].float().numpy(), want)


def test_port_init_params_scales(model):
    *_, cfg, _ = model
    gen = torch.Generator().manual_seed(0)
    p = Z.init_params(cfg, gen, device="cpu")
    assert p["blocks"]["attn"]["wq"].dtype == torch.bfloat16
    assert torch.equal(p["final_norm"], torch.ones(cfg.d_model))
    assert abs(p["lm_head"].float().std().item() - 0.02) < 0.004
    assert abs(p["embed"].float().std().item() - 0.02) < 0.004
    w1 = p["blocks"]["mlp"]["w1"].float()
    assert abs(w1.std().item() - cfg.d_model ** -0.5) < 0.02
    again = Z.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["blocks"]["mlp"]["w2"], p["blocks"]["mlp"]["w2"])


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **TOL)


def _steps(rng, cfg, b, n):
    toks = rng.integers(0, cfg.vocab, size=(n, b, 1)).astype(np.int32)
    pos0 = rng.integers(0, 3, size=(b,)).astype(np.int32)
    return toks, pos0


@pytest.mark.parametrize("route", ["matmul", "cuda"])
def test_dense_decode_logits_match_reference(model, route):
    """Several decode steps with per-row positions; ``cuda`` runs the
    kernels' plain versions under the big class's tree."""

    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(0)
    b, seq = 5, 12
    toks, pos0 = _steps(rng, cfg, b, 6)
    live = np.array([True, True, False, True, True])
    jstate = JZ.init_decode_state(jcfg, b, seq)
    state = Z.init_decode_state(cfg, b, seq, device="cpu")
    jdec, dec = jax.jit(JZ.make_decode_fn(jcfg)), Z.make_decode_fn(cfg)
    mesh = AsymmetricMesh(biglittle_classes(chips_per_pod=1), batch_tile=1, backend=route)
    for t, tok in enumerate(toks):
        pos = pos0 + t
        jlog, jstate = jdec(jparams, {"tokens": jnp.asarray(tok), "live": jnp.asarray(live)},
                            jstate, jnp.asarray(pos))
        with torch.no_grad(), mesh.execution_context():
            logits, state = dec(params, {"tokens": torch.from_numpy(tok),
                                         "live": torch.from_numpy(live)},
                                state, torch.from_numpy(pos))
        assert logits.dtype == torch.bfloat16 and tuple(logits.shape) == (b, 1, cfg.vocab)
        _close(logits, jlog)
    # Layer 0's cache sees only the embedding, one norm and one projection:
    # bitwise equal.  Deeper layers carry the bf16 drift the logits show.
    for name in ("k", "v"):
        assert np.array_equal(state[name][0].float().numpy(),
                              np.asarray(jstate[name][0].astype(jnp.float32)))


def test_paged_decode_logits_match_reference(model):
    jcfg, jparams, cfg, params = model
    rng = np.random.default_rng(1)
    b, ps, w = 4, 4, 3
    n_pages = b * w + 2
    table = rng.permutation(n_pages)[: b * w].reshape(b, w).astype(np.int32)
    table[3] = SENTINEL  # a dead row writes nothing
    toks, pos0 = _steps(rng, cfg, b, 5)
    live = np.array([True, True, True, False])
    jstate = JZ.init_decode_state_paged(jcfg, n_pages, ps)
    state = Z.init_decode_state_paged(cfg, n_pages, ps, device="cpu")
    jdec, dec = jax.jit(JZ.make_decode_fn(jcfg)), Z.make_decode_fn(cfg)
    for t, tok in enumerate(toks):
        pos = pos0 + t
        jlog, jstate = jdec(jparams, {"tokens": jnp.asarray(tok), "page_table": jnp.asarray(table),
                                      "live": jnp.asarray(live)}, jstate, jnp.asarray(pos))
        with torch.no_grad():
            logits, state = dec(params, {"tokens": torch.from_numpy(tok),
                                         "page_table": torch.from_numpy(table),
                                         "live": torch.from_numpy(live)},
                                state, torch.from_numpy(pos))
        _close(logits, jlog)
    for name in ("pages_k", "pages_v"):
        assert np.array_equal(state[name][0].float().numpy(),
                              np.asarray(jstate[name][0].astype(jnp.float32)))


def test_bulk_prefill_equals_token_by_token_replay_bitwise(model):
    *_, cfg, params = model
    rng = np.random.default_rng(2)
    b, plen, seq = 4, 6, 10
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, size=(b, plen)).astype(np.int32))
    plens = torch.tensor([6, 3, 5, 1], dtype=torch.int32)
    dec = Z.make_decode_fn(cfg)
    with torch.no_grad():
        bulk_logits, bulk = Z.bulk_prefill_from_decode(dec)(
            params, {"tokens": prompts}, Z.init_decode_state(cfg, b, seq, device="cpu"),
            torch.zeros(b, dtype=torch.int32), plens=plens)
        state = Z.init_decode_state(cfg, b, seq, device="cpu")
        per_step = []
        for t in range(plen):
            lg, state = dec(params, {"tokens": prompts[:, t:t + 1]}, state,
                            torch.full((b,), t, dtype=torch.int32))
            per_step.append(lg)
    for name in ("k", "v"):
        assert torch.equal(bulk[name], state[name])
    for row, n in enumerate(plens.tolist()):
        assert torch.equal(bulk_logits[row], per_step[n - 1][row])


def test_decode_rejects_unported_variants(model):
    """The variants once refused now decode: embedding inputs (the same
    params, the embedded tokens in: the token path's logits bitwise) and
    the SSM / hybrid families from their own init; what stays refused is a
    paged state for the recurrent families."""

    import dataclasses

    *_, cfg, params = model
    toks = torch.as_tensor(np.random.default_rng(7).integers(0, cfg.vocab, (2, 3), dtype=np.int32))
    emb_cfg = dataclasses.replace(cfg, embed_inputs=True)
    st_tok = Z.init_decode_state(cfg, 2, 3, device="cpu")
    st_emb = Z.init_decode_state(emb_cfg, 2, 3, device="cpu")
    with torch.no_grad():
        for t in range(3):
            want, _ = Z.make_decode_fn(cfg)(params, {"tokens": toks[:, t:t + 1]}, st_tok, t)
            embeds = params["embed"][toks[:, t:t + 1].long()]
            got, _ = Z.make_decode_fn(emb_cfg)(params, {"embeds": embeds}, st_emb, t)
            assert torch.equal(got, want)
    for rep in ({"family": "ssm"}, {"family": "hybrid"}):
        bad = dataclasses.replace(get_config(ARCH).reduced(), ssm=get_config("mamba2-1.3b").reduced().ssm,
                                  shared_attn_every=2 if rep["family"] == "hybrid" else 0, **rep)
        p = T.init_lm(torch.Generator().manual_seed(0), bad, device="cpu")
        assert set(p["blocks"]) == {"ln", "mamba"} and ("shared" in p) == (rep["family"] == "hybrid")
        state = Z.init_decode_state(bad, 2, 4, device="cpu")
        with torch.no_grad():
            lg, _ = Z.make_decode_fn(bad)(p, {"tokens": toks[:, :1]}, state, 0)
        assert lg.shape == (2, 1, cfg.vocab) and bool(torch.isfinite(lg.float()).all())
        with pytest.raises(ValueError, match="recurrent state has no pages"):
            Z.init_decode_state_paged(bad, 4, 4, device="cpu")
