"""Port vs reference: the encoder-decoder (whisper-small) and the
embedding-input (pixtral-12b) forwards, and the params carried across.

The reference's parameters (``model_zoo.init_params``) cross over through
``convert.params_from_jax``; frames, embeddings, tokens and labels are
drawn with numpy from a seed and handed to both packages, on the CPU.  The
configs are the reference's ``reduced()`` ones: whisper at 2 encoder and 4
decoder layers, d 64, 4 heads of 16, 16 encoder frames; pixtral at 4
layers, d 64, 4/2 heads of 16, embeddings in.  The reference's outputs are
built once per module.

Tolerances: bf16 outputs and logits at rtol = atol = 2e-2 and the loss at
1e-3, as ``tests/test_torch_forward.py`` holds them.  The fp32 pieces on
fp32 inputs (the layer norm, the sinusoid table) at rtol = atol = 1e-5:
the same arithmetic, where only the order of fp32 sums may differ (the
table is computed in float64 numpy in both, so it is equal).  The
self-attention cache after the decode steps: layer 0's at 2e-2, every
layer's in L2 within ``STATE_REL`` = 2e-2 of its norm (the bf16 residual
stream carries the frameworks' rounding into the later layers' K, where a
few small elements move by more than 2e-2 of themselves).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import encdec as JE
from repro.models import layers as JL
from repro.models import model_zoo as JZ

from repro_torch.configs import get_config
from repro_torch.convert import FP32_LEAVES, params_from_jax
from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes
from repro_torch.launch import score as SC
from repro_torch.launch import serve
from repro_torch.models import encdec as E
from repro_torch.models import layers as L
from repro_torch.models import model_zoo as Z
from repro_torch.runtime.serving import ServingEngine

torch.set_num_threads(1)

TOL = dict(rtol=2e-2, atol=2e-2)
LOSS_TOL = dict(rtol=1e-3, atol=1e-3)
FP32_TOL = dict(rtol=1e-5, atol=1e-5)
STATE_REL = 2e-2
B, S = 2, 12


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.array(x, np.float32)).to(dtype)


def _j(x, dtype=jnp.float32):
    return jnp.asarray(np.asarray(x, np.float32), dtype)


def _model(arch):
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    jparams = JZ.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, jparams, cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")


def _dec_layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


@pytest.fixture(scope="module")
def whisper():
    """Reduced whisper in both packages, a batch, and the reference's
    forward, loss, encoder output, cross K/V and decode steps."""

    jcfg, jparams, cfg, params = _model("whisper-small")
    rng = np.random.default_rng(0)
    frames = rng.normal(size=(B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jb = {"frames": _j(frames, jnp.bfloat16), "tokens": jnp.asarray(toks),
          "labels": jnp.asarray(labels)}
    want = {"logits": _np(jax.jit(JZ.make_prefill_fn(jcfg))(jparams, jb)),
            "loss": float(jax.jit(JZ.make_loss_fn(jcfg))(jparams, jb)[0]),
            "enc": _np(JE.encode(jparams, jcfg, jb["frames"]))}
    state = JZ.init_decode_state(jcfg, B, S)
    enc_out = JE.encode(jparams, jcfg, jb["frames"])
    xcfg = JE._acfg(jcfg, causal=False)
    ks, vs = zip(*(JL.encode_cross_kv(_dec_layer(jparams["dec_blocks"], i)["xkv"], enc_out, xcfg)
                   for i in range(jcfg.n_layers)))
    state = dict(state, cross_k=jnp.stack(ks), cross_v=jnp.stack(vs))
    want["cross_k"], want["cross_v"] = _np(state["cross_k"]), _np(state["cross_v"])
    dec = jax.jit(JZ.make_decode_fn(jcfg))
    steps = []
    for t in range(S):
        pos = jnp.full((B,), t, jnp.int32) if t % 2 else jnp.int32(t)  # vector and scalar
        lg, state = dec(jparams, {"tokens": jb["tokens"][:, t:t + 1]}, state, pos)
        steps.append(_np(lg))
    want["decode"] = np.concatenate(steps, axis=1)
    want["self_k"] = _np(state["k"])
    return {"jcfg": jcfg, "jparams": jparams, "cfg": cfg, "params": params, "frames": frames,
            "toks": toks, "labels": labels, "want": want}


# ---------------------------------------------------------------------------
# The enc-dec's layers, on random inputs
# ---------------------------------------------------------------------------


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(1)
    x, w, b = rng.normal(size=(3, 5, 32)), rng.normal(size=32), rng.normal(size=32)
    np.testing.assert_allclose(_np(L.layer_norm(_t(x), _t(w), _t(b))),
                               _np(JL.layer_norm(_j(x), _j(w), _j(b))), **FP32_TOL)
    got = L.layer_norm(_t(x, torch.bfloat16), _t(w), _t(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(JL.layer_norm(_j(x, jnp.bfloat16), _j(w), _j(b))), **TOL)


def test_apply_mlp_matches_reference():
    rng = np.random.default_rng(2)
    jp = JL.init_mlp(jax.random.PRNGKey(0), 32, 64)
    jp = dict(jp, b1=_j(rng.normal(size=64)), b2=_j(rng.normal(size=32)))
    tp = params_from_jax(jax.tree.map(np.asarray, {"mlp": jp}), get_config("whisper-small"),
                         device="cpu")["mlp"]
    assert tp["w1"].dtype == torch.bfloat16 and tp["b1"].dtype == torch.float32
    x = rng.normal(size=(2, 5, 32))
    np.testing.assert_allclose(_np(L.apply_mlp(tp, _t(x, torch.bfloat16))),
                               _np(JL.apply_mlp(jp, _j(x, jnp.bfloat16))), **TOL)


@pytest.mark.parametrize("s, d", [(16, 64), (1500, 768), (7, 10)])
def test_sinusoidal_positions_equal_reference(s, d):
    got = L.sinusoidal_positions(s, d)
    assert got.dtype == torch.float32 and got.shape == (s, d)
    assert np.array_equal(_np(got), _np(JL.sinusoidal_positions(s, d)))


def test_cross_attention_matches_reference():
    cfg = get_config("whisper-small").reduced()
    jcfg = JE._acfg(jax_config("whisper-small").reduced(), causal=False)
    acfg = E._acfg(cfg, causal=False)
    jp = JL.init_attention(jax.random.PRNGKey(3), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, {"xattn": jp}), cfg, device="cpu")["xattn"]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, cfg.d_model))
    ek = rng.normal(size=(2, 16, cfg.n_kv_heads, cfg.head_dim))
    ev = rng.normal(size=(2, 16, cfg.n_kv_heads, cfg.head_dim))
    want = JL.cross_attention(jp, _j(x, jnp.bfloat16), _j(ek, jnp.bfloat16), _j(ev, jnp.bfloat16), jcfg)
    got = L.cross_attention(tp, _t(x, torch.bfloat16), _t(ek, torch.bfloat16), _t(ev, torch.bfloat16), acfg)
    assert got.shape == (2, 5, cfg.d_model) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


# ---------------------------------------------------------------------------
# whisper-small, reduced
# ---------------------------------------------------------------------------


def test_encode_matches_reference(whisper):
    cfg, params, want = whisper["cfg"], whisper["params"], whisper["want"]
    got = E.encode(params, cfg, _t(whisper["frames"], torch.bfloat16))
    assert got.shape == (B, cfg.enc_frames, cfg.d_model) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), want["enc"], **TOL)


def test_forward_and_loss_match_reference(whisper):
    cfg, params, want = whisper["cfg"], whisper["params"], whisper["want"]
    batch = {"frames": _t(whisper["frames"], torch.bfloat16), "tokens": torch.as_tensor(whisper["toks"])}
    logits = Z.make_prefill_fn(cfg)(params, batch)
    assert logits.shape == (B, S, cfg.vocab) and logits.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(logits), want["logits"], **TOL)
    loss, metrics = Z.make_loss_fn(cfg)(params, dict(batch, labels=torch.as_tensor(whisper["labels"])))
    np.testing.assert_allclose(float(loss), want["loss"], **LOSS_TOL)
    assert float(metrics["aux"]) == 0.0


def test_decode_step_with_the_reference_state(whisper):
    """The port's decode on the reference's cross K/V, scalar and vector
    positions in turn, against the reference's steps; and against the
    port's own forward at those positions."""

    cfg, params, want = whisper["cfg"], whisper["params"], whisper["want"]
    state = Z.init_decode_state(cfg, B, S, device="cpu")
    assert set(state) == {"k", "v", "cross_k", "cross_v"}
    assert state["cross_k"].shape == (cfg.n_layers, B, cfg.enc_frames, cfg.n_kv_heads, cfg.head_dim)
    state["cross_k"].copy_(_t(want["cross_k"], torch.bfloat16))
    state["cross_v"].copy_(_t(want["cross_v"], torch.bfloat16))
    toks = torch.as_tensor(whisper["toks"])
    dec = Z.make_decode_fn(cfg)
    steps = []
    with torch.no_grad():
        for t in range(S):
            pos = torch.full((B,), t, dtype=torch.int32) if t % 2 else t
            lg, out = dec(params, {"tokens": toks[:, t:t + 1]}, state, pos)
            assert out is state and lg.shape == (B, 1, cfg.vocab)  # repro_torch: noqa=RPR001 -- checks the step updated the state in place
            steps.append(lg)
    got = torch.cat(steps, 1)
    np.testing.assert_allclose(_np(got), want["decode"], **TOL)
    np.testing.assert_allclose(_np(state["k"][0]), want["self_k"][0], **TOL)
    for layer in range(cfg.n_layers):
        err = np.linalg.norm(_np(state["k"][layer]) - want["self_k"][layer])
        assert err <= STATE_REL * np.linalg.norm(want["self_k"][layer]), layer
    forward = Z.make_prefill_fn(cfg)(params, {"frames": _t(whisper["frames"], torch.bfloat16),
                                              "tokens": toks})
    np.testing.assert_allclose(_np(got), _np(forward), **TOL)


def test_cross_kv_from_the_port_encoder(whisper):
    cfg, params, want = whisper["cfg"], whisper["params"], whisper["want"]
    enc = E.encode(params, cfg, _t(whisper["frames"], torch.bfloat16))
    xcfg = E._acfg(cfg, causal=False)
    for i in range(cfg.n_layers):
        xkv = {k: v[i] for k, v in params["dec_blocks"]["xkv"].items()}
        k, v = L.encode_cross_kv(xkv, enc, xcfg)
        np.testing.assert_allclose(_np(k), want["cross_k"][i], **TOL)
        np.testing.assert_allclose(_np(v), want["cross_v"][i], **TOL)


# ---------------------------------------------------------------------------
# pixtral-12b, reduced: embeddings in
# ---------------------------------------------------------------------------


def test_embeds_forward_loss_and_decode_match_reference():
    jcfg, jparams, cfg, params = _model("pixtral-12b")
    assert cfg.embed_inputs and "embed" not in params and "embed" not in jparams
    rng = np.random.default_rng(4)
    emb = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jb = {"embeds": _j(emb, jnp.bfloat16), "labels": jnp.asarray(labels)}
    tb = {"embeds": _t(emb, torch.bfloat16), "labels": torch.as_tensor(labels)}
    want = _np(jax.jit(JZ.make_prefill_fn(jcfg))(jparams, {"embeds": jb["embeds"]}))
    np.testing.assert_allclose(_np(Z.make_prefill_fn(cfg)(params, {"embeds": tb["embeds"]})), want, **TOL)
    np.testing.assert_allclose(float(Z.make_loss_fn(cfg)(params, tb)[0]),
                               float(jax.jit(JZ.make_loss_fn(jcfg))(jparams, jb)[0]), **LOSS_TOL)
    jstate, state = JZ.init_decode_state(jcfg, B, S), Z.init_decode_state(cfg, B, S, device="cpu")
    dec, jdec = Z.make_decode_fn(cfg), jax.jit(JZ.make_decode_fn(jcfg))
    with torch.no_grad():
        for t in range(4):
            jl, jstate = jdec(jparams, {"embeds": jb["embeds"][:, t:t + 1]}, jstate, jnp.int32(t))
            lg, _ = dec(params, {"embeds": tb["embeds"][:, t:t + 1]}, state, t)
            np.testing.assert_allclose(_np(lg), _np(jl), **TOL)
            np.testing.assert_allclose(_np(lg[:, 0]), want[:, t], **TOL)


# ---------------------------------------------------------------------------
# The params carried across, the CLIs and the refusals
# ---------------------------------------------------------------------------


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b", "whisper-small", "pixtral-12b",
                                  "qwen2-moe-a2.7b"])
def test_params_from_jax_keeps_the_fp32_leaves(arch):
    """Every leaf the reference uses in fp32 stays fp32 and equal; every
    leaf it casts to bf16 at use is bf16 (the same values rounded)."""

    jcfg, jparams, cfg, params = _model(arch)
    want = dict(_leaves(jax.tree.map(np.asarray, jparams)))
    got = dict(_leaves(params))
    assert set(got) == set(want)
    keep = FP32_LEAVES[cfg.family]
    n_fp32 = 0
    for path, leaf in got.items():
        ref = want[path]
        if path[-1] in keep:
            n_fp32 += 1
            assert leaf.dtype == torch.float32, path
            assert np.array_equal(leaf.numpy(), ref), path
        else:
            assert leaf.dtype == torch.bfloat16, path
            assert torch.equal(leaf, torch.from_numpy(np.array(ref, np.float32)).to(torch.bfloat16)), path
    fp32 = {"ssm": {"ln", "conv_w_x", "conv_b_x", "conv_w_bc", "conv_b_bc", "dt_bias", "A_log",
                    "D", "norm_w", "final_norm"},
            "encdec": {"ln1_w", "ln1_b", "lnx_w", "lnx_b", "ln2_w", "ln2_b", "enc_ln_w",
                       "enc_ln_b", "dec_ln_w", "dec_ln_b", "b1", "b2"}}
    seen = {p[-1] for p, leaf in got.items() if leaf.dtype == torch.float32}
    family = "ssm" if cfg.family == "hybrid" else cfg.family
    if family in fp32:
        assert fp32[family] <= seen, sorted(fp32[family] - seen)
    assert n_fp32 > 0


@pytest.mark.parametrize("arch", ["whisper-small", "pixtral-12b"])
def test_score_cli_takes_frames_and_embeddings(arch):
    jcfg, jparams, cfg, params = _model(arch)
    args = SC.build_parser().parse_args(["--arch", arch, "--reduced", "--device", "cpu",
                                         "--batch", "2", "--seq-len", "8", "--seed", "5"])
    summary = SC.score(args, params=params)
    assert summary["logits"] == [2, 8, cfg.vocab] and summary["device"] == "cpu"
    batch, labels = SC.make_batch(cfg, 2, 8, 5, torch.device("cpu"))
    assert set(batch) == ({"frames", "tokens"} if cfg.family == "encdec" else {"embeds"})
    if cfg.family == "encdec":
        assert batch["frames"].shape == (2, cfg.enc_frames, cfg.d_model)
    jb = {k: jnp.asarray(_np(v), jnp.bfloat16) if v.is_floating_point() else jnp.asarray(v.numpy())
          for k, v in dict(batch, labels=labels).items()}
    jloss, _ = jax.jit(JZ.make_loss_fn(jcfg))(jparams, jb)
    np.testing.assert_allclose(summary["loss"], float(jloss), **LOSS_TOL)


@pytest.mark.parametrize("arch", ["whisper-small", "pixtral-12b"])
def test_serving_refuses_encdec_and_embedding_inputs(arch):
    *_, cfg, params = _model(arch)
    with pytest.raises(SystemExit, match="serving demo targets token-in archs"):
        serve.main(["--device", "cpu", "--arch", arch, "--reduced"])
    mesh = AsymmetricMesh(biglittle_classes(chips_per_pod=1), batch_tile=1)
    with pytest.raises(ValueError, match="targets token-in archs"):
        ServingEngine(cfg, params, mesh, seq_cap=8, device="cpu")
    with pytest.raises(ValueError, match="bulk prefill needs a token-in batch"):
        Z.make_prefill_fn(cfg, with_cache=True)(params, {"embeds": torch.zeros(1, 2, cfg.d_model)},
                                                 Z.init_decode_state(cfg, 1, 4, device="cpu"), 0)
    if cfg.family == "encdec":
        with pytest.raises(ValueError, match="encdec cross-KV"):
            Z.init_decode_state_paged(cfg, 4, 4, device="cpu")
