"""Port vs reference: the full-sequence forward (prefill logits, eval loss).

The reference's parameters (``model_zoo.init_params``) cross over through
``convert.params_from_jax``; tokens and labels are drawn with numpy from a
seed and handed to both packages, on the CPU.  The configs are the
reference's ``reduced()`` ones (4 layers, d 64, 4 query heads of 16), plus
qwen2.5 with its published ``rope_theta`` of 1e6 (``reduced()`` keeps the
default) and a sliding window of 8 on a 24-token sequence.  qwen2.5's qkv
biases are zeros at init, so they are drawn at random here (the same
values on both sides) to carry the bias path.

Tolerances: logits are bf16 (the LM head returns the compute dtype), held
at rtol = atol = 2e-2 as in ``tests/test_backend_parity.py``: the two
frameworks round bf16 products at other places, and four layers of bf16
residual stream carry that into the logits.  The loss is an fp32 mean of
log-softmaxes of those logits; its drift is the mean of theirs, held at
rtol = atol = 1e-3.  The forward against the token-by-token decode is
held at the reference's own 0.15 (``test_prefill_matches_decode_loop``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import model_zoo as JZ

from repro_torch.configs import get_config, reference_fields
from repro_torch.convert import params_from_jax
from repro_torch.models import model_zoo as Z
from repro_torch.models import transformer as T

torch.set_num_threads(1)

LOGIT_TOL = dict(rtol=2e-2, atol=2e-2)
LOSS_TOL = dict(rtol=1e-3, atol=1e-3)
B, S = 2, 24

# (arch, replacements applied to both reduced configs)
CONFIGS = [
    ("internlm2-1.8b", {}),
    ("minitron-4b", {}),
    ("deepseek-7b", {}),
    ("qwen2.5-32b", {}),
    ("qwen2.5-32b", {"rope_theta": 1e6}),
    ("minitron-4b", {"swa_window": 8}),
]
IDS = [arch + "".join(f"-{k}={v}" for k, v in rep.items()) for arch, rep in CONFIGS]


def _model(arch, rep, seed=0):
    jcfg = dataclasses.replace(jax_config(arch).reduced(), **rep)
    cfg = dataclasses.replace(get_config(arch).reduced(), **rep)
    jparams = JZ.init_params(jax.random.PRNGKey(seed), jcfg)
    if jcfg.qkv_bias:
        rng = np.random.default_rng(seed)
        attn = dict(jparams["blocks"]["attn"])
        for name in ("bq", "bk", "bv"):
            attn[name] = jnp.asarray(rng.normal(scale=0.5, size=attn[name].shape), jnp.float32)
        jparams = dict(jparams, blocks=dict(jparams["blocks"], attn=attn))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def _tokens(cfg, seed, b=B, s=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, size=(b, s)).astype(np.int32)
    return toks, labels


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("arch,rep", CONFIGS, ids=IDS)
def test_forward_logits_and_loss_match_reference(arch, rep):
    jcfg, jparams, cfg, params = _model(arch, rep)
    toks, labels = _tokens(cfg, seed=len(arch))
    jlogits = jax.jit(JZ.make_prefill_fn(jcfg))(jparams, {"tokens": jnp.asarray(toks)})
    logits = Z.make_prefill_fn(cfg)(params, {"tokens": torch.from_numpy(toks)})
    assert logits.dtype == torch.bfloat16 and tuple(logits.shape) == (B, S, cfg.vocab)
    np.testing.assert_allclose(_np(logits), _np(jlogits), **LOGIT_TOL)

    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    jloss, jmetrics = jax.jit(JZ.make_loss_fn(jcfg))(jparams, jbatch)
    loss, metrics = Z.make_loss_fn(cfg)(params, {"tokens": torch.from_numpy(toks),
                                                 "labels": torch.from_numpy(labels)})
    assert loss.dtype == torch.float32 and not loss.requires_grad
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    np.testing.assert_allclose(float(metrics["ce"]), float(jmetrics["ce"]), **LOSS_TOL)
    assert float(metrics["aux"]) == float(jmetrics["aux"]) == 0.0


def test_masked_loss_and_cross_entropy_match_reference():
    from repro.models import transformer as JT

    jcfg, jparams, cfg, params = _model("minitron-4b", {})
    toks, labels = _tokens(cfg, seed=5)
    mask = np.random.default_rng(6).random((B, S)) < 0.6
    jloss, _ = jax.jit(JZ.make_loss_fn(jcfg))(jparams, {
        "tokens": jnp.asarray(toks), "labels": jnp.asarray(labels), "mask": jnp.asarray(mask)})
    loss, _ = Z.make_loss_fn(cfg)(params, {
        "tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels),
        "mask": torch.from_numpy(mask)})
    np.testing.assert_allclose(float(loss), float(jloss), **LOSS_TOL)
    # cross_entropy alone, on equal bf16 logits: the gather reads the
    # element the reference's one-hot sum keeps, so only the exp-sum's
    # order differs.
    logits = np.random.default_rng(7).normal(size=(B, S, cfg.vocab)).astype(np.float32)
    jce = JT.cross_entropy(jnp.asarray(logits, jnp.bfloat16), jnp.asarray(labels),
                           jnp.asarray(mask))
    ce = T.cross_entropy(torch.from_numpy(logits).bfloat16(), torch.from_numpy(labels),
                         torch.from_numpy(mask))
    np.testing.assert_allclose(float(ce), float(jce), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ["deepseek-7b", "minitron-4b"])
def test_prefill_matches_decode_loop(arch):
    """Decoding token by token reproduces the full-sequence forward (the
    port's counterpart of the reference's test of the same name)."""

    *_, cfg, params = _model(arch, {})
    s = 8
    toks, _ = _tokens(cfg, seed=3, b=1, s=s)
    tokens = torch.from_numpy(toks)
    full = Z.make_prefill_fn(cfg)(params, {"tokens": tokens})
    state = Z.init_decode_state(cfg, 1, s, device="cpu")
    decode = Z.make_decode_fn(cfg)
    outs = []
    with torch.no_grad():
        for t in range(s):
            lg, state = decode(params, {"tokens": tokens[:, t:t + 1]}, state, t)
            outs.append(lg)
    steps = torch.cat(outs, dim=1)
    np.testing.assert_allclose(_np(steps), _np(full), rtol=0.15, atol=0.15)
    assert torch.equal(steps.float().argmax(-1), full.float().argmax(-1))


@pytest.mark.parametrize("arch", ["deepseek-7b", "minitron-4b", "qwen2.5-32b"])
def test_dense_configs_match_reference(arch):
    full, jfull = get_config(arch), jax_config(arch)
    assert reference_fields(vars(full)) == vars(jfull)
    cfg, jcfg = get_config(arch).reduced(), jax_config(arch).reduced()
    assert reference_fields(vars(cfg)) == vars(jcfg)
    assert (cfg.qkv_bias, cfg.rope_theta, cfg.swa_window) == (full.qkv_bias, 10000.0, None)


def test_params_from_jax_keeps_qwen_biases_fp32():
    _, jparams, cfg, params = _model("qwen2.5-32b", {})
    attn = params["blocks"]["attn"]
    hq, hkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    for name, width in (("bq", hq), ("bk", hkv), ("bv", hkv)):
        assert attn[name].dtype == torch.float32 and tuple(attn[name].shape) == (cfg.n_layers, width)
        assert np.array_equal(attn[name].numpy(), np.asarray(jparams["blocks"]["attn"][name]))
    assert attn["wq"].dtype == torch.bfloat16


def test_forward_rejects_unported_families():
    """The SSM and hybrid families once refused now run their forward from
    their own init (the Mamba2 layer body, the hybrid's groups); a block
    kind no family has is still refused."""

    *_, cfg, _ = _model("minitron-4b", {})
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab, (1, 8), dtype=np.int32))
    ssm = get_config("mamba2-1.3b").reduced().ssm
    for rep in ({"family": "ssm"}, {"family": "hybrid", "shared_attn_every": 2}):
        mcfg = dataclasses.replace(cfg, ssm=ssm, **rep)
        params = T.init_lm(torch.Generator().manual_seed(0), mcfg, device="cpu")
        logits, aux = T.forward_lm(params, mcfg, {"tokens": toks})
        assert logits.shape == (1, 8, cfg.vocab) and bool(torch.isfinite(logits.float()).all())
        assert float(aux) == 0.0
    body = T._layer_fn(mcfg, "mamba", None)
    x = torch.zeros((1, 8, cfg.d_model), dtype=torch.bfloat16)
    p = T.layer_params(T.init_lm(torch.Generator().manual_seed(0), mcfg, device="cpu")["blocks"], 0)
    out, aux = body(x, T._cast_params(p))
    assert out.shape == x.shape and aux == 0.0
    with pytest.raises(ValueError, match="conv"):
        T._layer_fn(cfg, "conv", None)(x, p)


def test_score_cli_runs_the_forward_on_the_cpu():
    from repro_torch.launch import score as SC

    jcfg, jparams, cfg, params = _model("minitron-4b", {})
    args = SC.build_parser().parse_args(["--arch", "minitron-4b", "--reduced", "--device", "cpu",
                                         "--batch", "2", "--seq-len", "16", "--seed", "4"])
    summary = SC.score(args, params=params)
    assert summary["logits"] == [2, 16, cfg.vocab] and summary["device"] == "cpu"
    assert summary["attn_backend"] == "flash_attn_torch" and summary["exec_backend"] == "matmul"
    toks = np.random.default_rng(4).integers(0, cfg.vocab, size=(2, 17), dtype=np.int32)
    jloss, _ = jax.jit(JZ.make_loss_fn(jcfg))(jparams, {"tokens": jnp.asarray(toks[:, :-1]),
                                                         "labels": jnp.asarray(toks[:, 1:])})
    np.testing.assert_allclose(summary["loss"], float(jloss), **LOSS_TOL)
    assert SC.main(["--arch", "deepseek-7b", "--reduced", "--device", "cpu", "--seq-len", "8"])["logits"] \
        == [2, 8, 256]
