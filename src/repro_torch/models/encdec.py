"""Whisper-style encoder-decoder backbone (the port's
``repro.models.encdec``).

The conv audio frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, S_enc, d_model).  Pre-LN transformer with
sinusoidal positions, multi-head attention without RoPE, GELU MLPs; the
output projection is the decoder's token embedding, transposed (tied, as
in Whisper).  Layer params are stacked along a leading axis and looped
over, as in :mod:`repro_torch.models.transformer`: the forward takes the
layers out of the stacks by one ``unbind`` and may recompute them in the
backward (training attends through ``chunked_attention``, as the
reference does: ``flash_attention_cuda`` has no backward).

Decode: a self-attention KV cache of ``seq_len`` per layer, written in
place, plus cross-attention K/V computed once from the encoder output
(``enc_frames`` positions), which the caller fills
(``layers.encode_cross_kv`` of :func:`encode`'s output).
"""

from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.transformer import _remat, _unstack, cross_entropy, layer_params


def _acfg(cfg: ArchConfig, causal: bool) -> L.AttnConfig:
    return L.AttnConfig(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.head_dim,
        causal=causal,
        use_rope=False,
    )


def _stack(blocks: list) -> dict:
    if isinstance(blocks[0], dict):
        return {k: _stack([b[k] for b in blocks]) for k in blocks[0]}
    return torch.stack(blocks)


def init_encdec(generator, cfg: ArchConfig, *, device, dtype=L.COMPUTE_DTYPE) -> dict:
    """Random params at the reference's scales; projections and ``embed``
    in ``dtype``, the layer norms' weights and biases and the MLP biases
    fp32."""

    d = cfg.d_model
    ones = lambda: torch.ones((d,), dtype=L.PARAM_DTYPE, device=device)  # noqa: E731
    zeros = lambda: torch.zeros((d,), dtype=L.PARAM_DTYPE, device=device)  # noqa: E731
    attn = lambda causal: L.init_attention(generator, _acfg(cfg, causal), device=device,  # noqa: E731
                                           dtype=dtype)
    mlp = lambda: L.init_mlp(generator, d, cfg.d_ff, device=device, dtype=dtype)  # noqa: E731
    enc = [{"ln1_w": ones(), "ln1_b": zeros(), "attn": attn(False),
            "ln2_w": ones(), "ln2_b": zeros(), "mlp": mlp()} for _ in range(cfg.enc_layers)]
    dec = [{"ln1_w": ones(), "ln1_b": zeros(), "attn": attn(True),
            "lnx_w": ones(), "lnx_b": zeros(), "xattn": attn(False),
            "xkv": L.init_cross_kv(generator, _acfg(cfg, False), device=device, dtype=dtype),
            "ln2_w": ones(), "ln2_b": zeros(), "mlp": mlp()} for _ in range(cfg.n_layers)]
    return {
        "enc_blocks": _stack(enc),
        "dec_blocks": _stack(dec),
        "embed": L.embed_init(generator, (cfg.vocab, d), device=device, dtype=dtype),
        "enc_ln_w": ones(), "enc_ln_b": zeros(),
        "dec_ln_w": ones(), "dec_ln_b": zeros(),
    }


def _enc_layer(cfg: ArchConfig, attn_backend: str):
    acfg = _acfg(cfg, causal=False)

    def f(x, p):
        h, _ = L.apply_attention(p["attn"], L.layer_norm(x, p["ln1_w"], p["ln1_b"]), acfg,
                                 backend=attn_backend)
        x = x + h
        return x + L.apply_mlp(p["mlp"], L.layer_norm(x, p["ln2_w"], p["ln2_b"]))

    return f


def _dec_layer(cfg: ArchConfig, enc_out, attn_backend: str):
    acfg, xcfg = _acfg(cfg, causal=True), _acfg(cfg, causal=False)

    def f(x, p):
        h, _ = L.apply_attention(p["attn"], L.layer_norm(x, p["ln1_w"], p["ln1_b"]), acfg,
                                 backend=attn_backend)
        x = x + h
        ek, ev = L.encode_cross_kv(p["xkv"], enc_out, xcfg)
        x = x + L.cross_attention(p["xattn"], L.layer_norm(x, p["lnx_w"], p["lnx_b"]), ek, ev,
                                  xcfg, backend=attn_backend)
        return x + L.apply_mlp(p["mlp"], L.layer_norm(x, p["ln2_w"], p["ln2_b"]))

    return f


def encode(params, cfg: ArchConfig, frames, *, attn_backend: str = "auto", remat: bool = False):
    """frames: (B, S_enc, D) stub embeddings -> encoder states (bf16).
    ``remat`` recomputes each layer in the backward."""

    s = frames.shape[1]
    pe = L.sinusoidal_positions(s, cfg.d_model, device=frames.device).to(L.COMPUTE_DTYPE)
    x = frames.to(L.COMPUTE_DTYPE) + pe
    body = _enc_layer(cfg, attn_backend)
    if remat:
        body = _remat(body)
    for p in _unstack(params["enc_blocks"], cfg.enc_layers):
        x = body(x, p)
    return L.layer_norm(x, params["enc_ln_w"], params["enc_ln_b"])


def _head(params, x):
    """The tied output projection: ``x · embed^T``."""

    return ops.gemm(x, params["embed"].T.to(L.COMPUTE_DTYPE))


def forward_encdec(params, cfg: ArchConfig, batch, *, attn_backend: str = "auto",
                   remat: bool = False):
    """batch: ``{"frames": (B, Se, D), "tokens": (B, Sd)}`` -> ``(logits
    (B, Sd, V) bf16, aux 0)``.  ``params`` may be fp32 masters, cast at
    each use as the reference casts them.  The encoder's layers are always
    under ``checkpoint``, as the reference's are (where autograd records
    nothing it only calls them); ``remat`` recomputes the decoder's."""

    enc_out = encode(params, cfg, batch["frames"], attn_backend=attn_backend, remat=True)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    x = params["embed"][tokens.long()].to(L.COMPUTE_DTYPE)
    x = x + L.sinusoidal_positions(s, cfg.d_model, device=x.device).to(L.COMPUTE_DTYPE)
    body = _dec_layer(cfg, enc_out, attn_backend)
    if remat:
        body = _remat(body)
    for p in _unstack(params["dec_blocks"], cfg.n_layers):
        x = body(x, p)
    x = L.layer_norm(x, params["dec_ln_w"], params["dec_ln_b"])
    return _head(params, x), torch.zeros((), dtype=torch.float32, device=x.device)


def init_decode_state(cfg: ArchConfig, batch: int, seq_len: int, *, device):
    """Self-attention cache ``k``/``v`` (L, B, seq_len, Hkv, Dh) and the
    cross K/V ``cross_k``/``cross_v`` (L, B, enc_frames, Hkv, Dh), bf16,
    zeros."""

    ll, hkv, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    z = lambda s: torch.zeros((ll, batch, s, hkv, dh), dtype=L.COMPUTE_DTYPE, device=device)  # noqa: E731
    return {"k": z(seq_len), "v": z(seq_len), "cross_k": z(cfg.enc_frames),
            "cross_v": z(cfg.enc_frames)}


def _positions_at(pos, b: int, d: int, device) -> torch.Tensor:
    """The sinusoid at one position per row, in fp32 from the position (the
    reference's traced form, not the forward's float64 table): (B, 1, D)
    for a (B,) ``pos``, (1, 1, D) for a scalar."""

    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)
    inv = torch.pow(torch.tensor(10000.0, dtype=torch.float32, device=device), dim / d)
    ang = (pos[:, None] if pos.ndim else pos[None, None]).float() / inv[None, :]
    pe = torch.zeros((ang.shape[0], d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe[:, None]


def decode_step(params, cfg: ArchConfig, batch, state, pos):
    """One decoder token against its self-attention cache (written in
    place) and the fixed cross K/V.  batch: ``{"tokens": (B, 1)}`` plus
    optionally ``"live"`` (B,) bool; pos: a scalar or (B,) positions.
    Returns ``(logits (B, 1, V) bf16, state)``."""

    tokens = batch["tokens"]
    x = params["embed"][tokens.long()].to(L.COMPUTE_DTYPE)
    x = x + _positions_at(pos, tokens.shape[0], cfg.d_model, x.device).to(L.COMPUTE_DTYPE)
    acfg, xcfg = _acfg(cfg, causal=True), _acfg(cfg, causal=False)
    live = batch.get("live")
    for i in range(cfg.n_layers):
        p = layer_params(params["dec_blocks"], i)
        h, _ = L.decode_attention(p["attn"], L.layer_norm(x, p["ln1_w"], p["ln1_b"]), acfg,
                                  state["k"][i], state["v"][i], pos, live=live)
        x = x + h
        x = x + L.cross_attention(p["xattn"], L.layer_norm(x, p["lnx_w"], p["lnx_b"]),
                                  state["cross_k"][i], state["cross_v"][i], xcfg)
        x = x + L.apply_mlp(p["mlp"], L.layer_norm(x, p["ln2_w"], p["ln2_b"]))
    x = L.layer_norm(x, params["dec_ln_w"], params["dec_ln_b"])
    return _head(params, x), state


def loss_fn(params, cfg: ArchConfig, batch, *, attn_backend: str = "auto", remat: bool = False):
    """``(loss, {"ce", "aux"})`` of the forward's logits against
    ``batch["labels"]`` (optionally weighted by ``batch["mask"]``)."""

    logits, aux = forward_encdec(params, cfg, batch, attn_backend=attn_backend, remat=remat)
    ce = cross_entropy(logits, batch["labels"], batch.get("mask"))
    return ce + aux, {"ce": ce, "aux": aux}


__all__ = [
    "decode_step",
    "encode",
    "forward_encdec",
    "init_decode_state",
    "init_encdec",
    "loss_fn",
]
