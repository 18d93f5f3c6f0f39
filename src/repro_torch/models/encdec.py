"""Whisper-style encoder-decoder backbone (the port's
``repro.models.encdec``).

The conv audio frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, S_enc, d_model).  Pre-LN transformer with
sinusoidal positions, multi-head attention without RoPE, GELU MLPs; the
output projection is the decoder's token embedding, transposed (tied, as
in Whisper).  Layer params are stacked along a leading axis and looped
over, as in :mod:`repro_torch.models.transformer`: the forward takes the
layers out of the stacks by one ``unbind`` and may recompute them in the
backward (training attends by ``"auto"``, as the forward does: the flash
kernels and their backward on a card, ``chunked_attention`` on the CPU).

Decode: a self-attention KV cache of ``seq_len`` per layer, written in
place, plus cross-attention K/V computed once from the encoder output
(``enc_frames`` positions), which the caller fills
(``layers.encode_cross_kv`` of :func:`encode`'s output).
"""

from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import spmd
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
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
    return T.tied_head(params, x), torch.zeros((), dtype=torch.float32, device=x.device)


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
    return T.tied_head(params, x), state


def loss_fn(params, cfg: ArchConfig, batch, *, attn_backend: str = "auto", remat: bool = False):
    """``(loss, {"ce", "aux"})`` of the forward's logits against
    ``batch["labels"]`` (optionally weighted by ``batch["mask"]``)."""

    logits, aux = forward_encdec(params, cfg, batch, attn_backend=attn_backend, remat=remat)
    ce = cross_entropy(logits, batch["labels"], batch.get("mask"))
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# A rank's part on a (data, model) mesh
# ---------------------------------------------------------------------------
#
# The reference's rules: the attention projections (the cross K/V's too)
# column- / row-parallel with their biases on the rank's features
# (``b1`` too), ``b2`` and the layer norms replicated, the tied ``embed``
# vocab-parallel where ``model`` divides the vocab and replicated where
# not (whisper-small's 51,865).  Each stream (the encoder's, the
# decoder's) is batch-sharded over the dp axes and, under ``seq_shard``,
# sequence-sharded over ``model``, as ``constrain_batch`` pins it
# (``src/repro/models/encdec.py:83, :109, :135``).


def _split_pe(pe, lay, seq: bool):
    return T._seq_local(pe[None], lay, seq)


def _norm(x, p, w: str, b: str, lay, seq: bool):
    return L.layer_norm(x, spmd.norm_weight(p[w], lay, seq), spmd.norm_weight(p[b], lay, seq))


def _cross(p, sp):
    """The cross-attention's params as :func:`layers.apply_attention_tp`
    takes them: the query's ``xattn`` and the cross ``xkv`` K/V."""

    return ({"wq": p["xattn"]["wq"], "wo": p["xattn"]["wo"], **p["xkv"]},
            {"wq": sp["xattn"]["wq"], "wo": sp["xattn"]["wo"], **sp["xkv"]})


def encode_sharded(params, cfg: ArchConfig, frames, lay, *, attn_backend: str = "auto"):
    """:func:`encode` as a rank's part: ``(enc_out, seq)``, the encoder's
    states of this rank's rows in the residual layout (``seq``: its
    positions split over ``model``).  Always under ``checkpoint``, as the
    reference's encoder is."""

    b, s = frames.shape[:2]
    seq = lay.seq_sharded((b, s, cfg.d_model))
    pe = L.sinusoidal_positions(s, cfg.d_model, device=frames.device).to(L.COMPUTE_DTYPE)
    x = T._seq_local(frames.to(L.COMPUTE_DTYPE), lay, seq) + _split_pe(pe, lay, seq)
    acfg = _acfg(cfg, causal=False)
    specs = spmd.layer_specs(lay.specs["enc_blocks"])

    def body(x, p):
        h = L.apply_attention_tp(p["attn"], specs["attn"], _norm(x, p, "ln1_w", "ln1_b", lay, seq),
                                 acfg, lay, positions=None, seq=seq, backend=attn_backend)
        x = x + h
        return x + L.apply_mlp_tp(p["mlp"], specs["mlp"], _norm(x, p, "ln2_w", "ln2_b", lay, seq),
                                  lay, seq=seq)

    body = _remat(body)
    for p in _unstack(params["enc_blocks"], cfg.enc_layers):
        x = body(x, p)
    return _norm(x, params, "enc_ln_w", "enc_ln_b", lay, seq), seq


def _head_spec(lay):
    return SH.P(*reversed(tuple(lay.specs["embed"]) + (None,) * (2 - len(lay.specs["embed"]))))


def forward_encdec_sharded(params, cfg: ArchConfig, batch, lay, *, attn_backend: str = "auto",
                           remat: bool = False):
    """:func:`forward_encdec` on a mesh: ``(logits, aux 0)``, the logits
    this rank's rows, their vocab split over ``model`` where the vocab
    splits, else whole (at this rank's positions under ``seq_shard``)."""

    enc, seq_e = encode_sharded(params, cfg, batch["frames"], lay, attn_backend=attn_backend)
    kv_in = spmd.tp_enter(enc, lay, seq_e)  # every layer's cross K/V read it whole
    tokens = batch["tokens"]
    b, s = tokens.shape
    seq = lay.seq_sharded((b, s, cfg.d_model))
    pe = L.sinusoidal_positions(s, cfg.d_model, device=tokens.device).to(L.COMPUTE_DTYPE)
    x = T.embed_tokens_sharded(params, cfg, {"tokens": tokens}, lay, seq=seq)
    x = x + _split_pe(pe, lay, seq)
    acfg, xcfg = _acfg(cfg, causal=True), _acfg(cfg, causal=False)
    specs = spmd.layer_specs(lay.specs["dec_blocks"])

    def body(x, p):
        h = L.apply_attention_tp(p["attn"], specs["attn"], _norm(x, p, "ln1_w", "ln1_b", lay, seq),
                                 acfg, lay, positions=None, seq=seq, backend=attn_backend)
        x = x + h
        xp, xs = _cross(p, specs)
        x = x + L.apply_attention_tp(xp, xs, _norm(x, p, "lnx_w", "lnx_b", lay, seq), xcfg, lay,
                                     positions=None, seq=seq, backend=attn_backend, kv_in=kv_in)
        return x + L.apply_mlp_tp(p["mlp"], specs["mlp"], _norm(x, p, "ln2_w", "ln2_b", lay, seq),
                                  lay, seq=seq)

    if remat:
        body = _remat(body)
    for p in _unstack(params["dec_blocks"], cfg.n_layers):
        x = body(x, p)
    x = _norm(x, params, "dec_ln_w", "dec_ln_b", lay, seq)
    logits = T.lm_head_sharded(x, params["embed"].T.to(L.COMPUTE_DTYPE), _head_spec(lay), lay, seq)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn_sharded(params, cfg: ArchConfig, batch, lay, *, attn_backend: str = "auto",
                    remat: bool = False):
    """``(loss, {"ce", "aux"})`` of this rank's rows: its term of the
    global mean (``spmd.dp_sum`` over the dp ranks gives the reference's)."""

    logits, aux = forward_encdec_sharded(params, cfg, batch, lay, attn_backend=attn_backend,
                                         remat=remat)
    b, s = batch["tokens"].shape
    ce = T.sharded_ce(logits, batch, lay, _head_spec(lay), lay.seq_sharded((b, s, cfg.d_model)))
    return ce + aux, {"ce": ce, "aux": aux}


def fill_cross_kv_sharded(params, cfg: ArchConfig, frames, state, lay, cache_specs, *,
                          attn_backend: str = "auto"):
    """Write every decoder layer's cross K/V of ``frames`` (this rank's
    rows) into ``state["cross_k"]`` / ``["cross_v"]``: the encoder's
    states, each layer's K/V over every head, and this rank's slice of the
    encoder positions (``cache_specs``)."""

    enc, seq = encode_sharded(params, cfg, frames, lay, attn_backend=attn_backend)
    enc = spmd.tp_enter(enc, lay, seq)
    b, s = enc.shape[:2]
    axes = SH._axes(cache_specs["cross_k"][2])
    specs = spmd.layer_specs(lay.specs["dec_blocks"])
    for i in range(cfg.n_layers):
        p = layer_params(params["dec_blocks"], i)["xkv"]
        for name, key in (("wk", "cross_k"), ("wv", "cross_v")):
            y = spmd.column(enc, p[name].to(L.COMPUTE_DTYPE), specs["xkv"][name], lay)
            if spmd.splits_model(specs["xkv"][name], 1):
                y = C.all_gather(y, lay.mesh, "model", 2)
            y = y.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
            state[key][i].copy_(C.local_block(y, lay.mesh, axes, 1))
    return state


def decode_step_sharded(params, cfg: ArchConfig, batch, state, pos, lay, cache_specs):
    """:func:`decode_step` on a mesh: this rank's rows, its slice of the
    self-attention cache's length and of the cross K/V's encoder positions
    (``cache_specs``, the state's ``sharding.cache_pspec`` tree), the
    logits as the tied head's vocab lies."""

    tokens = batch["tokens"]
    b = tokens.shape[0]
    x = T.embed_tokens_sharded(params, cfg, batch, lay, seq=False)
    x = x + _positions_at(pos, b, cfg.d_model, x.device).to(L.COMPUTE_DTYPE)
    acfg, xcfg = _acfg(cfg, causal=True), _acfg(cfg, causal=False)
    kv = T.cache_plan(state["k"], cache_specs["k"], lay, acfg, pos, b)
    cross_axes = SH._axes(cache_specs["cross_k"][2])
    specs = spmd.layer_specs(lay.specs["dec_blocks"])
    live = batch.get("live")
    for i in range(cfg.n_layers):
        p = layer_params(params["dec_blocks"], i)
        h = L.decode_attention_tp(p["attn"], specs["attn"], L.layer_norm(x, p["ln1_w"], p["ln1_b"]),
                                  acfg, lay, state["k"][i], state["v"][i], pos, plan=kv["plan"],
                                  s_total=kv["s_total"], len_axes=kv["len_axes"], live=live)
        x = x + h
        x = x + L.cross_attention_decode_tp(p["xattn"], specs["xattn"],
                                            L.layer_norm(x, p["lnx_w"], p["lnx_b"]), xcfg, lay,
                                            state["cross_k"][i], state["cross_v"][i], cross_axes)
        x = x + L.apply_mlp_tp(p["mlp"], specs["mlp"], L.layer_norm(x, p["ln2_w"], p["ln2_b"]), lay,
                               seq=False)
    x = L.layer_norm(x, params["dec_ln_w"], params["dec_ln_b"])
    logits = T.lm_head_sharded(x, params["embed"].T.to(L.COMPUTE_DTYPE), _head_spec(lay), lay,
                               False)
    return logits, state


__all__ = [
    "decode_step",
    "decode_step_sharded",
    "encode",
    "encode_sharded",
    "fill_cross_kv_sharded",
    "forward_encdec",
    "forward_encdec_sharded",
    "init_decode_state",
    "init_encdec",
    "loss_fn",
    "loss_fn_sharded",
]
