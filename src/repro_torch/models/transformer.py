"""Decoder-only LM, dense and MoE families (the port's
``repro.models.transformer``).

Two paths: the full-sequence forward (prefill logits, scoring, the eval
loss with the MoE router's auxiliary loss; no gradient yet) and the decode
step.  Layer params are stacked along a leading ``L`` axis, as in the
reference; where the reference scans over that axis, the port loops over
it (no remat: nothing is kept for a backward pass).  Decode caches are
written in place (dense ``(L, B, S_cache, Hkv, Dh)`` lanes or paged
``(L, n_pages, page_size, Hkv, Dh)`` arenas); a sliding window makes them
rings of ``min(window, seq_len)`` slots.  The SSM and hybrid families,
embedding inputs and training are not ported yet.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import moe as M


def attn_config(cfg: ArchConfig, *, causal: bool = True) -> L.AttnConfig:
    return L.AttnConfig(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.head_dim,
        qkv_bias=cfg.qkv_bias,
        rope_theta=cfg.rope_theta,
        window=cfg.swa_window,
        causal=causal,
    )


def block_kind(cfg: ArchConfig) -> str:
    return {"dense": "attn_mlp", "moe": "attn_moe", "ssm": "mamba", "hybrid": "mamba"}[
        cfg.family
    ]


def _require_ported(cfg: ArchConfig) -> None:
    """The families the port runs: dense and MoE, token in.  The SSM and
    hybrid (Mamba2) families and embedding inputs are not ported yet."""

    if block_kind(cfg) not in ("attn_mlp", "attn_moe") or cfg.shared_attn_every \
            or cfg.embed_inputs:
        raise NotImplementedError(
            f"{cfg.name}: the port runs the dense and MoE token-in families so far "
            f"(family {cfg.family!r})"
        )


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_lm(generator: torch.Generator, cfg: ArchConfig, *, device,
            dtype: torch.dtype = L.COMPUTE_DTYPE) -> dict[str, Any]:
    """Random params at the reference's scales: projections ``dense_init``
    (normal / sqrt(fan_in)), ``lm_head`` and ``embed`` 0.02, norms ones.
    Projections, ``embed`` and ``lm_head`` are stored in ``dtype``; norms
    stay fp32.  An MoE block carries ``"moe"`` params (router, experts,
    shared expert) in place of the dense ``"mlp"``."""

    _require_ported(cfg)
    nl, d = cfg.n_layers, cfg.d_model
    acfg = attn_config(cfg)
    hq, hkv = acfg.n_heads * acfg.d_head, acfg.n_kv_heads * acfg.d_head
    stack = lambda shape: L.dense_init(generator, (nl,) + shape, device=device, dtype=dtype)  # noqa: E731
    ones = lambda *shape: torch.ones(shape, dtype=L.PARAM_DTYPE, device=device)  # noqa: E731
    attn = {"wq": stack((d, hq)), "wk": stack((d, hkv)), "wv": stack((d, hkv)), "wo": stack((hq, d))}
    if cfg.qkv_bias:
        attn["bq"] = torch.zeros((nl, hq), dtype=L.PARAM_DTYPE, device=device)
        attn["bk"] = torch.zeros((nl, hkv), dtype=L.PARAM_DTYPE, device=device)
        attn["bv"] = torch.zeros((nl, hkv), dtype=L.PARAM_DTYPE, device=device)
    blocks = {"ln1": ones(nl, d), "attn": attn, "ln2": ones(nl, d)}
    if block_kind(cfg) == "attn_moe":
        blocks["moe"] = M.init_moe(generator, cfg.moe, nl, device=device, dtype=dtype)
    else:
        blocks["mlp"] = {
            "w1": stack((d, cfg.d_ff)),
            "w3": stack((d, cfg.d_ff)),
            "w2": stack((cfg.d_ff, d)),
        }
    return {
        "blocks": blocks,
        "final_norm": ones(d),
        "lm_head": L.dense_init(generator, (d, cfg.vocab), scale=0.02, device=device, dtype=dtype),
        "embed": L.embed_init(generator, (cfg.vocab, d), device=device, dtype=dtype),
    }


def gemm_shapes(cfg: ArchConfig) -> list:
    """``((K, N), calls)`` of every ``ops.gemm`` of one decode step (or one
    forward): q, k and v, o, then the dense GLU's gate, up and down or the
    MoE shared expert's (the router, the shared gate and the routed
    experts are not ``ops.gemm`` calls), then the LM head."""

    d, hq = cfg.d_model, cfg.n_heads * cfg.head_dim
    hkv, nl = cfg.n_kv_heads * cfg.head_dim, cfg.n_layers
    ff = cfg.moe.d_ff_shared if block_kind(cfg) == "attn_moe" else cfg.d_ff
    shapes = [((d, hq), nl), ((d, hkv), 2 * nl), ((hq, d), nl)]
    if ff:
        shapes += [((d, ff), 2 * nl), ((ff, d), nl)]
    return shapes + [((d, cfg.vocab), 1)]


def layer_params(blocks, i: int):
    """Layer ``i``'s params: views into the stacked tensors."""

    if isinstance(blocks, dict):
        return {k: layer_params(v, i) for k, v in blocks.items()}
    return blocks[i]


# ---------------------------------------------------------------------------
# Forward (prefill / scoring / eval)
# ---------------------------------------------------------------------------


def _ffn(p, x, cfg: ArchConfig):
    """The block's second half on the normed stream: the dense GLU (no
    auxiliary loss) or the MoE layer and its router loss."""

    if "moe" in p:
        return M.apply_moe(p["moe"], x, cfg.moe)
    return L.apply_glu(p["mlp"], x), 0.0


def _apply_attn_block(p, x, cfg: ArchConfig, positions, *, attn_backend: str = "auto"):
    h, kv = L.apply_attention(p["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps), attn_config(cfg),
                              positions=positions, backend=attn_backend)
    x = x + h
    h, aux = _ffn(p, L.rms_norm(x, p["ln2"], cfg.norm_eps), cfg)
    return x + h, aux, kv


def _layer_fn(cfg: ArchConfig, kind: str, positions, *, attn_backend: str = "auto"):
    """One layer's body, ``(x, p) -> (x, aux)``; a dense block's aux is 0."""

    if kind not in ("attn_mlp", "attn_moe"):
        raise NotImplementedError(f"{cfg.name}: the {kind!r} block is not ported yet")

    def f(x, p):
        x, aux, _ = _apply_attn_block(p, x, cfg, positions, attn_backend=attn_backend)
        return x, aux

    return f


def _cast_params(tree):
    """The reference's compute cast: every fp32 leaf to bf16 (norm weights
    and qkv biases too), as its forward does before the layers run."""

    if isinstance(tree, dict):
        return {k: _cast_params(v) for k, v in tree.items()}
    return tree.to(L.COMPUTE_DTYPE) if tree.dtype == torch.float32 else tree


def forward_lm(params, cfg: ArchConfig, batch, *, attn_backend: str = "auto"):
    """Returns ``(logits (B, S, V) bf16, aux_loss)``; ``batch["tokens"]``
    is (B, S).  ``aux_loss`` is the fp32 sum of the layers' MoE router
    losses (0 for the dense family).  ``attn_backend`` names the attention
    route (an ``execution.BACKENDS`` entry of the ``flash_attn`` family)."""

    _require_ported(cfg)
    x = embed_tokens(params, cfg, batch)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    body = _layer_fn(cfg, block_kind(cfg), positions, attn_backend=attn_backend)
    blocks = _cast_params(params["blocks"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x, aux_i = body(x, layer_params(blocks, i))
        aux = aux + aux_i
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = ops.gemm(x, params["lm_head"].to(L.COMPUTE_DTYPE))
    return logits, aux


def cross_entropy(logits, labels, mask=None):
    """Mean softmax cross-entropy in fp32 over (B, S, V) logits.

    The reference sums ``shifted * one_hot(labels)`` so that the vocab axis
    stays sharded; on one card a gather reads the same element (every other
    term of that sum is an exact zero) without a (B, S, V) one-hot.
    """

    lf = logits.float()
    shifted = lf - lf.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(shifted).sum(dim=-1))
    ll = shifted.gather(-1, labels.long()[..., None])[..., 0] - lse
    if mask is None:
        return -ll.mean()
    mask = mask.float()
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def loss_fn(params, cfg: ArchConfig, batch):
    """``(loss, {"ce", "aux"})`` on ``batch["tokens"]`` against
    ``batch["labels"]`` (optionally weighted by ``batch["mask"]``)."""

    logits, aux = forward_lm(params, cfg, batch)
    ce = cross_entropy(logits, batch["labels"], batch.get("mask"))
    return ce + aux, {"ce": ce, "aux": aux}


def prefill(params, cfg: ArchConfig, batch, *, attn_backend: str = "auto"):
    """Full-sequence inference forward; returns the logits."""

    logits, _ = forward_lm(params, cfg, batch, attn_backend=attn_backend)
    return logits


# ---------------------------------------------------------------------------
# Decode (serve_step)
# ---------------------------------------------------------------------------


def cache_len(cfg: ArchConfig, seq_len: int) -> int:
    if cfg.swa_window is not None:
        return min(cfg.swa_window, seq_len)
    return seq_len


def init_decode_state(cfg: ArchConfig, batch: int, seq_len: int, *, device):
    """Dense per-slot KV lanes ``(L, B, S_cache, Hkv, Dh)`` in bf16
    (``S_cache`` is :func:`cache_len`: a ring of the window's size)."""

    _require_ported(cfg)
    sc = cache_len(cfg, seq_len)
    kv_shape = (cfg.n_layers, batch, sc, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(kv_shape, dtype=L.COMPUTE_DTYPE, device=device),
        "v": torch.zeros(kv_shape, dtype=L.COMPUTE_DTYPE, device=device),
    }


def init_decode_state_paged(cfg: ArchConfig, n_pages: int, page_size: int, *, device):
    """Paged decode cache: one shared page arena per layer, no batch dim."""

    if block_kind(cfg) == "mamba" or cfg.shared_attn_every:
        raise ValueError(
            f"paged KV state requires a pure KV-cache family, not "
            f"{cfg.family!r} (recurrent state has no pages to allocate)"
        )
    _require_ported(cfg)
    kv_shape = (cfg.n_layers, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return {
        "pages_k": torch.zeros(kv_shape, dtype=L.COMPUTE_DTYPE, device=device),
        "pages_v": torch.zeros(kv_shape, dtype=L.COMPUTE_DTYPE, device=device),
    }


def embed_tokens(params, cfg: ArchConfig, batch):
    return params["embed"][batch["tokens"].long()].to(L.COMPUTE_DTYPE)


def decode_step(params, cfg: ArchConfig, batch, state, pos):
    """One-token serve step; the caches in ``state`` are written in place.

    batch: ``{"tokens": (B, 1)}`` plus optionally ``"page_table"`` (B, W)
    int32 — required when ``state`` is the paged arena — and ``"live"``
    (B,) bool.  pos: a scalar or a (B,) vector of absolute positions.
    Returns ``(logits (B, 1, V) bf16, state)``.  An MoE layer routes the
    batch's rows as one merged group (``moe.apply_moe``), so rows of an MoE
    step are coupled through the experts' capacity.
    """

    _require_ported(cfg)
    x = embed_tokens(params, cfg, batch)
    live = batch.get("live")
    acfg = attn_config(cfg)
    paged = "pages_k" in state
    for i in range(cfg.n_layers):
        p = layer_params(params["blocks"], i)
        h_in = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        if paged:
            h, _ = L.decode_attention_paged(
                p["attn"], h_in, acfg, state["pages_k"][i], state["pages_v"][i],
                batch["page_table"], pos, live=live,
            )
        else:
            h, _ = L.decode_attention(
                p["attn"], h_in, acfg, state["k"][i], state["v"][i], pos, live=live,
            )
        x = x + h
        x = x + _ffn(p, L.rms_norm(x, p["ln2"], cfg.norm_eps), cfg)[0]

    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = ops.gemm(x, params["lm_head"].to(L.COMPUTE_DTYPE))
    return logits, state


__all__ = [
    "attn_config",
    "block_kind",
    "cache_len",
    "cross_entropy",
    "decode_step",
    "embed_tokens",
    "forward_lm",
    "gemm_shapes",
    "init_decode_state",
    "init_decode_state_paged",
    "init_lm",
    "layer_params",
    "loss_fn",
    "prefill",
]
