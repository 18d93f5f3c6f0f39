"""Decoder-only LM, dense family, decode path (the port's ``repro.models.transformer``).

Layer params are stacked along a leading ``L`` axis, as in the reference;
where the reference scans over that axis, the port loops over it.  Decode
caches are written in place (dense ``(L, B, S_cache, Hkv, Dh)`` lanes or
paged ``(L, n_pages, page_size, Hkv, Dh)`` arenas).  The MoE, SSM and
hybrid families, the training forward and sliding-window decode follow
in later slices.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L


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


def _require_dense(cfg: ArchConfig) -> None:
    if block_kind(cfg) != "attn_mlp" or cfg.shared_attn_every or cfg.embed_inputs:
        raise NotImplementedError(
            f"{cfg.name}: the port serves the dense token-in family so far "
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
    stay fp32."""

    _require_dense(cfg)
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
    blocks = {
        "ln1": ones(nl, d),
        "attn": attn,
        "ln2": ones(nl, d),
        "mlp": {
            "w1": stack((d, cfg.d_ff)),
            "w3": stack((d, cfg.d_ff)),
            "w2": stack((cfg.d_ff, d)),
        },
    }
    return {
        "blocks": blocks,
        "final_norm": ones(d),
        "lm_head": L.dense_init(generator, (d, cfg.vocab), scale=0.02, device=device, dtype=dtype),
        "embed": L.embed_init(generator, (cfg.vocab, d), device=device, dtype=dtype),
    }


def layer_params(blocks, i: int):
    """Layer ``i``'s params: views into the stacked tensors."""

    if isinstance(blocks, dict):
        return {k: layer_params(v, i) for k, v in blocks.items()}
    return blocks[i]


# ---------------------------------------------------------------------------
# Decode (serve_step)
# ---------------------------------------------------------------------------


def cache_len(cfg: ArchConfig, seq_len: int) -> int:
    if cfg.swa_window is not None:
        return min(cfg.swa_window, seq_len)
    return seq_len


def init_decode_state(cfg: ArchConfig, batch: int, seq_len: int, *, device):
    """Dense per-slot KV lanes ``(L, B, S_cache, Hkv, Dh)`` in bf16."""

    _require_dense(cfg)
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
    _require_dense(cfg)
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
    Returns ``(logits (B, 1, V) bf16, state)``.
    """

    _require_dense(cfg)
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
        x = x + L.apply_glu(p["mlp"], L.rms_norm(x, p["ln2"], cfg.norm_eps))

    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = ops.gemm(x, params["lm_head"].to(L.COMPUTE_DTYPE))
    return logits, state


__all__ = [
    "attn_config",
    "block_kind",
    "cache_len",
    "decode_step",
    "embed_tokens",
    "init_decode_state",
    "init_decode_state_paged",
    "init_lm",
    "layer_params",
]
