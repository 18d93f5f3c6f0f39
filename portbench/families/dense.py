"""The dense decoder family: InternLM2 [arXiv:2403.17297].

A pre-norm decoder: RMSNorm, grouped-query attention with rotary
positions (rotate-half form, base ``rope_theta``), causal softmax, a
SwiGLU feed-forward ``w2(silu(x w1) * (x w3))``; a final RMSNorm and the
output head (``reference/models.py``), tied to the embedding where the
file's ``tie_word_embeddings`` says so (InternLM2's is not).  Every
projection and the head run through the program's GEMM funnel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.models import rms_norm
from portbench.reference.precision import mm


def n_layers(conf) -> int:
    return conf["num_hidden_layers"]


def d_model(conf) -> int:
    return conf["hidden_size"]


def norm_eps(conf) -> float:
    return conf["rms_norm_eps"]


def tied_head(conf) -> bool:
    return bool(conf.get("tie_word_embeddings", False))


def held_vocab(conf) -> int:
    return conf["vocab_size"]


def _sizes(conf):
    d = conf["hidden_size"]
    hq, hkv = conf["num_attention_heads"], conf["num_key_value_heads"]
    return d, hq, hkv, d // hq, conf["intermediate_size"]


# The file's keys that must equal the program's config (ArchConfig attribute).
_WIDTHS = {"hidden_size": "d_model", "intermediate_size": "d_ff",
           "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
           "num_hidden_layers": "n_layers", "vocab_size": "vocab",
           "rms_norm_eps": "norm_eps", "rope_theta": "rope_theta"}


def port_widths(conf, cfg) -> list:
    pairs = [(k, conf[k], getattr(cfg, a)) for k, a in _WIDTHS.items()]
    return pairs + [("head_dim", _sizes(conf)[3], cfg.head_dim)]


def reduced(conf, cfg) -> dict:
    return dict(conf, **{k: getattr(cfg, a) for k, a in _WIDTHS.items()})


def block_leaves(conf) -> list:
    d, hq, hkv, dh, f = _sizes(conf)
    return [("ln1", (d,), "ones"),
            ("attn.wq", (d, hq * dh), "proj"), ("attn.wk", (d, hkv * dh), "proj"),
            ("attn.wv", (d, hkv * dh), "proj"), ("attn.wo", (hq * dh, d), "proj"),
            ("ln2", (d,), "ones"),
            ("mlp.w1", (d, f), "proj"), ("mlp.w3", (d, f), "proj"), ("mlp.w2", (f, d), "proj")]


# ---------------------------------------------------------------------------
# The reference's layer
# ---------------------------------------------------------------------------


def rotary(x, theta: float):
    """Rotate-half rotary embedding of x: (B, S, H, D) at positions 0..S-1."""

    s, d = x.shape[1], x.shape[-1]
    half = d // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) * 2.0 / d)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv[None, :]
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q, k, v, precision: str, q_block: int = 1024):
    """softmax(q kᵀ / sqrt(D)) v over the visible keys; q: (B, S, Hq, D),
    k, v: (B, S, Hkv, D), query head h reads key head h // (Hq / Hkv).
    Computed a block of queries at a time, so the scores fit."""

    b, s, hq, d = q.shape
    rep = hq // k.shape[2]
    k = k.repeat_interleave(rep, dim=2).transpose(1, 2)   # (B, Hq, S, D)
    v = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    out = []
    for lo in range(0, s, q_block):
        hi = min(s, lo + q_block)
        scores = mm(q[:, :, lo:hi], k[:, :, :hi].transpose(-1, -2), precision) / math.sqrt(d)
        qi = torch.arange(lo, hi, device=q.device)[:, None]
        ki = torch.arange(hi, device=q.device)[None, :]
        scores = scores.masked_fill(ki > qi, float("-inf"))
        out.append(mm(torch.softmax(scores, dim=-1), v[:, :, :hi], precision))
    return torch.cat(out, dim=2).transpose(1, 2)


def layer(x, p, conf, precision: str):
    d, hq, hkv, dh, _ = _sizes(conf)
    eps = conf["rms_norm_eps"]
    b, s, _ = x.shape
    h = rms_norm(x, p["ln1"], eps)
    q = mm(h, p["attn"]["wq"], precision).view(b, s, hq, dh)
    k = mm(h, p["attn"]["wk"], precision).view(b, s, hkv, dh)
    v = mm(h, p["attn"]["wv"], precision).view(b, s, hkv, dh)
    q, k = rotary(q, conf["rope_theta"]), rotary(k, conf["rope_theta"])
    o = causal_attention(q, k, v, precision).reshape(b, s, hq * dh)
    x = x + mm(o, p["attn"]["wo"], precision)
    h = rms_norm(x, p["ln2"], eps)
    g = F.silu(mm(h, p["mlp"]["w1"], precision)) * mm(h, p["mlp"]["w3"], precision)
    return x + mm(g, p["mlp"]["w2"], precision)


# ---------------------------------------------------------------------------
# The frozen counts of a layer
# ---------------------------------------------------------------------------


def layer_matmul_params(conf) -> int:
    d, hq, hkv, dh, f = _sizes(conf)
    return d * hq * dh + 2 * d * hkv * dh + hq * dh * d + 3 * d * f


def mixer_flops(conf, seq: int) -> int:
    """Causal attention's forward operations for one sequence, all layers."""

    d, hq, hkv, dh, f = _sizes(conf)
    return n_layers(conf) * 2 * hq * dh * seq * seq


def funnel_products(conf, m: int) -> list:
    """``[(M, K, N, count)]``: every layer's projections through the funnel."""

    d, hq, hkv, dh, f = _sizes(conf)
    nl = n_layers(conf)
    return [(m, d, hq * dh, nl), (m, d, hkv * dh, 2 * nl), (m, hq * dh, d, nl),
            (m, d, f, 2 * nl), (m, f, d, nl)]


def flash_bound_s(conf, rows: int, seq: int, pk: dict) -> float:
    """The causal attention calls of one forward of ``rows`` x ``seq``."""

    d, hq, hkv, dh, f = _sizes(conf)
    ops = rows * 2 * hq * dh * seq * seq
    nbytes = 2 * rows * seq * dh * (2 * hq + 2 * hkv)     # bfloat16 q, k, v, o
    return n_layers(conf) * max(ops / pk["bf16_flops"], nbytes / pk["hbm_bytes_per_s"])
