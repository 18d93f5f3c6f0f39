"""The Mamba2 family: Mamba2-1.3B as published [arXiv:2405.21060].

A pre-norm stack of Mamba2 blocks on an fp32 residual stream
(``residual_in_fp32``): ``x + out_proj(rmsnorm_gated(y, z))`` on the
normed stream ``u``, with ``y = SSD(x, dt, B, C) + D·x``, where ``z``,
``x``, ``B``, ``C`` and ``dt`` are the column blocks of one ``in_proj`` of
``u``, ``x``, ``B`` and ``C`` pass a depthwise causal convolution of
``d_conv`` taps and a SiLU, ``dt = softplus(dt + dt_bias)``, ``A =
-exp(A_log)``, and the gated norm is RMSNorm of ``y · silu(z)`` over the
whole inner width (one group, the gate before the norm).  Then a final
RMSNorm and the head tied to the embedding, over the held rows
(``vocab_size`` padded to ``pad_vocab_size_multiple``).

The SSD here is its quadratic form, ``y_t = Σ_{s≤t} (C_t·B_s) ·
exp(cum_t − cum_s) · dt_s · x_s`` with ``cum_t = Σ_{r≤t} A·dt_r``: a
different equation from the program's chunked scan, computed a block of
queries at a time.  The projections are plain products; only the head
enters the program's GEMM funnel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.models import rms_norm
from portbench.reference.precision import mm

BF16 = 2


def n_layers(conf) -> int:
    return conf["n_layer"]


def d_model(conf) -> int:
    return conf["d_model"]


def norm_eps(conf) -> float:
    return conf["norm_epsilon"]


def tied_head(conf) -> bool:
    return bool(conf["tie_embeddings"])


def held_vocab(conf) -> int:
    mult = conf["pad_vocab_size_multiple"]
    return -(-conf["vocab_size"] // mult) * mult


def _sizes(conf):
    """``(d, d_inner, heads, headdim, d_state, groups, d_conv, chunk)``."""

    m = conf["mamba2_defaults"]
    d = conf["d_model"]
    di = m["expand"] * d
    return d, di, di // m["headdim"], m["headdim"], m["d_state"], m["ngroups"], m["d_conv"], \
        m["chunk_size"]


# The Mamba2 module's keys that must equal the program's (SSMConfig attribute).
_MIXER = {"d_state": "d_state", "headdim": "headdim", "expand": "expand", "ngroups": "n_groups",
          "d_conv": "d_conv", "chunk_size": "chunk", "dt_min": "dt_min", "dt_max": "dt_max",
          "dt_init_floor": "dt_init_floor"}


def port_widths(conf, cfg) -> list:
    m = conf["mamba2_defaults"]
    s = cfg.ssm
    pairs = [("d_model", conf["d_model"], cfg.d_model), ("d_model", conf["d_model"], s.d_model),
             ("n_layer", conf["n_layer"], cfg.n_layers), ("held_vocab", held_vocab(conf), cfg.vocab),
             ("norm_epsilon", conf["norm_epsilon"], cfg.norm_eps),
             ("tie_embeddings", conf["tie_embeddings"], cfg.tie_embeddings),
             ("residual_in_fp32", conf["residual_in_fp32"], cfg.residual_in_fp32),
             ("A_init_range", tuple(m["A_init_range"]),
              tuple(s.A_init_range) if s.A_init_range is not None else None)]
    return pairs + [(k, m[k], getattr(s, a)) for k, a in _MIXER.items()]


def reduced(conf, cfg) -> dict:
    """The file at a reduced program config's sizes; the vocabulary keeps
    its padding rows (the held rows equal the program's)."""

    s = cfg.ssm
    pad = held_vocab(conf) - conf["vocab_size"]
    mixer = dict(conf["mamba2_defaults"], **{k: getattr(s, a) for k, a in _MIXER.items()})
    return dict(conf, d_model=cfg.d_model, n_layer=cfg.n_layers, vocab_size=cfg.vocab - pad,
                mamba2_defaults=mixer)


# ---------------------------------------------------------------------------
# The published initialisation
# ---------------------------------------------------------------------------


def _uniform(gen, shape, device, lo, hi):
    return torch.rand(shape, generator=gen, device=device, dtype=torch.float32) * (hi - lo) + lo


def block_leaves(conf) -> list:
    """The program's tree order.  ``A_log = log U(A_init_range)``;
    ``dt_bias`` the inverse softplus of ``dt = exp(U(log dt_min, log
    dt_max))`` floored at ``dt_init_floor``; ``D`` ones; the convolutions
    ``Conv1d``'s default ``U(±1/sqrt(d_conv))``; ``out_proj`` divided by
    ``sqrt(n_layer)`` (``rescale_prenorm_residual``)."""

    d, di, h, _, n, g, k, _ = _sizes(conf)
    m = conf["mamba2_defaults"]
    tap = 1.0 / math.sqrt(k)
    nl = n_layers(conf)

    def conv(gen, shape, device):
        return _uniform(gen, shape, device, -tap, tap)

    def a_log(gen, shape, device):
        return torch.log(_uniform(gen, shape, device, *m["A_init_range"]))

    def dt_bias(gen, shape, device):
        log_dt = _uniform(gen, shape, device, math.log(m["dt_min"]), math.log(m["dt_max"]))
        dt = torch.clamp(torch.exp(log_dt), min=m["dt_init_floor"])
        return dt + torch.log(-torch.expm1(-dt))

    def out_proj(gen, shape, device):
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return w / math.sqrt(shape[-2] * nl)

    return [("ln", (d,), "ones"),
            ("mamba.wz", (d, di), "proj"), ("mamba.wx", (d, di), "proj"),
            ("mamba.wbc", (d, 2 * g * n), "proj"), ("mamba.wdt", (d, h), "proj"),
            ("mamba.conv_w_x", (k, di), conv), ("mamba.conv_b_x", (di,), conv),
            ("mamba.conv_w_bc", (k, 2 * g * n), conv), ("mamba.conv_b_bc", (2 * g * n,), conv),
            ("mamba.dt_bias", (h,), dt_bias), ("mamba.A_log", (h,), a_log),
            ("mamba.D", (h,), "ones"), ("mamba.norm_w", (di,), "ones"),
            ("mamba.out_proj", (di, d), out_proj)]


# ---------------------------------------------------------------------------
# The reference's layer
# ---------------------------------------------------------------------------


def causal_conv(u, w, b):
    """SiLU of the depthwise causal convolution of u: (B, S, C) with the
    (K, C) taps ``w`` (the last tap on the current step) and the bias."""

    k, c = w.shape
    out = F.conv1d(u.transpose(1, 2), w.T[:, None, :], b, padding=k - 1, groups=c)
    return F.silu(out[..., :u.shape[1]].transpose(1, 2))


def ssd(x, dt, A, B, C, precision: str, q_block: int = 256):
    """``y_t = Σ_{s≤t} (C_t·B_s) exp(cum_t − cum_s) dt_s x_s``: x (b, S, H,
    P), dt (b, S, H), A (H,), B and C (b, S, G, N), head h reading group
    h // (H / G).  The running sums in float64, so that their differences
    near the diagonal keep float32's precision at 2,048 steps; the
    exponent masked above the diagonal before the exponential.  A block
    of ``q_block`` queries at a time."""

    b, s, h, _ = x.shape
    rep = h // B.shape[2]
    cum = torch.cumsum((dt * A).double(), dim=1).transpose(1, 2)     # (b, H, S)
    xs = (x * dt[..., None]).transpose(1, 2)                          # (b, H, S, P)
    bg, cg = B.transpose(1, 2), C.transpose(1, 2)                     # (b, G, S, N)
    out = []
    for lo in range(0, s, q_block):
        hi = min(s, lo + q_block)
        cb = mm(cg[:, :, lo:hi], bg[:, :, :hi].transpose(-1, -2), precision)
        cb = cb.repeat_interleave(rep, dim=1)                         # (b, H, Qb, hi)
        seg = cum[:, :, lo:hi, None] - cum[:, :, None, :hi]
        above = torch.arange(hi, device=x.device)[None, :] > torch.arange(lo, hi,
                                                                          device=x.device)[:, None]
        decay = torch.exp(seg.masked_fill(above, -math.inf).float())
        out.append(mm(cb * decay, xs[:, :, :hi], precision))
    return torch.cat(out, dim=2).transpose(1, 2)


def layer(x, p, conf, precision: str):
    _, di, h, hp, n, g, _, _ = _sizes(conf)
    eps = norm_eps(conf)
    m = p["mamba"]
    b, s, _ = x.shape
    u = rms_norm(x, p["ln"], eps)
    z = mm(u, m["wz"], precision)
    xs = causal_conv(mm(u, m["wx"], precision), m["conv_w_x"], m["conv_b_x"]).reshape(b, s, h, hp)
    bc = causal_conv(mm(u, m["wbc"], precision), m["conv_w_bc"], m["conv_b_bc"])
    dt = F.softplus(mm(u, m["wdt"], precision) + m["dt_bias"])
    B = bc[..., :g * n].reshape(b, s, g, n)
    C = bc[..., g * n:].reshape(b, s, g, n)
    y = ssd(xs, dt, -torch.exp(m["A_log"]), B, C, precision) + m["D"][:, None] * xs
    y = rms_norm(y.reshape(b, s, di) * F.silu(z), m["norm_w"], eps)
    return x + mm(y, m["out_proj"], precision)


# ---------------------------------------------------------------------------
# The frozen counts of a layer
# ---------------------------------------------------------------------------


def layer_matmul_params(conf) -> int:
    """``in_proj`` (z, x, B, C, dt) and ``out_proj``."""

    d, di, h, _, n, g, _, _ = _sizes(conf)
    return d * (2 * di + 2 * g * n + h) + di * d


def _ssd_ops(rows, seq, heads, headdim, d_state, groups, chunk) -> int:
    """The SSD forward's products a sequence at ``chunk``: within a chunk
    ``C·Bᵀ`` (a group) and ``(L∘CBᵀ)·x`` (a head) over the causal half, as
    causal attention is counted; each chunk's state ``Σ B ⊗ x`` and the
    output from the states, ``C·state``, a head.  The recurrence over the
    chunks is element-wise and not counted."""

    q = min(chunk, seq)
    per_token = groups * q * d_state + heads * q * headdim + 4 * heads * d_state * headdim
    return rows * seq * per_token


def mixer_flops(conf, seq: int) -> int:
    """The SSD's forward operations for one sequence, all layers."""

    _, _, h, hp, n, g, _, q = _sizes(conf)
    return n_layers(conf) * _ssd_ops(1, seq, h, hp, n, g, q)


def funnel_products(conf, m: int) -> list:
    """The projections are plain products: only the head enters the funnel."""

    return []


def flash_bound_s(conf, rows: int, seq: int, pk: dict) -> float:
    return 0.0


def ssd_bound_s(tags: dict, pk: dict) -> float:
    """One SSD forward's least time at the shapes of an ``ssm.scan``
    span's tags: the larger of its operations (:func:`_ssd_ops`) at the
    bf16 peak and its bytes at the HBM rate, x, dt, B and C read once and
    y written once, two bytes each."""

    rows, seq, h, hp = tags["rows"], tags["seq"], tags["heads"], tags["headdim"]
    n, g = tags["d_state"], tags["groups"]
    ops = _ssd_ops(rows, seq, h, hp, n, g, tags["chunk"])
    nbytes = BF16 * rows * seq * (2 * h * hp + h + 2 * g * n)
    return max(ops / pk["bf16_flops"], nbytes / pk["hbm_bytes_per_s"])
