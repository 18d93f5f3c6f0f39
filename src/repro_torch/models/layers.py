"""Shared neural-net layers (plain functions on tensors, explicit params).

The port's counterpart of ``repro.models.layers``: the full-sequence
attention of the prefill / scoring forward, the decode attention, and the
encoder-decoder's pieces (layer norm, the GELU MLP, sinusoidal positions,
cross-attention).  Conventions, as in the reference:

  * projection weights keep the JAX ``(in, out)`` layout, because the
    GEMM kernels compute ``A · B``; they may be stored in bf16 once (the
    reference casts fp32 masters to bf16 at every use — the same values),
  * norm weights and biases stay fp32, normalizations and softmax run in
    fp32, the residual stream stays bf16 (fp32 under a config's
    ``residual_in_fp32``),
  * every dense projection routes through :func:`repro_torch.kernels.ops.gemm`
    so the class's control tree governs the hot loops.

Decode updates the KV caches **in place** (the reference threads them
through donated jit arguments; here the tensors are simply written).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as C
from repro_torch.distributed import spmd
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import grouped_attention, valid_mask

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32


# ---------------------------------------------------------------------------
# Initializers (same scales as the reference; torch's own random numbers)
# ---------------------------------------------------------------------------


# Applied to every tensor the two initializers below return, while
# :func:`init_placement` is active (the sharded init's cut to a rank's shard).
_PLACE: Optional[Callable] = None


@contextlib.contextmanager
def init_placement(place: Callable):
    """Pass every leaf :func:`dense_init` / :func:`embed_init` makes through
    ``place`` as it is made (``distributed.spmd.init_sharded``)."""

    global _PLACE
    prev, _PLACE = _PLACE, place
    try:
        yield
    finally:
        _PLACE = prev


def _placed(w):
    return _PLACE(w) if _PLACE is not None else w


def dense_init(generator, shape, scale: Optional[float] = None, *, device, dtype=PARAM_DTYPE):
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return _placed((w * scale).to(dtype))


def embed_init(generator, shape, *, device, dtype=PARAM_DTYPE):
    w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return _placed((w * 0.02).to(dtype))


def uniform_init(generator, shape, low: float, high: float, *, device):
    """fp32 ``U(low, high)``."""

    w = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return _placed(w * (high - low) + low)


# True while ``torch.utils.checkpoint`` recomputes a layer body in the
# backward (``transformer._remat`` sets it); spans read it to tag their phase.
RECOMPUTING: contextvars.ContextVar = contextvars.ContextVar("repro_torch_recomputing",
                                                             default=False)


@contextlib.contextmanager
def recomputing(inner=None):
    """``inner`` (a context manager, or none) with :data:`RECOMPUTING` set."""

    token = RECOMPUTING.set(True)
    try:
        with inner if inner is not None else contextlib.nullcontext():
            yield
    finally:
        RECOMPUTING.reset(token)


# ---------------------------------------------------------------------------
# Normalization and rotary embedding
# ---------------------------------------------------------------------------


def rms_norm(x, w, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * w.float()
    return y.to(x.dtype)


def layer_norm(x, w, b, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps) * w.float() + b.float()
    return y.to(x.dtype)


def rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, D); positions: (..., S) int."""

    d = x.shape[-1]
    half = d // 2
    freqs = torch.pow(
        torch.tensor(theta, dtype=torch.float32, device=x.device),
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half,
    )
    ang = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def repeat_kv(k, n_rep: int):
    """(B, S, Hkv, D) -> (B, S, Hkv * n_rep, D), each KV head repeated for
    the query heads of its group."""

    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


# chunked_attention's and ssm._ssd_chunked's calls on CUDA tensors: a
# card's attention, training and forward, goes through the flash kernels,
# and a card's scan at the kernels' shapes through kernels/ssd.py, so a
# card's step adds none.
CUDA_CALLS: dict[str, int] = {"chunked_attention": 0, "ssd_chunked": 0}


def chunked_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                      q_chunk: int = 512, scale: Optional[float] = None):
    """GQA-native attention, chunked over queries (scores <= q_chunk x Sk).

    The reference's portable path, op for op: q, k, v rounded to bf16, fp32
    scores, ``-1e30`` masking, an fp32 softmax normalised *before* the
    probabilities are rounded to bf16 for ``p · V`` (the kernel normalises
    after, so the two differ by bf16 rounding), output in q's dtype.
    q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D); queries are the suffix of
    the keys.  With a causal window each q-chunk reads only the trailing
    ``q_chunk + window`` keys it can see.
    """

    if q.is_cuda:
        CUDA_CALLS["chunked_attention"] += 1
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    q_chunk = min(q_chunk, sq)
    n_chunks = -(-sq // q_chunk)
    kT = k.permute(0, 2, 3, 1).to(COMPUTE_DTYPE).float()  # (B, Hkv, D, Sk)
    vT = v.permute(0, 2, 1, 3).to(COMPUTE_DTYPE).float()  # (B, Hkv, Sk, D)
    span = min(sk, q_chunk + window) if window is not None and causal else sk
    neg = torch.full((), -1e30, device=q.device)

    outs = []
    for i in range(n_chunks):
        qc = q[:, i * q_chunk:(i + 1) * q_chunk]
        n = qc.shape[1]
        if n < q_chunk:  # the reference pads the last chunk with zero queries
            qc = F.pad(qc, (0, 0, 0, 0, 0, q_chunk - n))
        qc = qc.reshape(b, q_chunk, hkv, g, d).permute(0, 2, 3, 1, 4).to(COMPUTE_DTYPE).float()
        q_idx = (sk - sq) + i * q_chunk + torch.arange(q_chunk, device=q.device)
        if span < sk:
            start = min(max((sk - sq) + i * q_chunk + q_chunk - span, 0), sk - span)
            kc, vc = kT[..., start:start + span], vT[:, :, start:start + span]
            k_idx = start + torch.arange(span, device=q.device)
        else:
            kc, vc = kT, vT
            k_idx = torch.arange(sk, device=q.device)
        s = torch.einsum("bhgqd,bhds->bhgqs", qc, kc) * scale
        mask = torch.ones((q_chunk, span), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_idx[:, None] >= k_idx[None, :]
        if window is not None:
            mask &= (q_idx[:, None] - k_idx[None, :]) < window
        s = torch.where(mask, s, neg)
        p = torch.softmax(s, dim=-1).to(COMPUTE_DTYPE).float()
        o = torch.einsum("bhgqs,bhsd->bhgqd", p, vc)  # (B, Hkv, G, qc, D)
        outs.append(o.to(q.dtype).permute(0, 3, 1, 2, 4)[:, :n])
    return torch.cat(outs, dim=1).reshape(b, sq, hq, d)


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: Optional[int] = None      # sliding window; decode caches are rings of this size
    causal: bool = True
    use_rope: bool = True


def init_attention(generator, cfg: AttnConfig, *, device, dtype=COMPUTE_DTYPE):
    mk = lambda shape: dense_init(generator, shape, device=device, dtype=dtype)  # noqa: E731
    p = {
        "wq": mk((cfg.d_model, cfg.n_heads * cfg.d_head)),
        "wk": mk((cfg.d_model, cfg.n_kv_heads * cfg.d_head)),
        "wv": mk((cfg.d_model, cfg.n_kv_heads * cfg.d_head)),
        "wo": mk((cfg.n_heads * cfg.d_head, cfg.d_model)),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads), ("bv", cfg.n_kv_heads)):
            p[name] = torch.zeros((width * cfg.d_head,), dtype=PARAM_DTYPE, device=device)
    return p


def _w(w):
    return w.to(COMPUTE_DTYPE)


def _qkv(p, x, cfg: AttnConfig, positions):
    b, s, _ = x.shape
    q = ops.linear(x, _w(p["wq"]), p.get("bq"))
    k = ops.linear(x, _w(p["wk"]), p.get("bk"))
    v = ops.linear(x, _w(p["wv"]), p.get("bv"))
    q = q.reshape(b, s, cfg.n_heads, cfg.d_head)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def apply_attention(p, x, cfg: AttnConfig, *, positions=None, backend: str = "auto"):
    """Full-sequence attention (prefill / scoring / eval). x: (B, S, D).

    The attention itself routes through ``execution.dispatch_flash_attention``:
    ``"auto"`` launches ``flash_attention_cuda`` for CUDA tensors and runs
    :func:`chunked_attention` for CPU tensors.  Returns ``(out, (k, v))``.
    """

    from repro_torch.core.execution import dispatch_flash_attention

    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _qkv(p, x, cfg, positions)
    o = dispatch_flash_attention(q, k, v, causal=cfg.causal, window=cfg.window, backend=backend)
    o = o.reshape(b, s, cfg.n_heads * cfg.d_head)
    return ops.linear(o, _w(p["wo"])), (k, v)


def _per_row(pos, b: int, device) -> torch.Tensor:
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    return pos.expand(b).contiguous() if pos.ndim == 0 else pos


def _slot(pos: torch.Tensor, s_cache: int, cfg: AttnConfig) -> torch.Tensor:
    """The cache slot a row's new K/V lands in: ``pos % S_cache`` in a
    ring (sliding window), ``pos`` in a linear cache."""

    return pos.long() % s_cache if cfg.window is not None else pos.long()


def _finish(p, o, live, x, cfg: AttnConfig):
    """Zero dead rows, flatten the heads and project out."""

    b = x.shape[0]
    if live is not None:
        o = torch.where(live[:, None, None], o, torch.zeros((), dtype=o.dtype, device=o.device))
    o = o.to(x.dtype).reshape(b, 1, cfg.n_heads * cfg.d_head)
    return ops.linear(o, _w(p["wo"]))


def dense_write_plan(pos, b: int, s_cache: int, cfg: AttnConfig, device) -> tuple:
    """``(rows, slot, ok)``: where each row's new K/V land in a dense cache
    of ``s_cache`` slots, without a host sync.  A row whose linear position
    is past the cache is not ``ok`` and targets its last slot, where it
    writes that slot's own value back: rows are distinct, so no two writes
    meet.  One plan serves every layer of a step."""

    pos = _per_row(pos, b, device)
    slot = _slot(pos, s_cache, cfg)
    ok = (slot < s_cache)[:, None, None]
    return torch.arange(b, device=device), torch.clamp(slot, max=s_cache - 1), ok


def decode_attention(p, x, cfg: AttnConfig, cache_k, cache_v, pos, *, live=None, plan=None):
    """Single-token decode against a linear or ring KV cache, written in place.

    x: (B, 1, D); cache_k/v: (B, S_cache, Hkv, Dh); pos: the new token's
    absolute position — a scalar or a ``(B,)`` vector of per-row positions
    (the engine's slot table).  With a sliding window the cache is a ring
    of ``S_cache`` slots: the new K/V lands at ``pos % S_cache`` and every
    slot is visible once ``pos >= S_cache``.  In a linear cache a row whose
    position is past the cache writes nothing (the reference's
    ``mode="drop"``).  ``live`` (``(B,)`` bool) zeroes the attention output
    of dead rows.  ``plan`` is the step's :func:`dense_write_plan` (made
    here when not given); the write takes no host sync.
    """

    b = x.shape[0]
    s_cache = cache_k.shape[1]
    pos = _per_row(pos, b, x.device)
    q, k, v = _qkv(p, x, cfg, pos[:, None])

    rows, slot, ok = plan if plan is not None else dense_write_plan(pos, b, s_cache, cfg, x.device)
    cache_k[rows, slot] = torch.where(ok, k[:, 0].to(cache_k.dtype), cache_k[rows, slot])
    cache_v[rows, slot] = torch.where(ok, v[:, 0].to(cache_v.dtype), cache_v[rows, slot])

    o = grouped_attention(q[:, 0], cache_k, cache_v, valid_mask(pos, s_cache))
    return _finish(p, o, live, x, cfg), (cache_k, cache_v)


def paged_write_plan(page_table, pos, page_size: int, n_pages: int, cfg: AttnConfig) -> tuple:
    """``(page, off, src, any_ok)``: where each row's new K/V land in a
    paged arena, without a host sync, leaving it bitwise what dropping the
    rejected rows (an unallocated page, a linear position past the cache)
    would leave.  A rejected row cannot write at a clamped slot: that slot
    may be another row's live one, and of two writes to one slot either may
    land.  So it repeats the first accepted row's write (``src``: the row
    whose value each row writes), the same value at the same slot; with no
    accepted row (``any_ok`` false) every row writes page 0, offset 0 its
    own value back.  One plan serves every layer of a step."""

    b, w = page_table.shape
    s_cache = w * page_size
    pos = _per_row(pos, b, page_table.device)
    rows = torch.arange(b, device=page_table.device)
    slot = _slot(pos, s_cache, cfg)
    page = page_table[rows, torch.clamp(slot // page_size, 0, w - 1)].long()
    ok = (slot < s_cache) & (page >= 0) & (page < n_pages)
    any_ok = ok.any()
    src = torch.where(ok, rows, torch.argmax(ok.to(torch.uint8)))  # argmax: the first accepted
    zero = torch.zeros((), dtype=page.dtype, device=page.device)
    return (torch.where(any_ok, page[src], zero), torch.where(any_ok, (slot % page_size)[src], zero),
            src, any_ok)


def decode_attention_paged(
    p, x, cfg: AttnConfig, pages_k, pages_v, page_table, pos, *,
    live=None, backend: str = "auto", plan=None,
):
    """Single-token decode against a paged KV arena (one layer's).

    pages_k/v: (P, page_size, Hkv, Dh); page_table: (B, W) int32 with
    ``W · page_size == S_cache``; pos: (B,) int32.  The new K/V lands at
    logical slot ``pos % S_cache`` (ring) or ``pos`` (linear) inside the
    row's page for it, in place; rows whose table entry is unallocated
    (SENTINEL) or whose linear position is past the cache write nothing
    (``plan``: the step's :func:`paged_write_plan`, made here when not
    given; the write takes no host sync).  The read side routes through ``execution.dispatch_paged_attention``,
    whose visible prefix ``k < min(pos + 1, S_cache)`` covers the whole
    ring once it has wrapped.
    """

    from repro_torch.core.execution import dispatch_paged_attention

    b = x.shape[0]
    pos = _per_row(pos, b, x.device)
    q, k, v = _qkv(p, x, cfg, pos[:, None])

    if plan is None:
        plan = paged_write_plan(page_table, pos, pages_k.shape[1], pages_k.shape[0], cfg)
    page, off, src, any_ok = plan
    pages_k[page, off] = torch.where(any_ok, k[src, 0].to(pages_k.dtype), pages_k[0, 0])
    pages_v[page, off] = torch.where(any_ok, v[src, 0].to(pages_v.dtype), pages_v[0, 0])

    o = dispatch_paged_attention(q[:, 0], pages_k, pages_v, page_table, pos, backend=backend)
    return _finish(p, o, live, x, cfg), (pages_k, pages_v)


def cross_attention(p, x, enc_k, enc_v, cfg: AttnConfig, *, backend: str = "auto"):
    """Decoder-to-encoder attention (Whisper): x (B, S, D) against the
    precomputed encoder K/V (B, Se, Hkv, Dh), non-causal.  The attention
    routes through ``execution.dispatch_flash_attention``, as in
    :func:`apply_attention` (the reference calls ``chunked_attention``,
    which is what ``"auto"`` runs for CPU tensors)."""

    from repro_torch.core.execution import dispatch_flash_attention

    b, s, _ = x.shape
    q = ops.linear(x, _w(p["wq"]), p.get("bq")).reshape(b, s, cfg.n_heads, cfg.d_head)
    o = dispatch_flash_attention(q, enc_k.to(COMPUTE_DTYPE), enc_v.to(COMPUTE_DTYPE),
                                 causal=False, backend=backend)
    o = o.reshape(b, s, cfg.n_heads * cfg.d_head)
    return ops.linear(o, _w(p["wo"]))


def init_cross_kv(generator, cfg: AttnConfig, *, device, dtype=COMPUTE_DTYPE):
    mk = lambda shape: dense_init(generator, shape, device=device, dtype=dtype)  # noqa: E731
    return {
        "wk": mk((cfg.d_model, cfg.n_kv_heads * cfg.d_head)),
        "wv": mk((cfg.d_model, cfg.n_kv_heads * cfg.d_head)),
    }


def encode_cross_kv(p, enc_out, cfg: AttnConfig):
    """The cross-attention K/V of one decoder layer from the encoder's
    output: (B, Se, Hkv, Dh) each."""

    b, s, _ = enc_out.shape
    k = ops.linear(enc_out, _w(p["wk"])).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = ops.linear(enc_out, _w(p["wv"])).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    return k, v


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_glu(generator, d_model: int, d_ff: int, *, device, dtype=COMPUTE_DTYPE):
    return {
        "w1": dense_init(generator, (d_model, d_ff), device=device, dtype=dtype),
        "w3": dense_init(generator, (d_model, d_ff), device=device, dtype=dtype),
        "w2": dense_init(generator, (d_ff, d_model), device=device, dtype=dtype),
    }


def apply_glu(p, x):
    h = F.silu(ops.gemm(x, _w(p["w1"])).float()).to(COMPUTE_DTYPE)
    h = h * ops.gemm(x, _w(p["w3"]))
    return ops.gemm(h, _w(p["w2"]))


def init_mlp(generator, d_model: int, d_ff: int, *, device, dtype=COMPUTE_DTYPE):
    return {
        "w1": dense_init(generator, (d_model, d_ff), device=device, dtype=dtype),
        "b1": torch.zeros((d_ff,), dtype=PARAM_DTYPE, device=device),
        "w2": dense_init(generator, (d_ff, d_model), device=device, dtype=dtype),
        "b2": torch.zeros((d_model,), dtype=PARAM_DTYPE, device=device),
    }


def apply_mlp(p, x):
    """The GELU MLP (``jax.nn.gelu``'s default, the tanh form)."""

    h = ops.linear(x, _w(p["w1"]), p["b1"])
    h = F.gelu(h.float(), approximate="tanh").to(COMPUTE_DTYPE)
    return ops.linear(h, _w(p["w2"]), p["b2"])


def sinusoidal_positions(s: int, d: int, *, device="cpu") -> torch.Tensor:
    """(S, D) fp32 sinusoids, computed in float64 numpy and cast, as in the
    reference: sin on the even columns, cos on the odd."""

    pos = np.arange(s)[:, None]
    dim = np.arange(0, d, 2)[None, :]
    ang = pos / np.power(10000.0, dim / d)
    out = np.zeros((s, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return torch.from_numpy(out).to(device)


# ---------------------------------------------------------------------------
# A rank's part of attention and the GLU on a (data, model) mesh
# ---------------------------------------------------------------------------
#
# The reference's rules (``distributed/sharding.py``): wq / wk / wv / w1 /
# w3 split their output features over ``model`` (column-parallel), wo / w2
# their input features (row-parallel), all of them their other dim over
# ``data`` (FSDP, gathered at use by ``spmd.use``).  ``xn`` and the
# returned tensor are in the residual stream's layout (``spmd``): ``seq``
# says whether it is sequence-sharded over ``model``.


def _local_kv(k, v, r: int, hl: int, group: int):
    """The KV heads the query heads ``[r·hl, (r+1)·hl)`` read, from the
    whole set: a run of heads when ``hl`` is a multiple of the group, else
    one head a query head (a group of 1)."""

    if hl % group == 0:
        lo = r * hl // group
        return k[:, :, lo:lo + hl // group], v[:, :, lo:lo + hl // group]
    idx = (r * hl + torch.arange(hl, device=k.device)) // group
    return k.index_select(2, idx), v.index_select(2, idx)


def apply_attention_tp(p, sp, xn, cfg: AttnConfig, lay, *, positions, seq: bool,
                       backend: str = "auto", kv_in=None):
    """Full-sequence attention, a rank's part; returns the block's output in
    the residual layout.

    * ``n_heads % model == 0``: this rank's query heads and the projections'
      columns for them; the KV heads split the same way when ``n_kv_heads``
      divides ``model``, else wk / wv are gathered whole over ``model`` and
      each rank reads the KV heads of its query heads; ``wo`` row-parallel,
      its partial sums reduced.
    * otherwise the context-parallel split of
      ``sharding.constrain_qkv_context_parallel``: every weight gathered
      whole, this rank's query rows ``[r·S/m, (r+1)·S/m)`` against the K/V
      of every position up to its last row (causal; every position when not
      causal), its rows of the output joined over ``model`` (or left
      sequence-sharded under ``seq``); with a sequence ``model`` does not
      divide, every rank computes the whole (the weights' gradients then
      kept, not summed, over ``model``).

    ``kv_in`` (cross-attention): the K/V come from this tensor, whole over
    ``model`` (the encoder's output after ``spmd.tp_enter``), not from
    ``xn``; ``p`` then holds the query's ``wq`` / ``wo`` beside the cross
    ``wk`` / ``wv``.
    """

    from repro_torch.core.execution import dispatch_flash_attention

    m, r = lay.model, lay.model_index
    b = xn.shape[0]
    dh = cfg.d_head
    if cfg.n_heads % m == 0:
        x = spmd.tp_enter(xn, lay, seq)
        xk = x if kv_in is None else kv_in
        s, sk = x.shape[1], xk.shape[1]
        hl = cfg.n_heads // m
        spmd.require_model(sp["wq"], "wq", lay, 1)
        q = spmd.column(x, _w(p["wq"]), sp["wq"], lay, p.get("bq"), sp.get("bq"))
        kv_split = cfg.n_kv_heads % m == 0
        hkv = cfg.n_kv_heads // m if kv_split else cfg.n_kv_heads
        k = spmd.column(xk, _w(p["wk"]), sp["wk"], lay, p.get("bk"), sp.get("bk"),
                        gather_model=not kv_split)
        v = spmd.column(xk, _w(p["wv"]), sp["wv"], lay, p.get("bv"), sp.get("bv"),
                        gather_model=not kv_split)
        q = q.reshape(b, s, hl, dh)
        k, v = k.reshape(b, sk, hkv, dh), v.reshape(b, sk, hkv, dh)
        if cfg.use_rope:
            q, k = rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta)
        if not kv_split:
            k, v = _local_kv(k, v, r, hl, cfg.n_heads // cfg.n_kv_heads)
        o = dispatch_flash_attention(q, k, v, causal=cfg.causal, window=cfg.window, backend=backend)
        spmd.require_model(sp["wo"], "wo", lay, 0)
        h = spmd.row(o.reshape(b, s, hl * dh), _w(p["wo"]), sp["wo"], lay,
                     out_dtype=torch.float32)
        return spmd.tp_exit(h, lay, seq)

    s_full = xn.shape[1] * (m if seq else 1)
    cp = lay.context_parallel(b, s_full, cfg)
    if kv_in is not None and not cp:
        raise ValueError(f"cross-attention with {cfg.n_heads} heads over model={m} needs a "
                         f"query sequence model divides (not {s_full})")
    x = spmd.tp_enter(xn, lay, seq) if cp else xn
    xk = x if kv_in is None else kv_in
    sk = xk.shape[1]
    kw = dict(gather_model=True, model_grad="reduce_scatter" if cp else "slice")
    k = spmd.column(xk, _w(p["wk"]), sp["wk"], lay, p.get("bk"), sp.get("bk"), **kw)
    v = spmd.column(xk, _w(p["wv"]), sp["wv"], lay, p.get("bv"), sp.get("bv"), **kw)
    k = k.reshape(b, sk, cfg.n_kv_heads, dh)
    v = v.reshape(b, sk, cfg.n_kv_heads, dh)
    if cfg.use_rope:
        k = rope(k, positions, cfg.rope_theta)
    lo, c = (r * (s_full // m), s_full // m) if cp else (0, s_full)
    q = spmd.column(x[:, lo:lo + c], _w(p["wq"]), sp["wq"], lay, p.get("bq"), sp.get("bq"), **kw)
    q = q.reshape(b, c, cfg.n_heads, dh)
    if cfg.use_rope:
        q = rope(q, positions[..., lo:lo + c], cfg.rope_theta)
    if cfg.causal:  # the queries are the suffix of the keys they see
        k, v = k[:, :lo + c], v[:, :lo + c]
    o = dispatch_flash_attention(q, k, v, causal=cfg.causal, window=cfg.window, backend=backend)
    h = spmd.row(o.reshape(b, c, cfg.n_heads * dh), _w(p["wo"]), sp["wo"], lay, **kw)
    if cp and not seq:
        return C.gather(h, lay.mesh, "model", 1, grad="slice")
    return h


def apply_glu_tp(p, sp, xn, lay, *, seq: bool):
    """The GLU, a rank's part: w1 / w3 column-parallel (its features of
    ``d_ff``), w2 row-parallel, its partial sums reduced."""

    for name, dim in (("w1", 1), ("w3", 1), ("w2", 0)):
        spmd.require_model(sp[name], name, lay, dim)
    x = spmd.tp_enter(xn, lay, seq)
    h = F.silu(spmd.row(x, _w(p["w1"]), sp["w1"], lay).float()).to(COMPUTE_DTYPE)
    h = h * spmd.row(x, _w(p["w3"]), sp["w3"], lay)
    h = spmd.row(h, _w(p["w2"]), sp["w2"], lay, out_dtype=torch.float32)
    return spmd.tp_exit(h, lay, seq)


def apply_mlp_tp(p, sp, xn, lay, *, seq: bool):
    """The enc-dec's GELU MLP, a rank's part: w1 and its bias ``b1``
    column-parallel, w2 row-parallel, its partial sums reduced before the
    replicated ``b2`` is added."""

    for name, dim in (("w1", 1), ("w2", 0)):
        spmd.require_model(sp[name], name, lay, dim)
    x = spmd.tp_enter(xn, lay, seq)
    h = spmd.column(x, _w(p["w1"]), sp["w1"], lay, p["b1"], sp["b1"])
    h = F.gelu(h.float(), approximate="tanh").to(COMPUTE_DTYPE)
    h = spmd.tp_exit(spmd.row(h, _w(p["w2"]), sp["w2"], lay, out_dtype=torch.float32), lay, seq)
    return (h.float() + spmd.norm_weight(p["b2"], lay, seq).float()).to(h.dtype)


def _whole_features(x, p, sp, name: str, bias: str, lay):
    """``x · W (+ b)`` with every output feature: this rank's columns,
    all-gathered over ``model`` when ``W`` splits them there."""

    y = spmd.column(x, _w(p[name]), sp[name], lay, p.get(bias), sp.get(bias))
    if len(sp[name]) > 1 and sp[name][-1] == "model":
        y = C.all_gather(y, lay.mesh, "model", y.ndim - 1)
    return y


def cache_split_plan(pos, b: int, s_local: int, s_total: int, lay, len_axes, window,
                     device) -> tuple:
    """``(rows, slot, ok, offset)``: where each row's new K/V land in this
    rank's slice of a cache of ``s_total`` slots whose length is split over
    ``len_axes`` (slice ``i``, this rank's index over those axes, holds
    slots ``[i·s_local, (i+1)·s_local)``).  The slot is ``pos % s_total``
    in a ring (``window``), else ``pos``.  Only the rank whose slice holds
    the slot writes (``ok``); the others write a slot's own value back, as
    :func:`dense_write_plan` does."""

    pos = _per_row(pos, b, device).long()
    slot = pos % s_total if window is not None else pos
    off = lay.mesh.index(len_axes) * s_local
    local = slot - off
    ok = ((local >= 0) & (local < s_local))[:, None, None]
    return torch.arange(b, device=device), torch.clamp(local, 0, s_local - 1), ok, off


def _heads_out(o, p, sp, lay):
    """Every query head's output (B, 1, Hq·Dh), replicated over ``model``,
    through ``wo``: row-parallel on this rank's heads and reduced, or the
    whole product where ``wo`` is not split."""

    if spmd.splits_model(sp["wo"], 0):
        o = C.local_block(o, lay.mesh, "model", 2)
        h = spmd.row(o, _w(p["wo"]), sp["wo"], lay, out_dtype=torch.float32)
        return spmd.tp_exit(h, lay, False)
    return spmd.row(o, _w(p["wo"]), sp["wo"], lay)


def _attend_split(q, cache_k, cache_v, valid, lay, len_axes):
    if lay.mesh.size(len_axes) > 1:
        return grouped_attention_split(q, cache_k, cache_v, valid, lay.mesh, len_axes)
    return grouped_attention(q, cache_k, cache_v, valid)


def decode_attention_tp(p, sp, xn, cfg: AttnConfig, lay, cache_k, cache_v, pos, *, plan,
                        s_total: int, len_axes=(), live=None):
    """Single-token decode, a rank's part, over its rows and its slice of
    the cache length (``len_axes``: the axes ``sharding.cache_pspec``
    splits it over — ``model``, or with a batch of 1 the dp axes and
    ``model``).  q, k and v are computed column-parallel and all-gathered
    whole (every query head), the new K/V written by the rank whose slice
    holds the slot (``plan``, :func:`cache_split_plan`: ``pos`` in a linear
    cache, ``pos % s_total`` in a ring); each rank attends over its slice
    for all query heads and the partial (max, sum, output) merge across
    ``len_axes`` in log-sum-exp form (:func:`grouped_attention_split`);
    ``wo`` row-parallel, its partial sums reduced.  ``xn`` (B, 1, D) is
    replicated over ``model``."""

    b = xn.shape[0]
    pos = _per_row(pos, b, xn.device)
    q = _whole_features(xn, p, sp, "wq", "bq", lay).reshape(b, 1, cfg.n_heads, cfg.d_head)
    k = _whole_features(xn, p, sp, "wk", "bk", lay).reshape(b, 1, cfg.n_kv_heads, cfg.d_head)
    v = _whole_features(xn, p, sp, "wv", "bv", lay).reshape(b, 1, cfg.n_kv_heads, cfg.d_head)
    if cfg.use_rope:
        q, k = rope(q, pos[:, None], cfg.rope_theta), rope(k, pos[:, None], cfg.rope_theta)

    rows, slot, ok, off = plan
    cache_k[rows, slot] = torch.where(ok, k[:, 0].to(cache_k.dtype), cache_k[rows, slot])
    cache_v[rows, slot] = torch.where(ok, v[:, 0].to(cache_v.dtype), cache_v[rows, slot])

    s_local = cache_k.shape[1]
    k_idx = off + torch.arange(s_local, device=xn.device)
    valid = k_idx[None, :] < torch.clamp(pos.long()[:, None] + 1, max=s_total)
    o = _attend_split(q[:, 0], cache_k, cache_v, valid, lay, len_axes).to(q.dtype)
    if live is not None:
        o = torch.where(live[:, None, None], o, torch.zeros((), dtype=o.dtype, device=o.device))
    return _heads_out(o.to(xn.dtype).reshape(b, 1, cfg.n_heads * cfg.d_head), p, sp, lay)


def cross_attention_decode_tp(p, sp, xn, cfg: AttnConfig, lay, cross_k, cross_v, len_axes=()):
    """The decoder's cross-attention at decode, a rank's part: this rank's
    slice of the encoder positions all-gathered whole over ``len_axes``,
    then ``execution.dispatch_flash_attention`` (every position visible)
    on this rank's query heads and their KV heads, as one card attends;
    ``wo`` row-parallel, its partial sums reduced.  Where the heads do not
    split over ``model`` (or ``wo`` is whole), every head, and ``wo`` as in
    :func:`decode_attention_tp`."""

    from repro_torch.core.execution import dispatch_flash_attention

    b, dh = xn.shape[0], cfg.d_head
    if lay.mesh.size(len_axes) > 1:
        cross_k, cross_v = (C.all_gather(t, lay.mesh, len_axes, 1) for t in (cross_k, cross_v))
    cross_k, cross_v = cross_k.to(COMPUTE_DTYPE), cross_v.to(COMPUTE_DTYPE)
    if cfg.n_heads % lay.model or not spmd.splits_model(sp["wo"], 0):
        q = _whole_features(xn, p, sp, "wq", "bq", lay).reshape(b, 1, cfg.n_heads, dh)
        o = dispatch_flash_attention(q, cross_k, cross_v, causal=False)
        return _heads_out(o.reshape(b, 1, cfg.n_heads * dh), p, sp, lay)
    spmd.require_model(sp["wq"], "wq", lay, 1)
    hl = cfg.n_heads // lay.model
    q = spmd.column(xn, _w(p["wq"]), sp["wq"], lay, p.get("bq"), sp.get("bq")).reshape(b, 1, hl, dh)
    k, v = _local_kv(cross_k, cross_v, lay.model_index, hl, cfg.n_heads // cfg.n_kv_heads)
    o = dispatch_flash_attention(q, k, v, causal=False)
    h = spmd.row(o.reshape(b, 1, hl * dh), _w(p["wo"]), sp["wo"], lay, out_dtype=torch.float32)
    return spmd.tp_exit(h, lay, False)


def grouped_attention_split(q, view_k, view_v, valid, mesh, axes="model"):
    """:func:`grouped_attention` over keys split across ``mesh``'s ranks on
    ``axes``, this rank holding one slice: the row max and the sum of
    exponentials are all-reduced first, so each rank's probabilities are
    the whole softmax's, rounded to the cache dtype as the one-card step
    rounds them, and the partial ``p · V`` sums are all-reduced in fp32
    (the log-sum-exp merge, in two passes)."""

    b, hq, d = q.shape
    hkv = view_k.shape[2]
    g = hq // hkv
    ct = view_k.dtype
    qg = q.reshape(b, hkv, g, d).to(ct).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, view_k.float()) / math.sqrt(d)
    s = torch.where(valid[:, None, None, :], s, torch.full((), -1e30, dtype=s.dtype, device=s.device))
    mx = C.all_reduce(s.amax(-1, keepdim=True), mesh, axes, op="max")
    e = torch.exp(s - mx)
    p_attn = (e / C.all_reduce(e.sum(-1, keepdim=True), mesh, axes)).to(ct)
    o = torch.einsum("bhgs,bshd->bhgd", p_attn.float(), view_v.float())
    return C.all_reduce(o, mesh, axes).reshape(b, hq, d)


__all__ = [
    "COMPUTE_DTYPE",
    "PARAM_DTYPE",
    "AttnConfig",
    "apply_attention",
    "apply_attention_tp",
    "apply_glu_tp",
    "apply_mlp_tp",
    "cache_split_plan",
    "cross_attention_decode_tp",
    "decode_attention_tp",
    "grouped_attention_split",
    "init_placement",
    "apply_glu",
    "apply_mlp",
    "chunked_attention",
    "cross_attention",
    "decode_attention",
    "decode_attention_paged",
    "dense_write_plan",
    "paged_write_plan",
    "dense_init",
    "embed_init",
    "encode_cross_kv",
    "init_attention",
    "init_cross_kv",
    "init_glu",
    "init_mlp",
    "layer_norm",
    "repeat_kv",
    "rms_norm",
    "rope",
    "sinusoidal_positions",
]
