"""Ragged paged-attention decode (single-token query, paged KV) for Hopper.

The port's counterpart of ``repro.kernels.paged_attention``.  Two routes,
both in ``execution.BACKENDS`` (op family ``"paged_attn"``):

  * :func:`paged_attention_torch` — the gather route (the reference's
    ``paged_attention_xla``): gather + masked softmax in exactly the dense
    decode path's op sequence, so on identical cache *values* it is
    bitwise equal to ``layers.decode_attention`` over a dense lane.  It is
    the plain version of the kernel below.
  * :func:`paged_attention_cuda` — the CUDA kernel (``csrc/
    paged_attention.cu``, replacing ``paged_attention_pallas``): one block
    per (row, kv-head), the block reading its own page ids, online softmax
    in fp32.  Tolerance-equal to the gather route, not bitwise.

Shapes (one decode token per row):

  q           (B, Hq, Dh)        the new token's query heads
  pages_k/v   (P, ps, Hkv, Dh)   the page arena (one layer's)
  page_table  (B, W)  int32      per-row page ids; ``W * ps == s_cache``
  pos         (B,)    int32      per-row absolute positions (>= 0)

A row attends ``[0, min(pos+1, s_cache))``; table entries clip to
``[0, P-1]`` and the mask hides every position a clipped sentinel backs.
"""

from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30

LAUNCHES: dict[str, int] = {"paged_attention_cuda": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_shapes(q, pages_k, pages_v, page_table, pos):
    b, hq, d = q.shape
    p, ps, hkv, d2 = pages_k.shape
    if pages_v.shape != pages_k.shape:
        raise ValueError(f"k/v arenas differ: {tuple(pages_k.shape)} vs {tuple(pages_v.shape)}")
    if d2 != d or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} incompatible with pages {tuple(pages_k.shape)}")
    if page_table.shape[0] != b or tuple(pos.shape) != (b,):
        raise ValueError(
            f"table {tuple(page_table.shape)} / pos {tuple(pos.shape)} do not cover batch {b}"
        )
    return b, hq, d, p, ps, hkv, page_table.shape[1]


def paged_gather(pages: torch.Tensor, page_table: torch.Tensor) -> torch.Tensor:
    """Materialize per-row dense views: (P, ps, H, D) → (B, W·ps, H, D).

    Sentinel entries clip to the last page; the caller's validity mask
    must exclude every position they back (the pool's invariant).
    """

    p, ps, h, d = pages.shape
    b, w = page_table.shape
    idx = torch.clamp(page_table.long(), 0, p - 1)
    view = pages[idx]  # (B, W, ps, H, D)
    return view.reshape(b, w * ps, h, d)


def valid_mask(pos: torch.Tensor, s_cache: int) -> torch.Tensor:
    """(B, s_cache) bool — ``k_idx < min(pos+1, s_cache)``."""

    k_idx = torch.arange(s_cache, device=pos.device)
    limit = torch.clamp(pos.long()[:, None] + 1, max=s_cache)
    return k_idx[None, :] < limit


def grouped_attention(q, view_k, view_v, valid) -> torch.Tensor:
    """Single-token GQA attention over dense per-row views.

    q (B, Hq, Dh); view_k/v (B, S, Hkv, Dh) in the cache dtype; valid
    (B, S) bool.  fp32 scores scaled by ``1/sqrt(Dh)``, ``-1e30`` mask,
    fp32 softmax, probabilities rounded to the cache dtype, fp32 p·V —
    the one op sequence the dense and paged decode paths share, which is
    what makes them bitwise equal on equal cache values.
    """

    b, hq, d = q.shape
    hkv = view_k.shape[2]
    g = hq // hkv
    ct = view_k.dtype
    qg = q.reshape(b, hkv, g, d).to(ct).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, view_k.float()) / math.sqrt(d)
    s = torch.where(valid[:, None, None, :], s, torch.full((), NEG_INF, dtype=s.dtype, device=s.device))
    p_attn = torch.softmax(s, dim=-1).to(ct)
    o = torch.einsum("bhgs,bshd->bhgd", p_attn.float(), view_v.float())
    return o.reshape(b, hq, d)


def paged_attention_torch(q, pages_k, pages_v, page_table, pos) -> torch.Tensor:
    """Gather route — the dense decode arithmetic over a paged gather.

    The plain version of :func:`paged_attention_cuda`.  Masked lanes
    contribute exactly 0.0, so the output is independent of whatever lies
    behind sentinel pages.
    """

    _, _, _, _, ps, _, w = _check_shapes(q, pages_k, pages_v, page_table, pos)
    s_cache = w * ps
    view_k = paged_gather(pages_k, page_table)
    view_v = paged_gather(pages_v, page_table)
    o = grouped_attention(q, view_k, view_v, valid_mask(pos, s_cache))
    return o.to(q.dtype)


_FN = None


def _kernel():
    global _FN
    if _FN is None:
        from repro_torch.kernels import build

        fn = build.load("paged_attention").repro_paged_attention
        fn.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def paged_attention_cuda(q, pages_k, pages_v, page_table, pos) -> torch.Tensor:
    """Paged decode attention through the CUDA kernel.

    CPU tensors run the plain version (:func:`paged_attention_torch`);
    CUDA tensors launch the kernel or raise.
    """

    from repro_torch.kernels import build

    b, hq, d, p_total, ps, hkv, w = _check_shapes(q, pages_k, pages_v, page_table, pos)
    tensors = (q, pages_k, pages_v, page_table, pos)
    if all(t.device.type == "cpu" for t in tensors):
        return paged_attention_torch(q, pages_k, pages_v, page_table, pos)
    if any(t.device != q.device for t in tensors) or q.device.type != "cuda":
        raise ValueError("paged_attention_cuda needs every operand on one CUDA device")
    if q.dtype != torch.bfloat16 or pages_k.dtype != torch.bfloat16 or pages_v.dtype != torch.bfloat16:
        raise TypeError("paged_attention_cuda takes bf16 queries and pages")
    if page_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("paged_attention_cuda takes int32 page tables and positions")
    if hq // hkv > 8 or d > 256:
        raise ValueError(f"unsupported group {hq // hkv} / head dim {d} (max 8 / 256)")
    q, pages_k, pages_v = q.contiguous(), pages_k.contiguous(), pages_v.contiguous()
    page_table, pos = page_table.contiguous(), pos.contiguous()
    out = torch.empty_like(q)
    if b == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = _kernel()(
            q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr(),
            page_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
            b, hq, hkv, d, p_total, ps, w, 1.0 / math.sqrt(d), stream,
        )
    build.check(status, f"paged_attention_cuda B={b} Hq={hq} Hkv={hkv} Dh={d} P={p_total} ps={ps} W={w}")
    LAUNCHES["paged_attention_cuda"] += 1
    return out


__all__ = [
    "LAUNCHES",
    "NEG_INF",
    "grouped_attention",
    "paged_attention_cuda",
    "paged_attention_torch",
    "paged_gather",
    "reset_launches",
    "valid_mask",
]
