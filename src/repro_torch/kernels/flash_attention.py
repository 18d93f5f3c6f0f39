"""Blocked (flash) attention over (B, S, H, D) for Hopper (CUDA C++).

The port's counterpart of ``repro.kernels.flash_attention``: the
full-sequence attention of the prefill / scoring / eval forward, run once
per layer.  Two functions compute it:

  * :func:`flash_attention_cuda` — the kernel (``csrc/flash_attention.cu``,
    replacing ``flash_attention``'s ``pl.pallas_call``): one block of 4
    warps per (64-row q-block, query head, batch row), each warp 16 query
    rows, looping over 64-key blocks that a two-stage ``cp.async`` ring
    brings into shared memory.  Both products run on the tensor cores
    (``mma.sync`` m16n8k16, fp32 sums); the fp32 online softmax runs on
    the score fragments in registers, and ``p`` goes to the ``p · V``
    product as bf16 fragments without touching shared memory.  Key blocks
    wholly past the causal diagonal or before the window are skipped.  It
    reads K/V head ``h // (Hq / Hkv)`` in place, so GQA costs no repeated
    K/V.
  * :func:`flash_attention_torch` — its plain version, the oracle the
    kernel is held to: the same (q-block, key-block) walk with the same
    block sizes and skipped blocks, and the same arithmetic (fp32 scores
    scaled after the product, ``-1e30`` masking, ``p`` rounded to the
    value dtype before ``p · V``, fp32 ``m``/``l``/``acc``, ``acc /
    max(l, 1e-30)`` at the end; the kernel takes each ``exp`` as ``exp2``
    of a score kept in base 2, which rounds differently in the last bit).

Shapes: q (B, Sq, Hq, D); k, v (B, Sk, Hkv, D) with ``Hq % Hkv == 0``.
Queries are the suffix of the keys: query ``i`` sits at key position
``i + Sk - Sq`` (the reference's ``q_offset``).  The kernel needs
``Sq <= Sk`` when causal, so that every query sees a key; the reference
gives a query that sees none the mean of the padded values, which depends
on its block size and is no attention at all.

The wrapper launches the kernel for CUDA tensors and raises for any
other: on the CPU the forward's attention route is ``chunked_attention``
(the ``flash_attn_torch`` backend), and the plain version is called by its
own name.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

NEG_INF = -1e30
BLOCK_Q = 64  # query rows per CUDA block, as csrc/flash_attention.cu's kBQ
BLOCK_K = 64  # keys per staged block, as its kBK

LAUNCHES: dict[str, int] = {"flash_attention_cuda": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_shapes(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"attention takes (B, S, H, D) q, k, v: got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, hq, d = q.shape
    b2, sk, hkv, d2 = k.shape
    if b2 != b or d2 != d or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} incompatible with k/v {tuple(k.shape)}")
    return b, sq, sk, hq, hkv, d


def _check_window(window: Optional[int]) -> None:
    if window is not None and window < 1:
        raise ValueError(f"window {window} < 1 masks every key")


def key_blocks(q0: int, sq: int, sk: int, causal: bool, window: Optional[int]) -> range:
    """The key blocks the kernel visits for the q-block starting at query
    ``q0``: the others lie wholly past the causal diagonal or wholly
    before the window for every row of the q-block."""

    q_offset = sk - sq
    kb_end = -(-sk // BLOCK_K)
    if causal:
        kb_end = min(kb_end, (q_offset + min(q0 + BLOCK_Q, sq) - 1) // BLOCK_K + 1)
    lo = q_offset + q0 - window + 1 if window is not None else 0
    return range(max(lo, 0) // BLOCK_K, kb_end)


def flash_attention_torch(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of :func:`flash_attention_cuda`, on any device.

    Walks the kernel's q-blocks and, for each, the key blocks it visits
    (:func:`key_blocks`) in order, with the kernel's per-row fp32 online
    softmax; all heads and batch rows of a q-block fold at once.  A key
    block wholly masked for a row changes nothing (``p = 0``, ``alpha =
    1`` after a visible key; before one, what it adds is wiped by ``alpha
    = 0`` at the first visible key), which is why the kernel may skip such
    blocks, per q-block here and also per warp there.
    """

    b, sq, sk, hq, hkv, d = _check_shapes(q, k, v)
    _check_window(window)
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    dev = q.device
    qg = q.reshape(b, sq, hkv, g, d).float()
    out = torch.empty((b, hkv, g, sq, d), dtype=torch.float32, device=dev)
    for q0 in range(0, sq, BLOCK_Q):
        rows = min(BLOCK_Q, sq - q0)
        qb = qg[:, q0:q0 + rows]
        q_idx = torch.arange(q0, q0 + rows, device=dev)[:, None] + (sk - sq)  # (rows, 1)
        m = torch.full((b, hkv, g, rows, 1), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, hkv, g, rows, 1), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, g, rows, d), dtype=torch.float32, device=dev)
        for kb in key_blocks(q0, sq, sk, causal, window):
            k0 = kb * BLOCK_K
            kblk, vblk = k[:, k0:k0 + BLOCK_K], v[:, k0:k0 + BLOCK_K]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kblk.float()) * scale
            k_idx = torch.arange(k0, k0 + kblk.shape[1], device=dev)[None, :]
            mask = torch.ones((rows, kblk.shape[1]), dtype=torch.bool, device=dev)
            if causal:
                mask &= q_idx >= k_idx
            if window is not None:
                mask &= (q_idx - k_idx) < window
            s = torch.where(mask, s, torch.full((), NEG_INF, device=dev))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), vblk.float())
            acc = alpha * acc + pv
            m = m_new
        out[:, :, :, q0:q0 + rows] = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)


_FN = None


def _kernel():
    global _FN
    if _FN is None:
        from repro_torch.kernels import build

        fn = build.load("flash_attention").repro_flash_attention
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Full-sequence attention through the CUDA kernel: CUDA tensors
    launch it, anything else raises (no fallback to the plain version)."""

    from repro_torch.kernels import build

    b, sq, sk, hq, hkv, d = _check_shapes(q, k, v)
    _check_window(window)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if k.device != q.device or v.device != q.device or q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs q, k and v on one CUDA device, got "
                         f"{q.device}/{k.device}/{v.device}")
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention_cuda takes bf16 q, k, v, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d % 8 or d > 256:
        raise ValueError(f"head dim {d}: the kernel takes a multiple of 8 up to 256")
    if causal and sq > sk:
        raise ValueError(f"causal attention with {sq} queries over {sk} keys: queries "
                         f"must be a suffix of the keys")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention_cuda reads 16-byte rows: q, k, v must be 16-byte aligned")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        status = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, sq, sk, hq, hkv, d, int(causal), int(window or 0), float(scale), stream,
        )
    build.check(status, f"flash_attention_cuda B={b} Sq={sq} Sk={sk} Hq={hq} Hkv={hkv} D={d} "
                        f"causal={causal} window={window}")
    LAUNCHES["flash_attention_cuda"] += 1
    return out


__all__ = [
    "BLOCK_K",
    "BLOCK_Q",
    "LAUNCHES",
    "NEG_INF",
    "flash_attention_cuda",
    "flash_attention_torch",
    "key_blocks",
    "reset_launches",
]
