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

Training differentiates through the same wrapper: with grad mode on and
q, k or v requiring grad, :func:`flash_attention_cuda` runs
:class:`FlashAttentionFn`, whose forward launches the kernel's
log-sum-exp variant (the same output, and each row's fp32 log-sum-exp
saved) and whose backward launches two more kernels of the same source:
``flash_attention_bwd_dq`` (one block per q-block, its key blocks) and
``flash_attention_bwd_dkdv`` (one block per key block and KV head, the
q-blocks of its group's query heads that see it, :func:`query_blocks`).
Both recompute ``P`` from the saved log-sum-exp; no sum crosses blocks, so
the gradients are the same bits call after call.  Their plain version is
:func:`flash_attention_bwd_torch`, which walks the same blocks with the
same arithmetic: ``P`` and ``dS = P (dP - D) scale`` in fp32 with ``D =
rowsum(dO o O)``, ``P`` and ``dS`` rounded to the operands' dtype only as
operands of ``dV = P^T dO``, ``dQ = dS K`` and ``dK = dS^T Q``.  The
backward takes head dims up to 128.

The wrapper launches the kernels for CUDA tensors and raises for any
other: on the CPU the attention route, forward and training alike, is
``chunked_attention`` (the ``flash_attn_torch`` backend), and the plain
versions are called by their own names.  ``LAUNCHES`` counts kernel
launches: the inference forward's apart from the training forward's and
the backward's.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

NEG_INF = -1e30
BLOCK_Q = 64  # query rows per CUDA block, as csrc/flash_attention.cu's kBQ
BLOCK_K = 64  # keys per staged block, as its kBK

BWD_MAX_D = 128  # the backward kernels' widest head

LAUNCHES: dict[str, int] = {
    "flash_attention_cuda": 0,
    "flash_attention_fwd_lse": 0,
    "flash_attention_bwd_dq": 0,
    "flash_attention_bwd_dkdv": 0,
}


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


def query_blocks(kb: int, sq: int, sk: int, causal: bool, window: Optional[int]) -> range:
    """The q-blocks the backward's dK/dV kernel visits for key block
    ``kb``: the others see none of its keys (wholly before the causal
    diagonal, or with the block's last key already outside their window)."""

    q_offset = sk - sq
    k0 = kb * BLOCK_K
    n_qb = -(-sq // BLOCK_Q)
    begin = max(k0 - q_offset, 0) // BLOCK_Q if causal else 0
    end = n_qb
    if window is not None:
        hi = window + min(k0 + BLOCK_K, sk) - 2 - q_offset  # the last query its last key serves
        end = 0 if hi < 0 else min(n_qb, hi // BLOCK_Q + 1)
    return range(begin, max(begin, end))


def _visible(q_pos, k_idx, causal: bool, window: Optional[int]):
    """Which keys ``k_idx`` (a row) each query position ``q_pos`` (a
    column) sees."""

    mask = torch.ones((q_pos.shape[0], k_idx.shape[1]), dtype=torch.bool, device=q_pos.device)
    if causal:
        mask &= q_pos >= k_idx
    if window is not None:
        mask &= (q_pos - k_idx) < window
    return mask


def flash_attention_torch(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                          scale: Optional[float] = None, with_lse: bool = False):
    """Plain version of :func:`flash_attention_cuda`, on any device.

    Walks the kernel's q-blocks and, for each, the key blocks it visits
    (:func:`key_blocks`) in order, with the kernel's per-row fp32 online
    softmax; all heads and batch rows of a q-block fold at once.  A key
    block wholly masked for a row changes nothing (``p = 0``, ``alpha =
    1`` after a visible key; before one, what it adds is wiped by ``alpha
    = 0`` at the first visible key), which is why the kernel may skip such
    blocks, per q-block here and also per warp there.  ``with_lse`` also
    returns the training forward's fp32 log-sum-exp ``m + log l`` of each
    row's scaled scores, (B, Hq, Sq).
    """

    b, sq, sk, hq, hkv, d = _check_shapes(q, k, v)
    _check_window(window)
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    dev = q.device
    qg = q.reshape(b, sq, hkv, g, d).float()
    out = torch.empty((b, hkv, g, sq, d), dtype=torch.float32, device=dev)
    lse = torch.empty((b, hkv, g, sq), dtype=torch.float32, device=dev)
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
            mask = _visible(q_idx, k_idx, causal, window)
            s = torch.where(mask, s, torch.full((), NEG_INF, device=dev))
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), vblk.float())
            acc = alpha * acc + pv
            m = m_new
        out[:, :, :, q0:q0 + rows] = acc / torch.clamp(l, min=1e-30)
        lse[..., q0:q0 + rows] = (m + torch.log(l))[..., 0]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)
    return (out, lse.reshape(b, hq, sq)) if with_lse else out


def flash_attention_bwd_torch(q, k, v, o, dout, lse, *, causal: bool = True,
                              window: Optional[int] = None, scale: Optional[float] = None):
    """Plain version of the backward kernels, on any device: ``(dq, dk,
    dv)`` of the attention whose output ``o`` and log-sum-exp ``lse`` (B,
    Hq, Sq) the training forward gave, for the output's gradient ``dout``.

    dQ walks each q-block's key blocks (:func:`key_blocks`), as
    ``flash_attention_bwd_dq`` does; dK and dV walk each key block's
    q-blocks (:func:`query_blocks`), all query heads of a KV head's group
    summed into one accumulator, as ``flash_attention_bwd_dkdv`` does.  The
    arithmetic is the kernels': fp32 ``P = exp(scale s - lse)`` on the
    visible keys and 0 elsewhere, ``D = rowsum(dO o O)``, ``dS = P (dP - D)
    scale`` in fp32, ``P`` and ``dS`` rounded to v's and q's dtype as
    operands, fp32 sums, each gradient returned in its input's dtype (the
    kernels take each ``exp`` as ``exp2``, which rounds differently in the
    last bit).
    """

    b, sq, sk, hq, hkv, d = _check_shapes(q, k, v)
    _check_window(window)
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    dev = q.device
    qf = q.reshape(b, sq, hkv, g, d).float()
    dof = dout.reshape(b, sq, hkv, g, d).float()
    kf, vf = k.float(), v.float()
    lse = lse.reshape(b, hkv, g, sq).float()
    delta = (dof * o.reshape(b, sq, hkv, g, d).float()).sum(-1).permute(0, 2, 3, 1)

    def block(q0, rows, k0, keys):
        """``P`` and ``dS`` (B, Hkv, G, rows, keys) of one (q-block, key block)."""

        qs, ks = slice(q0, q0 + rows), slice(k0, k0 + keys)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf[:, qs], kf[:, ks]) * scale
        q_pos = torch.arange(q0, q0 + rows, device=dev)[:, None] + (sk - sq)
        mask = _visible(q_pos, torch.arange(k0, k0 + keys, device=dev)[None, :], causal, window)
        p = torch.where(mask, torch.exp(s - lse[..., qs, None]), 0.0)
        dp = torch.einsum("bqhgd,bkhd->bhgqk", dof[:, qs], vf[:, ks])
        ds = torch.where(mask, p * (dp - delta[..., qs, None]) * scale, 0.0)
        return p, ds

    dq = torch.zeros((b, hkv, g, sq, d), dtype=torch.float32, device=dev)
    for q0 in range(0, sq, BLOCK_Q):
        rows = min(BLOCK_Q, sq - q0)
        for kb in key_blocks(q0, sq, sk, causal, window):
            k0 = kb * BLOCK_K
            keys = min(BLOCK_K, sk - k0)
            _, ds = block(q0, rows, k0, keys)
            dq[..., q0:q0 + rows, :] += torch.einsum(
                "bhgqk,bkhd->bhgqd", ds.to(q.dtype).float(), kf[:, k0:k0 + keys])
    dk = torch.zeros((b, sk, hkv, d), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    for kb in range(-(-sk // BLOCK_K)):
        k0 = kb * BLOCK_K
        keys = min(BLOCK_K, sk - k0)
        for qb in query_blocks(kb, sq, sk, causal, window):
            q0 = qb * BLOCK_Q
            rows = min(BLOCK_Q, sq - q0)
            p, ds = block(q0, rows, k0, keys)
            dv[:, k0:k0 + keys] += torch.einsum(
                "bhgqk,bqhgd->bkhd", p.to(v.dtype).float(), dof[:, q0:q0 + rows])
            dk[:, k0:k0 + keys] += torch.einsum(
                "bhgqk,bqhgd->bkhd", ds.to(q.dtype).float(), qf[:, q0:q0 + rows])
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


_FNS: dict = {}

# C entry point -> its arguments after the pointers: B, Sq, Sk, Hq, Hkv, D,
# causal, window, scale, stream.
_ENTRIES = {"repro_flash_attention": 4, "repro_flash_attention_lse": 5,
            "repro_flash_attention_bwd": 10}


def _kernel(entry: str = "repro_flash_attention"):
    fn = _FNS.get(entry)
    if fn is None:
        from repro_torch.kernels import build

        fn = getattr(build.load("flash_attention"), entry)
        fn.argtypes = ([ctypes.c_void_p] * _ENTRIES[entry] + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FNS[entry] = fn
    return fn


def _checked(q, k, v, causal: bool, window: Optional[int], d_max: int, what: str):
    """Validate a kernel call's q, k, v (the kernels' shapes, one CUDA
    device, bf16, 16-byte aligned rows); returns them contiguous and the
    shape numbers."""

    shape = _check_shapes(q, k, v)
    _check_window(window)
    b, sq, sk, hq, hkv, d = shape
    if k.device != q.device or v.device != q.device or q.device.type != "cuda":
        raise ValueError(f"{what} needs q, k and v on one CUDA device, got "
                         f"{q.device}/{k.device}/{v.device}")
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
        raise TypeError(f"{what} takes bf16 q, k, v, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d % 8 or d > d_max:
        raise ValueError(f"{what}: head dim {d} at q {tuple(q.shape)}, k {tuple(k.shape)}: the "
                         f"kernel takes a multiple of 8 up to {d_max}")
    if causal and sq > sk:
        raise ValueError(f"causal attention with {sq} queries over {sk} keys: queries "
                         f"must be a suffix of the keys")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{what} reads 16-byte rows: q, k, v must be 16-byte aligned")
    return q, k, v, shape


def _launch(entry: str, ptrs: list, shape, causal, window, scale, device, what: str) -> None:
    from repro_torch.kernels import build

    b, sq, sk, hq, hkv, d = shape
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = _kernel(entry)(*ptrs, b, sq, sk, hq, hkv, d, int(causal), int(window or 0),
                                float(scale), stream)
    build.check(status, f"{what} B={b} Sq={sq} Sk={sk} Hq={hq} Hkv={hkv} D={d} "
                        f"causal={causal} window={window}")


def _forward_lse(q, k, v, shape, causal, window, scale):
    """The training forward: the output and the fp32 log-sum-exp, (B, Hq,
    Sq rounded up to ``BLOCK_Q``; the rows past Sq read 0)."""

    b, sq, _, hq, _, _ = shape
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, -(-sq // BLOCK_Q) * BLOCK_Q), dtype=torch.float32, device=q.device)
    _launch("repro_flash_attention_lse",
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr()],
            shape, causal, window, scale, q.device, "flash_attention_fwd_lse")
    LAUNCHES["flash_attention_fwd_lse"] += 1
    return out, lse


class FlashAttentionFn(torch.autograd.Function):
    """The differentiable flash attention: the log-sum-exp forward, saving
    q, k, v, the output and the log-sum-exp; the two backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        q, k, v, shape = _checked(q, k, v, causal, window, BWD_MAX_D,
                                  "flash attention's training forward")
        out, lse = _forward_lse(q, k, v, shape, causal, window, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.attn = (shape, causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        shape, causal, window, scale = ctx.attn
        dout = dout.contiguous()
        if dout.data_ptr() % 16:  # the kernels read 16-byte rows
            dout = dout.clone()
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        delta = torch.empty_like(lse)
        _launch("repro_flash_attention_bwd",
                [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr()],
                shape, causal, window, scale, q.device, "flash attention's backward")
        LAUNCHES["flash_attention_bwd_dq"] += 1
        LAUNCHES["flash_attention_bwd_dkdv"] += 1
        return dq, dk, dv, None, None, None


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Full-sequence attention through the CUDA kernels: CUDA tensors
    launch them, anything else raises (no fallback to the plain version).
    With grad mode on and q, k or v requiring grad, the call is
    :class:`FlashAttentionFn` (head dims up to 128); otherwise the
    inference kernel."""

    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, scale)
    q, k, v, shape = _checked(q, k, v, causal, window, 256, "flash_attention_cuda")
    out = torch.empty_like(q)
    _launch("repro_flash_attention", [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()],
            shape, causal, window, scale, q.device, "flash_attention_cuda")
    LAUNCHES["flash_attention_cuda"] += 1
    return out


__all__ = [
    "BLOCK_K",
    "BLOCK_Q",
    "BWD_MAX_D",
    "FlashAttentionFn",
    "LAUNCHES",
    "NEG_INF",
    "flash_attention_bwd_torch",
    "flash_attention_cuda",
    "flash_attention_torch",
    "key_blocks",
    "query_blocks",
    "reset_launches",
]
