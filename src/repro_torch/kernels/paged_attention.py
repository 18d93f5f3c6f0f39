"""Ragged paged-attention decode (single-token query, paged KV) for Hopper.

The port's counterpart of ``repro.kernels.paged_attention``.  Two routes,
both in ``execution.BACKENDS`` (op family ``"paged_attn"``):

  * :func:`paged_attention_torch` — the gather route (the reference's
    ``paged_attention_xla``): gather + masked softmax in exactly the dense
    decode path's op sequence, so on identical cache *values* it is
    bitwise equal to ``layers.decode_attention`` over a dense lane.  It is
    the plain version of the kernel below, and what the wrapper runs for
    CPU tensors.
  * :func:`paged_attention_cuda` — the CUDA kernel (``csrc/
    paged_attention.cu``, replacing ``paged_attention_pallas``): each
    row's walk over its cache split into runs of pages (:func:`split_plan`,
    from the shapes alone), one block per (row, KV head, run) serving the
    group's query heads, K/V moved in 16-byte ``cp.async`` copies through a
    ring of position tiles, both products on the tensor cores, the runs'
    partials combined in a fixed order.
    Tolerance-equal to the gather route, not bitwise; bitwise equal to
    itself from call to call.

:func:`paged_attention_split_torch` is the kernel's walk in eager PyTorch
(the runs, each walked by :data:`WARPS` warps whose online softmaxes round
``p`` against their own running max, then the combine).  Tests use it; no
path runs it.

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
import functools
import math
from typing import NamedTuple

import torch

NEG_INF = -1e30
# The kernel's constants (csrc/paged_attention.cu): its warps, the
# positions in one warp's tile, the most query heads a KV head serves (the
# rows of one tensor-core tile), the longest head dim, and the most pages
# one block's run may hold (its page ids sit in shared memory).
WARPS = 4
WARP_TILE = 16
MAX_GROUP = 8
MAX_HEAD_DIM = 256
MAX_SPLIT_PAGES = 1024
# split_plan's targets: blocks an SM (the kernel holds three at a head dim
# of 128, so all of them run in one wave), and the shortest run worth a
# block of its own, in positions.
BLOCKS_PER_SM = 2
MIN_SPLIT = 128

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


class SplitPlan(NamedTuple):
    """How the kernel splits each row's walk: ``n_split`` runs of ``pages``
    pages (the last may hold fewer), together exactly ``[0, W * ps)``."""

    n_split: int
    pages: int


@functools.lru_cache(maxsize=None)
def split_plan(b: int, hkv: int, w: int, ps: int, n_sm: int) -> SplitPlan:
    """The runs for a call of ``b`` rows, ``hkv`` KV heads and ``w`` pages
    of ``ps`` tokens a row, on a card of ``n_sm`` SMs.

    Reads shapes only, never ``pos``: the positions live on the card, and
    reading them would synchronise the stream inside every decode step.
    Aims at :data:`BLOCKS_PER_SM` blocks an SM, with runs of about
    :data:`MIN_SPLIT` positions or more (so a short cache, as the engine's
    24-token slot, runs one split and one launch) and no more than
    :data:`MAX_SPLIT_PAGES` pages.
    """

    if min(b, hkv, w, ps, n_sm) < 1:
        raise ValueError(f"split_plan needs positive shapes, got b={b} hkv={hkv} w={w} ps={ps} n_sm={n_sm}")
    want = -(-BLOCKS_PER_SM * n_sm // (b * hkv))
    n = max(1, min(want, (w * ps) // MIN_SPLIT, w))
    pages = -(-w // n)
    if -(-w // pages) < n:  # rounding the runs up lost a split: round them down
        pages = w // n
    pages = min(pages, MAX_SPLIT_PAGES)
    return SplitPlan(-(-w // pages), pages)


def split_partials(q, pages_k, pages_v, page_table, pos, plan: SplitPlan):
    """The kernel's runs in eager PyTorch: per (row, run, KV head, query
    head) the run's max ``m``, sum ``l`` and accumulator ``acc`` (fp32).

    As in the kernel, :data:`WARPS` warps walk each run, warp ``w`` taking
    the ``w``-th tile of :data:`WARP_TILE` positions of every ``WARPS``,
    each an online softmax over its tiles (``p`` rounded to the cache dtype
    against the warp's running max); the warps then merge in order.  A warp
    or a run wholly past its row's limit is empty: ``m = -1e30``, ``l =
    0``, ``acc = 0``.
    """

    b, hq, d, _, ps, hkv, w = _check_shapes(q, pages_k, pages_v, page_table, pos)
    if plan.n_split != -(-w // plan.pages):
        raise ValueError(f"{plan} does not tile {w} pages")
    g, ct, dev = hq // hkv, pages_k.dtype, q.device
    n, s_cache, length = plan.n_split, w * ps, plan.pages * ps
    tiles = -(-length // (WARPS * WARP_TILE))
    padded = tiles * WARPS * WARP_TILE

    def runs(pages):  # (B, n, tiles, WARPS, WARP_TILE, Hkv, Dh), zeros past each run
        view = paged_gather(pages, page_table)
        view = torch.cat([view, view.new_zeros((b, n * length - s_cache, hkv, d))], 1)
        view = view.reshape(b, n, length, hkv, d)
        view = torch.cat([view, view.new_zeros((b, n, padded - length, hkv, d))], 2)
        return view.reshape(b, n, tiles, WARPS, WARP_TILE, hkv, d)

    view_k, view_v = runs(pages_k), runs(pages_v)
    off = torch.arange(padded, device=dev)
    idx = torch.arange(n, device=dev)[:, None] * length + off  # (n, padded) cache positions
    limit = torch.clamp(pos.long() + 1, max=s_cache)[:, None, None]
    valid = ((off < length) & (idx < limit)).reshape(b, n, tiles, WARPS, WARP_TILE)
    qg = q.reshape(b, hkv, g, d).to(ct).float()
    scale = 1.0 / math.sqrt(d)
    m = torch.full((b, n, WARPS, hkv, g), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, n, WARPS, hkv, g, d), dtype=torch.float32, device=dev)
    for t in range(tiles):
        s = torch.einsum("bhgd,bnwthd->bnwhgt", qg, view_k[:, :, t].float()) * scale
        s = torch.where(valid[:, :, t, :, None, None, :], s, torch.full((), NEG_INF, device=dev))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1)
        pv = torch.einsum("bnwhgt,bnwthd->bnwhgd", p.to(ct).float(), view_v[:, :, t].float())
        acc = alpha[..., None] * acc + pv
        m = m_new
    walked = valid[:, :, 0, :, 0][..., None, None]  # a warp walks iff its first position is visible
    l, acc = torch.where(walked, l, 0.0), torch.where(walked[..., None], acc, 0.0)
    # The warps merge in order, as the partials of one run.
    m_run = m.amax(dim=2)
    wgt = torch.exp(m - m_run[:, :, None])
    return m_run, (wgt * l).sum(dim=2), (wgt[..., None] * acc).sum(dim=2)


def combine_splits(m, l, acc) -> torch.Tensor:
    """The kernel's combine, in run order: ``sum_s e^(m_s - M) acc_s /
    max(sum_s e^(m_s - M) l_s, 1e-30)`` with ``M`` the runs' max; fp32
    ``(B, Hkv, G, Dh)``."""

    wgt = torch.exp(m - m.amax(dim=1, keepdim=True))
    return (wgt[..., None] * acc).sum(dim=1) / torch.clamp((wgt * l).sum(dim=1), min=1e-30)[..., None]


def paged_attention_split_torch(q, pages_k, pages_v, page_table, pos, plan: SplitPlan) -> torch.Tensor:
    """The kernel's walk in eager PyTorch: :func:`split_partials` under
    ``plan``, then :func:`combine_splits`.  Tolerance-equal to the gather
    route; for tests only (the wrapper's CPU route is the gather route)."""

    b, hq, d = q.shape
    out = combine_splits(*split_partials(q, pages_k, pages_v, page_table, pos, plan))
    return out.reshape(b, hq, d).to(q.dtype)


_FN = None


def _kernel():
    global _FN
    if _FN is None:
        from repro_torch.kernels import build

        fn = build.load("paged_attention").repro_paged_attention
        fn.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device (one query a process)."""

    return _sm_count(device.index if device.index is not None else torch.cuda.current_device())


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the kernel's vector loads)."""

    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def paged_attention_cuda(q, pages_k, pages_v, page_table, pos) -> torch.Tensor:
    """Paged decode attention through the CUDA kernel.

    CPU tensors run the plain version (:func:`paged_attention_torch`);
    CUDA tensors launch the kernel (and, when :func:`split_plan` gives more
    than one run, its combine) or raise.  One call counts one launch.
    """

    from repro_torch.kernels import build

    b, hq, d, p_total, ps, hkv, w = _check_shapes(q, pages_k, pages_v, page_table, pos)
    dev = q.device
    if not (dev.type == "cuda" and pages_k.device == dev and pages_v.device == dev
            and page_table.device == dev and pos.device == dev):
        if all(t.device.type == "cpu" for t in (q, pages_k, pages_v, page_table, pos)):
            return paged_attention_torch(q, pages_k, pages_v, page_table, pos)
        raise ValueError("paged_attention_cuda needs every operand on one CUDA device")
    if q.dtype != torch.bfloat16 or pages_k.dtype != torch.bfloat16 or pages_v.dtype != torch.bfloat16:
        raise TypeError("paged_attention_cuda takes bf16 queries and pages")
    if page_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("paged_attention_cuda takes int32 page tables and positions")
    if hq // hkv > MAX_GROUP or d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"unsupported group {hq // hkv} / head dim {d} "
                         f"(group <= {MAX_GROUP}; head dim a multiple of 8, <= {MAX_HEAD_DIM})")
    if dev.index is not None and dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return paged_attention_cuda(q, pages_k, pages_v, page_table, pos)
    out = torch.empty_like(q)
    if b == 0:
        return out
    q, pages_k, pages_v = _aligned(q), _aligned(pages_k), _aligned(pages_v)
    page_table, pos = page_table.contiguous(), pos.contiguous()
    plan = split_plan(b, hkv, w, ps, sm_count(dev))
    ws = None
    if plan.n_split > 1:
        ws = torch.empty(b * hkv * plan.n_split * (hq // hkv) * (d + 2), dtype=torch.float32,
                         device=dev)
    status = _kernel()(
        q.data_ptr(), pages_k.data_ptr(), pages_v.data_ptr(), page_table.data_ptr(),
        pos.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(),
        b, hq, hkv, d, p_total, ps, w, plan.pages, plan.n_split, 1.0 / math.sqrt(d),
        torch.cuda.current_stream().cuda_stream,
    )
    build.check(status, f"paged_attention_cuda B={b} Hq={hq} Hkv={hkv} Dh={d} P={p_total} ps={ps} "
                        f"W={w} {plan}")
    LAUNCHES["paged_attention_cuda"] += 1
    return out


__all__ = [
    "BLOCKS_PER_SM",
    "LAUNCHES",
    "MAX_GROUP",
    "MAX_HEAD_DIM",
    "MAX_SPLIT_PAGES",
    "MIN_SPLIT",
    "NEG_INF",
    "SplitPlan",
    "WARPS",
    "WARP_TILE",
    "combine_splits",
    "grouped_attention",
    "paged_attention_cuda",
    "paged_attention_split_torch",
    "paged_attention_torch",
    "paged_gather",
    "reset_launches",
    "sm_count",
    "split_partials",
    "split_plan",
    "valid_mask",
]
