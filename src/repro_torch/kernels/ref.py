"""Plain-PyTorch oracles for the kernels (the port's ``repro.kernels.ref``).

  * :func:`gemm_ref` — the ground truth: one fp32 product, cast once.
  * :func:`blocked_gemm_ref` — the paper's Figure 1 five-loop BLIS
    algorithm written out in numpy (Loop 1 over ``n_c``, Loop 2 over
    ``k_c`` packing ``B_c``, Loop 3 over ``m_c`` packing ``A_c``, Loops
    4/5 over ``n_r``/``m_r`` around the micro-kernel); small shapes only.
  * :func:`blocked_gemm_tile_ref` — the tile-order oracle (the reference's
    ``blocked_gemm_tpu_ref``): per-(bm, bn) fp32 accumulators over bk
    slices, the kernels' block structure written out.
  * :func:`attention_ref` — dense (B, S, H, D) attention in fp32 end to
    end with the causal (queries are the suffix of the keys) and sliding
    window masks, masked scores at the finite ``-1e30``.
  * :func:`paged_attention_ref` — paged decode attention in fp32 end to
    end, deliberately *not* the production op order (ungrouped fp32
    einsums over an eagerly gathered view).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core.blocking import BlockConfig, GotoBlocking


def gemm_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """C = A @ B with fp32 accumulation (the oracle)."""

    out_dtype = out_dtype or a.dtype
    return (a.float() @ b.float()).to(out_dtype)


def blocked_gemm_ref(a: np.ndarray, b: np.ndarray, cfg: GotoBlocking) -> np.ndarray:
    """Paper Figure 1, verbatim loop structure (numpy, fp32 accumulate)."""

    m, k = a.shape
    k2, n = b.shape
    assert k == k2
    c = np.zeros((m, n), np.float32)
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)

    for jc in range(0, n, cfg.nc):                      # Loop 1
        nc = min(cfg.nc, n - jc)
        for pc in range(0, k, cfg.kc):                  # Loop 2
            kc = min(cfg.kc, k - pc)
            b_c = b[pc:pc + kc, jc:jc + nc].copy()      # pack B_c
            for ic in range(0, m, cfg.mc):              # Loop 3
                mc = min(cfg.mc, m - ic)
                a_c = a[ic:ic + mc, pc:pc + kc].copy()  # pack A_c
                for jr in range(0, nc, cfg.nr):         # Loop 4
                    nr = min(cfg.nr, nc - jr)
                    for ir in range(0, mc, cfg.mr):     # Loop 5
                        mr = min(cfg.mr, mc - ir)
                        # Micro-kernel: rank-k_c update of an m_r x n_r tile.
                        c[ic + ir:ic + ir + mr, jc + jr:jc + jr + nr] += (
                            a_c[ir:ir + mr, :] @ b_c[:, jr:jr + nr]
                        )
    return c


def blocked_gemm_tile_ref(a: torch.Tensor, b: torch.Tensor, cfg: BlockConfig) -> torch.Tensor:
    """Block-accumulation oracle matching the CUDA kernels' tiling."""

    m, k = a.shape
    n = b.shape[1]
    out = torch.zeros((m, n), dtype=torch.float32, device=a.device)
    for i0 in range(0, m, cfg.bm):
        for j0 in range(0, n, cfg.bn):
            acc = torch.zeros(
                (min(cfg.bm, m - i0), min(cfg.bn, n - j0)), dtype=torch.float32, device=a.device
            )
            for k0 in range(0, k, cfg.bk):
                ab = a[i0:i0 + cfg.bm, k0:k0 + cfg.bk].float()
                bb = b[k0:k0 + cfg.bk, j0:j0 + cfg.bn].float()
                acc = acc + ab @ bb
            out[i0:i0 + cfg.bm, j0:j0 + cfg.bn] = acc
    return out.to(a.dtype)


def attention_ref(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """Dense (B, Sq, H, D) attention oracle, fp32 end to end; ``k``/``v``
    (B, Sk, H, D) share the query heads.  Queries are the suffix of the
    keys (query ``i`` sits at key position ``i + Sk - Sq``)."""

    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    ki = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= ki
    if window is not None:
        mask &= qi - ki < window
    s = torch.where(mask[None, None], s, torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)


def paged_attention_ref(q, pages_k, pages_v, page_table, pos) -> torch.Tensor:
    """Paged single-token decode-attention oracle (fp32 end to end)."""

    b, hq, d = q.shape
    p, ps, hkv, _ = pages_k.shape
    w = page_table.shape[1]
    s_cache = w * ps
    g = hq // hkv
    idx = torch.clamp(page_table.long(), 0, p - 1)
    view_k = pages_k[idx].reshape(b, s_cache, hkv, d).float()
    view_v = pages_v[idx].reshape(b, s_cache, hkv, d).float()
    qf = q.reshape(b, hkv, g, d).float()
    s = torch.einsum("bhgd,bshd->bhgs", qf, view_k) / math.sqrt(d)
    limit = torch.clamp(pos.long()[:, None] + 1, max=s_cache)
    valid = torch.arange(s_cache, device=q.device)[None, :] < limit
    s = torch.where(valid[:, None, None, :], s, torch.full((), -1e30, device=q.device))
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", pr, view_v)
    return o.reshape(b, hq, d).to(q.dtype)


__all__ = ["attention_ref", "blocked_gemm_ref", "blocked_gemm_tile_ref", "gemm_ref",
           "paged_attention_ref"]
