"""Plain-PyTorch oracles for the kernels (the port's ``repro.kernels.ref``).

  * :func:`gemm_ref` — the ground truth: one fp32 product, cast once.
  * :func:`blocked_gemm_tile_ref` — the tile-order oracle (the reference's
    ``blocked_gemm_tpu_ref``): per-(bm, bn) fp32 accumulators over bk
    slices, the kernels' block structure written out.
  * :func:`paged_attention_ref` — paged decode attention in fp32 end to
    end, deliberately *not* the production op order (ungrouped fp32
    einsums over an eagerly gathered view).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.blocking import BlockConfig


def gemm_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """C = A @ B with fp32 accumulation (the oracle)."""

    out_dtype = out_dtype or a.dtype
    return (a.float() @ b.float()).to(out_dtype)


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


__all__ = ["gemm_ref", "blocked_gemm_tile_ref", "paged_attention_ref"]
