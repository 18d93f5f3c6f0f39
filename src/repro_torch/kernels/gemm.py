"""Blocked GEMM kernels for Hopper — per-class variants (CUDA C++).

The port's counterpart of ``repro.kernels.gemm``.  Two kernels share one
source (``csrc/gemm.cu``) and one template, as the reference's two Pallas
kernels share their scaffolding:

  * :func:`gemm_cuda` — replaces ``gemm_pallas``: each block owns a
    (bm, bn) output tile (bm / 64 consumer warpgroups running ``wgmma``
    on the tensor cores) and a producer warpgroup streams K in bk slices
    through a TMA ring in shared memory, ``PIPELINE_STAGES`` (4) deep or
    as deep as the block's stages fit, at least 2
    (``BlockConfig.smem_bytes(stages)``).
  * :func:`gemm_cuda_lean` — replaces ``gemm_pallas_lean``: the same
    kernel with one stage (load, wait, multiply, release), so the same
    shared memory holds a larger panel (``BlockConfig.smem_bytes(1)``).
    Both issue the same ``wgmma`` sequence, so at equal blocks the lean
    result is bitwise equal to the pipelined one.

TMA reads rows whose byte strides are multiples of 16 from 16-byte
aligned bases.  Every weight of the supported models meets that; an
operand whose K or N is not a multiple of 8, or whose base is not
aligned, is copied (zero-padded to the next multiple of 8) by the wrapper
before the launch, and the kernel stores only the real N columns.

Each wrapper launches its kernel for CUDA tensors and runs its plain
PyTorch version (:func:`gemm_plain` / :func:`gemm_lean_plain`) for CPU
tensors; there is no fallback from one to the other.  The plain versions
copy the kernels' K-slice order with fp32 accumulation.  ``LAUNCHES``
counts kernel launches per wrapper (plain runs are not counted), and
``LAUNCH_FLOPS`` their 2·M·N·K.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.blocking import (
    BK_ALIGN,
    BM_TILES,
    BN_TILES,
    MAX_BK,
    MIN_PIPELINE_STAGES,
    PIPELINE_STAGES,
    BlockConfig,
    H100,
    _round_up,
)

# Blocks may not exceed the problem rounded up to this tile alignment
# (nor, for bm/bn, the smallest compiled tile): a bigger block only
# multiplies masked work.
ALIGN = H100.align

LAUNCHES: dict[str, int] = {"gemm_cuda": 0, "gemm_cuda_lean": 0}
# Σ 2·M·N·K of the launches ``LAUNCHES`` counts, per wrapper (the problem's
# own M, N, K, not the padded grid's): what the dry-run's GEMM funnel is
# held to on the card.
LAUNCH_FLOPS: dict[str, int] = {"gemm_cuda": 0, "gemm_cuda_lean": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        LAUNCH_FLOPS[name] = 0


def resolve_block_config(m: int, k: int, n: int, dtype: torch.dtype, *,
                         stages: int = PIPELINE_STAGES) -> BlockConfig:
    """Config used when the caller passes ``cfg=None``: the analytical
    derivation for the big class (``execution.resolve_block_config``)."""

    from repro_torch.core.execution import dtype_name_for_bytes, resolve_block_config as _resolve

    itemsize = torch.empty((), dtype=dtype).element_size()
    cfg, _ = _resolve(m, k, n, dtype_name=dtype_name_for_bytes(itemsize),
                      dtype_bytes=itemsize, stages=stages)
    return cfg


def validate_block_config(m: int, k: int, n: int, cfg: BlockConfig) -> None:
    """Reject blocks that exceed the tile-rounded problem, loudly.

    A block larger than the problem rounded up to the tile alignment (16
    for M/N, one 64-value swizzle row for K), or than the smallest
    compiled tile, is a misconfiguration — a config from another shape, a
    hand-typed one — and raises a :class:`ValueError` naming the offending
    dimension.
    """

    floors = {"bm": min(BM_TILES), "bk": BK_ALIGN, "bn": min(BN_TILES)}
    aligns = {"bm": ALIGN, "bk": BK_ALIGN, "bn": ALIGN}
    for name, dim, blk in (("bm", m, cfg.bm), ("bk", k, cfg.bk), ("bn", n, cfg.bn)):
        padded = max(_round_up(dim, aligns[name]), floors[name])
        if blk > padded:
            axis = {"bm": "M", "bk": "K", "bn": "N"}[name]
            raise ValueError(
                f"block config {name}={blk} exceeds padded {axis}={padded} "
                f"(problem {m}x{k}x{n}, tile alignment {aligns[name]}); blocks "
                f"larger than the padded problem only multiply masked work"
            )


def _check_operands(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"gemm kernels are 2-D: got {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dims mismatch: {tuple(a.shape)} @ {tuple(b.shape)}")


def _prepare(a, b, cfg, stages):
    _check_operands(a, b)
    m, k = a.shape
    n = b.shape[1]
    if cfg is None:
        cfg = resolve_block_config(m, k, n, a.dtype, stages=stages)
    validate_block_config(m, k, n, cfg)
    return m, k, n, cfg


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU route and the kernels' yardstick)
# ---------------------------------------------------------------------------


def _tile_loop(a, b, cfg: BlockConfig, out_dtype) -> torch.Tensor:
    """fp32 accumulation over K in ``bk`` slices, cast once at the end —
    the kernels' accumulation order at slice granularity."""

    k = a.shape[1]
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32, device=a.device)
    for k0 in range(0, k, cfg.bk):
        acc += a[:, k0:k0 + cfg.bk].float() @ b[k0:k0 + cfg.bk].float()
    return acc.to(out_dtype)


def gemm_plain(a, b, cfg: Optional[BlockConfig] = None, *, out_dtype=None) -> torch.Tensor:
    """Plain version of :func:`gemm_cuda` (pipelined block model)."""

    _, _, _, cfg = _prepare(a, b, cfg, PIPELINE_STAGES)
    return _tile_loop(a, b, cfg, out_dtype or a.dtype)


def gemm_lean_plain(a, b, cfg: Optional[BlockConfig] = None, *, out_dtype=None) -> torch.Tensor:
    """Plain version of :func:`gemm_cuda_lean` (one-stage block model);
    the same arithmetic as :func:`gemm_plain` at equal blocks."""

    _, _, _, cfg = _prepare(a, b, cfg, 1)
    return _tile_loop(a, b, cfg, out_dtype or a.dtype)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

_FN = None


def _kernel():
    global _FN
    if _FN is None:
        from repro_torch.kernels import build

        fn = build.load("gemm").repro_gemm
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _tma_ready(x: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``x`` as TMA reads it: contiguous, 16-byte aligned, ``cols`` wide
    (zero-padded when ``cols`` exceeds its width) and ``rows`` tall."""

    x = x.contiguous()
    if x.shape == (rows, cols) and x.data_ptr() % 16 == 0:
        return x
    out = torch.zeros((rows, cols), dtype=x.dtype, device=x.device)
    out[: x.shape[0], : x.shape[1]] = x
    return out


def compiled_tile(cfg: BlockConfig) -> bool:
    """Is ``cfg`` a tile shape the CUDA GEMM is compiled for (``bm`` and
    ``bn`` from the tile sets, ``bk`` whole swizzle rows up to ``MAX_BK``)?"""

    return (cfg.bm in BM_TILES and cfg.bn in BN_TILES and cfg.bk % BK_ALIGN == 0
            and 0 < cfg.bk <= MAX_BK)


def ring_depth(cfg: BlockConfig) -> int:
    """Stages of the pipelined kernel's ring for ``cfg``: ``PIPELINE_STAGES``,
    or as many (at least ``MIN_PIPELINE_STAGES``) as fit the shared memory
    a block may claim."""

    for stages in range(PIPELINE_STAGES, MIN_PIPELINE_STAGES - 1, -1):
        if cfg.smem_bytes(stages) <= H100.smem_bytes:
            return stages
    raise ValueError(
        f"{cfg} needs {cfg.smem_bytes(MIN_PIPELINE_STAGES)} B of shared memory in a "
        f"{MIN_PIPELINE_STAGES}-stage ring; a block "
        f"may claim {H100.smem_bytes} B"
    )


def _launch(a, b, cfg: BlockConfig, out_dtype, stages: int, counter: str) -> torch.Tensor:
    from repro_torch.kernels import build

    if a.device != b.device or a.device.type != "cuda":
        raise ValueError(f"operands on {a.device} / {b.device}; the kernel needs one CUDA device")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA GEMM takes bf16 operands, got {a.dtype} @ {b.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the CUDA GEMM writes bf16 or fp32, not {out_dtype}")
    if not compiled_tile(cfg):
        raise ValueError(f"{cfg} is not a compiled tile shape")
    if cfg.smem_bytes(stages) > H100.smem_bytes:
        raise ValueError(
            f"{cfg} needs {cfg.smem_bytes(stages)} B of shared memory in a {stages}-stage "
            f"ring; a block may claim {H100.smem_bytes} B"
        )
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return c
    if k == 0:
        return c.zero_()
    # TMA's 16-byte row strides: K and B's row pitch rounded up to 8 values.
    kp, ldb = _round_up(k, 8), _round_up(n, 8)
    a = _tma_ready(a, m, kp)
    b = _tma_ready(b, kp, ldb)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        status = _kernel()(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), m, kp, n, ldb,
            cfg.bm, cfg.bk, cfg.bn, stages, int(out_dtype == torch.float32), stream,
        )
    build.check(status, f"{counter} {m}x{k}x{n} {cfg}")
    LAUNCHES[counter] += 1
    LAUNCH_FLOPS[counter] += 2 * m * k * n
    return c


def gemm_cuda(a, b, cfg: Optional[BlockConfig] = None, *, out_dtype=None) -> torch.Tensor:
    """``C = A @ B`` through the pipelined CUDA kernel (a ring of
    :func:`ring_depth` stages).

    CPU tensors run :func:`gemm_plain`; CUDA tensors launch the kernel or
    raise.
    """

    _, _, _, cfg = _prepare(a, b, cfg, PIPELINE_STAGES)
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu" and b.device.type == "cpu":
        return _tile_loop(a, b, cfg, out_dtype)
    return _launch(a, b, cfg, out_dtype, ring_depth(cfg), "gemm_cuda")


def gemm_cuda_lean(a, b, cfg: Optional[BlockConfig] = None, *, out_dtype=None) -> torch.Tensor:
    """``C = A @ B`` through the lean (one-stage) CUDA kernel.

    With ``cfg=None`` the blocks resolve under the one-stage shared-memory
    model.  CPU tensors run :func:`gemm_lean_plain`.
    """

    _, _, _, cfg = _prepare(a, b, cfg, 1)
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu" and b.device.type == "cpu":
        return _tile_loop(a, b, cfg, out_dtype)
    return _launch(a, b, cfg, out_dtype, 1, "gemm_cuda_lean")


# The kernel variant registry: variant name -> kernel entry point.
GEMM_KERNELS = {
    "cuda": gemm_cuda,
    "cuda_lean": gemm_cuda_lean,
}


__all__ = [
    "ALIGN",
    "GEMM_KERNELS",
    "compiled_tile",
    "LAUNCHES",
    "LAUNCH_FLOPS",
    "gemm_cuda",
    "gemm_cuda_lean",
    "gemm_lean_plain",
    "gemm_plain",
    "reset_launches",
    "resolve_block_config",
    "ring_depth",
    "validate_block_config",
]
