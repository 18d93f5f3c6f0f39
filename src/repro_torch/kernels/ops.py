"""Public entry points for the kernels, execution-context aware.

The port's counterpart of ``repro.kernels.ops``.  :func:`gemm` is the
operation every projection and the LM head route through: the executing
device class's control tree (the ambient
:class:`~repro_torch.core.execution.ExecutionContext`) selects both the
block shapes and the kernel (paper Section 5.3).  Explicit
``config=``/``backend=`` arguments win over the context; with no context
active ``"auto"`` picks the CUDA kernel on a machine with a card and the
framework matmul otherwise.

Backends (the dispatch table lives in ``execution.BACKENDS``):

  * ``"matmul"``     — ``torch.matmul`` (the reference's ``xla`` entry),
  * ``"cuda"``       — the pipelined CUDA kernel (``gemm_cuda``),
  * ``"cuda_lean"``  — the shared-memory-lean variant (``gemm_cuda_lean``),
  * ``"torch_ref"`` / ``"torch_ref_lean"`` — the kernels' plain versions.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.core import execution as X
from repro_torch.core.blocking import BlockConfig


def _resolve(m: int, k: int, n: int, itemsize: int, config, backend: str, ctx):
    """``(backend, config)`` for one 2-D call under ``ctx``: the context's
    tree names the kernel when the call says ``"auto"`` and its class
    resolves the block shape when the call gives none; the backend comes
    back resolved to a dispatch-table entry."""

    if ctx is not None:
        if backend == "auto":
            backend = ctx.tree.backend
        if config is None and X.resolve_backend(backend) != "matmul":
            config = ctx.block_config(m, k, n, X.dtype_name_for_bytes(itemsize), itemsize)
    return X.resolve_backend(backend), config


class GemmFn(torch.autograd.Function):
    """``a2 @ b`` through the dispatch table, differentiable.

    The backward is two more products through the same funnel, under the
    execution context the forward ran under (saved on ``ctx`` and entered
    again: autograd runs the backward of CUDA tensors on its own thread,
    which does not see the forward's ``ContextVar``):
    ``dA = dC · Bᵀ`` (M, N)·(N, K) and ``dB = Aᵀ · dC`` (K, M)·(M, N), each
    with the block config its class resolves for that shape.  The kernels
    read row-major operands, so ``Bᵀ`` and ``Aᵀ`` are contiguous copies.
    Each gradient is computed only when asked for and comes back in its
    operand's dtype (the transpose of a bf16 product is bf16).
    """

    @staticmethod
    def forward(fctx, a2, b, config, backend, out_dtype, exec_ctx):
        fctx.save_for_backward(a2, b)
        fctx.backend, fctx.exec_ctx = backend, exec_ctx
        return X.dispatch_gemm(a2, b, config=config, backend=backend, out_dtype=out_dtype)

    @staticmethod
    def backward(fctx, dc):
        a2, b = fctx.saved_tensors
        need_a, need_b = fctx.needs_input_grad[:2]
        exec_ctx = fctx.exec_ctx
        da = db = None
        with exec_ctx if exec_ctx is not None else contextlib.nullcontext():
            dc = dc.to(a2.dtype)
            if need_a:
                bt = b.t().contiguous()
                _, cfg = _resolve(dc.shape[0], dc.shape[1], bt.shape[1], dc.element_size(),
                                  None, fctx.backend, exec_ctx)
                da = X.dispatch_gemm(dc, bt, config=cfg, backend=fctx.backend,
                                     out_dtype=a2.dtype)
            if need_b:
                at = a2.t().contiguous()
                _, cfg = _resolve(at.shape[0], at.shape[1], dc.shape[1], at.element_size(),
                                  None, fctx.backend, exec_ctx)
                db = X.dispatch_gemm(at, dc, config=cfg, backend=fctx.backend,
                                     out_dtype=b.dtype)
        return da, db, None, None, None, None


def gemm(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    config: Optional[BlockConfig] = None,
    backend: str = "auto",
    out_dtype=None,
) -> torch.Tensor:
    """``a @ b`` over the last/first axes with leading dims collapsed.

    ``a`` may carry leading (batch/sequence) dims; ``b`` is 2-D ``(k, n)``.
    With grad mode on and an operand that requires grad the call goes
    through :class:`GemmFn` (the same kernel forward, a backward through
    the same backend); otherwise (``inference_mode``, ``no_grad``) it
    dispatches directly.
    """

    out_dtype = out_dtype or a.dtype
    if b.ndim != 2:
        raise ValueError(f"gemm expects 2-D rhs, got {tuple(b.shape)}")
    lead = a.shape[:-1]
    k = a.shape[-1]
    a2 = a.reshape(-1, k)

    ctx = X.current_context()
    backend, config = _resolve(a2.shape[0], k, b.shape[1], a2.element_size(), config, backend, ctx)
    if torch.is_grad_enabled() and (a2.requires_grad or b.requires_grad):
        out = GemmFn.apply(a2, b, config, backend, out_dtype, ctx)
    else:
        out = X.dispatch_gemm(a2, b, config=config, backend=backend, out_dtype=out_dtype)
    return out.reshape(*lead, b.shape[1])


def gemm_with_tree(a: torch.Tensor, b: torch.Tensor, tree, out_dtype=None) -> torch.Tensor:
    """GEMM configured by a device class's control tree."""

    with X.context_for_tree(tree):
        return gemm(a, b, out_dtype=out_dtype)


def linear(x, w, b=None, *, config=None, backend: str = "auto"):
    """Affine layer on top of :func:`gemm` (bias in fp32, cast back)."""

    y = gemm(x, w, config=config, backend=backend)
    if b is not None:
        y = (y.float() + b.float()).to(y.dtype)
    return y


__all__ = ["GemmFn", "gemm", "gemm_with_tree", "linear"]
