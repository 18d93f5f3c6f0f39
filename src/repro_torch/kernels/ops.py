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

from typing import Optional

import torch

from repro_torch.core import execution as X
from repro_torch.core.blocking import BlockConfig


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
    """

    out_dtype = out_dtype or a.dtype
    if b.ndim != 2:
        raise ValueError(f"gemm expects 2-D rhs, got {tuple(b.shape)}")
    lead = a.shape[:-1]
    k = a.shape[-1]
    a2 = a.reshape(-1, k)

    ctx = X.current_context()
    if ctx is not None:
        if backend == "auto":
            backend = ctx.tree.backend
        if config is None and X.resolve_backend(backend) != "matmul":
            itemsize = a2.element_size()
            config = ctx.block_config(
                a2.shape[0], k, b.shape[1], X.dtype_name_for_bytes(itemsize), itemsize
            )

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


__all__ = ["gemm", "gemm_with_tree", "linear"]
