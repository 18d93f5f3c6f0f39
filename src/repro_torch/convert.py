"""Carry the reference's parameters across as the port's parameters.

``params_from_jax`` takes the reference's param pytree as numpy arrays
(``jax.tree.map(np.asarray, model_zoo.init_params(key, cfg))``) and
returns the port's nested dict of tensors on ``device``:

  * the layer stack keeps its leading ``L`` axis;
  * projection weights keep the JAX ``(in, out)`` layout (the kernels
    compute ``A · B``; nothing is transposed into ``nn.Linear``'s order);
  * projection matrices, ``embed`` and ``lm_head`` are stored in bf16 once
    — the reference casts its fp32 masters to bf16 at every use, so the
    values the kernels see are the same;
  * MoE blocks carry ``moe``: ``router`` (L, D, E), the experts ``w1`` /
    ``w3`` (L, E, D, F) and ``w2`` (L, E, F, D), and for Qwen2-MoE
    ``shared`` (a GLU) and ``shared_gate`` (L, D, 1), all in bf16 (the
    reference casts them to bf16 at use);
  * norm weights and biases stay fp32, as the reference uses them.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import ArchConfig

_FP32_LEAVES = ("ln1", "ln2", "final_norm", "bq", "bk", "bv")


def params_from_jax(tree, cfg: ArchConfig, device="cuda"):
    """Convert a numpy param tree of the reference into the port's params."""

    def conv(node, name: str):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        arr = np.asarray(node)
        if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: no torch.from_numpy
            arr = arr.astype(np.float32)
        t = torch.from_numpy(np.array(arr)).to(device)
        if not t.is_floating_point():
            return t
        return t.float() if name in _FP32_LEAVES else t.to(torch.bfloat16)

    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"{cfg.name}: only the dense and MoE families are ported")
    return conv(dict(tree), "")


__all__ = ["params_from_jax"]
