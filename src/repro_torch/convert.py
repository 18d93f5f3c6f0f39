"""Carry the reference's parameters across as the port's parameters.

``params_from_jax`` takes the reference's param pytree as numpy arrays
(``jax.tree.map(np.asarray, model_zoo.init_params(key, cfg))``) and
returns the port's nested dict of tensors on ``device``, the same tree:

  * the layer stacks keep their leading ``L`` axis (the hybrid's
    ``shared`` block and the enc-dec's final norms have none);
  * projection weights keep the JAX ``(in, out)`` layout (the kernels
    compute ``A · B``; nothing is transposed into ``nn.Linear``'s order);
  * projection matrices, ``embed`` and ``lm_head`` are stored in bf16 once
    — the reference casts its fp32 masters to bf16 at every use, so the
    values the kernels see are the same;
  * MoE blocks carry ``moe``: ``router`` (L, D, E), the experts ``w1`` /
    ``w3`` (L, E, D, F) and ``w2`` (L, E, F, D), and for Qwen2-MoE
    ``shared`` (a GLU) and ``shared_gate`` (L, D, 1), all in bf16 (the
    reference casts them to bf16 at use);
  * the leaves the reference uses in fp32 stay fp32, named per family
    (:data:`FP32_LEAVES`): norm weights and qkv biases everywhere; the
    Mamba2 block's ``ln``, its conv weights and biases (its causal conv
    casts ``w`` to fp32), ``dt_bias``, ``A_log``, ``D`` and ``norm_w``;
    the enc-dec's layer-norm weights and biases and its MLP biases.

``params_from_jax`` is for serving.  ``train_state_from_jax`` carries a
training state across: the reference's fp32 params stay fp32 masters (the
same tree), and its AdamW state ``{"m", "v", "step"}`` becomes the port's,
so both packages start a trainer from the same numbers.

On a rank mesh (``mesh=``) both give this rank's shards, cut from the
full arrays by the same slicer the sharded step uses
(``sharding.local_slice`` under the spec tree of ``model_zoo.param_specs``):
serving params by the serving rules (no FSDP), a training state by
``fsdp``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import ArchConfig

_LM = ("ln1", "ln2", "final_norm", "bq", "bk", "bv")
_MAMBA = ("ln", "conv_w_x", "conv_b_x", "conv_w_bc", "conv_b_bc", "dt_bias", "A_log", "D",
          "norm_w")
_ENCDEC = ("ln1_w", "ln1_b", "lnx_w", "lnx_b", "ln2_w", "ln2_b", "enc_ln_w", "enc_ln_b",
           "dec_ln_w", "dec_ln_b", "b1", "b2")

# The leaves kept in fp32, by family; every other float leaf becomes bf16.
FP32_LEAVES = {
    "dense": _LM,
    "moe": _LM,
    "ssm": _LM + _MAMBA,
    "hybrid": _LM + _MAMBA,
    "encdec": _ENCDEC,
}


def _shards(tree, cfg: ArchConfig, mesh, fsdp: bool):
    """The rank's slices of a numpy tree (views) by ``cfg``'s spec tree."""

    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import spmd
    from repro_torch.models import model_zoo as Z

    specs = Z.param_specs(cfg, mesh, fsdp=fsdp)
    return spmd.map_specs(lambda x, spec: SH.local_slice(np.asarray(x), spec, mesh), dict(tree),
                          specs)


def params_from_jax(tree, cfg: ArchConfig, device="cuda", *, mesh=None):
    """Convert a numpy param tree of the reference into the port's params
    (on a rank mesh, this rank's shards of them)."""

    keep = FP32_LEAVES[cfg.family]
    if mesh is not None:
        tree = _shards(tree, cfg, mesh, fsdp=False)

    def conv(node, name: str):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        arr = np.asarray(node)
        if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: no torch.from_numpy
            arr = arr.astype(np.float32)
        t = torch.from_numpy(np.array(arr)).to(device)
        if not t.is_floating_point():
            return t
        return t.float() if name in keep else t.to(torch.bfloat16)

    return conv(dict(tree), "")


def _tensors(node, device, requires_grad: bool = False):
    if isinstance(node, dict):
        return {k: _tensors(v, device, requires_grad) for k, v in node.items()}
    t = torch.from_numpy(np.array(node)).to(device)
    return t.requires_grad_(requires_grad and t.is_floating_point())


def train_state_from_jax(params, opt_state, device="cuda", *, cfg: ArchConfig = None, mesh=None,
                         fsdp: bool = True):
    """``(params, opt_state)`` of the port's trainer from the reference's
    (numpy trees): fp32 master params that require grad, in the
    reference's tree, and ``{"m", "v"}`` fp32 with ``"step"`` a 0-d int32
    tensor.  ``opt_state=None`` gives a fresh state (zeros, step 0).  Every
    family's tree carries over as it is (the MoE stacks, the Mamba2 leaves,
    the hybrid's unstacked ``shared`` block, the enc-dec's two stacks):
    the masters are fp32 everywhere, so :data:`FP32_LEAVES` plays no part.
    With a rank ``mesh`` (and ``cfg``) every tree is this rank's shards."""

    if mesh is not None:
        params = _shards(params, cfg, mesh, fsdp)
        if opt_state is not None:
            opt_state = dict(opt_state, m=_shards(opt_state["m"], cfg, mesh, fsdp),
                             v=_shards(opt_state["v"], cfg, mesh, fsdp))
    p = _tensors(dict(params), device, requires_grad=True)
    if opt_state is None:
        from repro_torch.optim.adamw import init_opt_state

        return p, init_opt_state(p)
    opt = {"m": _tensors(dict(opt_state["m"]), device), "v": _tensors(dict(opt_state["v"]), device),
           "step": torch.as_tensor(np.array(opt_state["step"]), dtype=torch.int32, device=device)}
    return p, opt


__all__ = ["FP32_LEAVES", "params_from_jax", "train_state_from_jax"]
