"""AdamW with learning-rate schedules, global-norm clipping and micro-batch
gradient accumulation (the port's ``repro.optim.adamw``).

Functions over the port's nested dicts of tensors.  The state is
``{"m", "v"}`` (fp32, the params' tree) and ``"step"`` (a 0-d int32
tensor), as in the reference, so the two packages' checkpoints hold the
same keys.  The update keeps the reference's arithmetic in fp32, op for
op, and its quirks:

  * decoupled weight decay on every leaf with ``ndim >= 2`` — the stacked
    ``(L, d)`` norm weights and ``(L, h)`` biases included;
  * the schedule is read at ``step + 1`` (the step being taken);
  * ``accumulate_gradients`` returns the last micro-batch's metrics.

:func:`adamw_update` writes the params, ``m`` and ``v`` in place (the
clipped gradients too): at full width each is a 7.6 GB tree, and a copy
of one would not fit beside the others.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from repro_torch.observability import trace as T


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"  # cosine | linear | constant


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a 0-d tensor), a 0-d fp32
    tensor computed in fp32 as the reference computes it."""

    device = step.device if isinstance(step, torch.Tensor) else None
    step = _f32(step, device) if not isinstance(step, torch.Tensor) else step.to(torch.float32)
    warm = torch.clamp(step / _f32(max(cfg.warmup_steps, 1), device), max=1.0)
    frac = torch.clamp(
        (step - cfg.warmup_steps) / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), device),
        0.0, 1.0,
    )
    if cfg.schedule == "cosine":
        decay = 0.5 * (1 + torch.cos(_f32(math.pi, device) * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - frac
    else:
        decay = _f32(1.0, device)
    return cfg.lr * warm * decay


def tree_leaves(tree) -> list:
    """The tensors of a nested dict, in sorted key order (JAX's order)."""

    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree_like, leaves) -> dict:
    """Nested dicts of ``tree_like``'s structure holding ``leaves`` (in
    :func:`tree_leaves`' order)."""

    it = iter(leaves)

    def rebuild(tree):
        if isinstance(tree, dict):
            return {k: rebuild(tree[k]) for k in sorted(tree)}
        return next(it)

    return rebuild(tree_like)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""

    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def init_opt_state(params) -> dict:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32, requires_grad=False)  # noqa: E731
    device = tree_leaves(params)[0].device
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """``(clipped, norm)``: every leaf scaled by ``min(1, max_norm / norm)``
    (a new tree; :func:`adamw_update` scales its own in place)."""

    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale, grads), norm


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, *, norm: Optional[Callable] = None):
    """One AdamW step; returns ``(params, state, {"lr", "grad_norm"})``.

    ``params``, ``state["m"]``/``["v"]`` and ``grads`` are updated in
    place (``grads`` holds the clipped values afterwards) and returned.
    ``norm`` computes the gradients' global norm (:func:`global_norm`
    unless given: a sharded tree's is ``distributed.spmd.global_norm``).
    On shards the update is the same element-wise arithmetic, and weight
    decay reads a leaf's logical ``ndim``, which its shard keeps.  The
    whole update (norm, clip, every leaf) is the ``trainer.optimizer``
    span.
    """

    with T.span("trainer.optimizer", cat="trainer") as sp:
        step = state["step"] + 1
        grad_norm = (norm or global_norm)(grads)
        flat_g = tree_leaves(grads)
        if cfg.clip_norm is not None:
            scale = _clip_scale(grad_norm, cfg.clip_norm)
            for g in flat_g:
                g.mul_(scale)
        lr = lr_at(cfg, step)
        stepf = step.to(torch.float32)
        b1c = 1 - torch.pow(_f32(cfg.b1, step.device), stepf)
        b2c = 1 - torch.pow(_f32(cfg.b2, step.device), stepf)
        b1, b2 = _f32(cfg.b1, step.device), _f32(cfg.b2, step.device)
        c1, c2 = _f32(1 - cfg.b1, step.device), _f32(1 - cfg.b2, step.device)

        leaves = zip(tree_leaves(params), flat_g, tree_leaves(state["m"]), tree_leaves(state["v"]))
        for p, g, m, v in leaves:
            g = g.float()
            m.mul_(b1).add_(c1 * g)                  # b1·m + (1-b1)·g
            v.mul_(b2).add_(c2 * g * g)              # b2·v + (1-b2)·g·g
            upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            if p.ndim >= 2:                          # decoupled decay, matrices only
                upd.add_(cfg.weight_decay * p)
            p.sub_((lr * upd).to(p.dtype))
            del upd
        state = {"m": state["m"], "v": state["v"], "step": step}
        sp.tag(leaves=len(flat_g))
    return params, state, {"lr": lr, "grad_norm": grad_norm}


def value_and_grad(loss_fn: Callable, params, batch, *, micro: Optional[int] = None):
    """``(loss, metrics, grads)`` of ``loss_fn(params, batch)``: the grads
    of every leaf that requires one, in the params' tree and dtype.  The
    loss is the ``trainer.forward`` span, the gradients (the recompute
    included) ``trainer.backward``; ``micro`` tags both with the
    micro-batch's index."""

    tags = {} if micro is None else {"micro": micro}
    with T.span("trainer.forward", cat="trainer", **tags):
        loss, metrics = loss_fn(params, batch)
    leaves = tree_leaves(params)
    with T.span("trainer.backward", cat="trainer", **tags):
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [g if g is not None else torch.zeros_like(p) for g, p in zip(grads, leaves)]
    return loss.detach(), {k: v.detach() if isinstance(v, torch.Tensor) else v
                           for k, v in metrics.items()}, tree_unflatten(params, grads)


def accumulate_gradients(loss_fn: Callable, params, batch, n_micro: int):
    """Loop over micro-batches; returns ``(mean_loss, metrics, mean_grads)``.

    Batch tensors are split along axis 0; ``n_micro`` must divide the
    batch.  Gradients accumulate in fp32 and are divided by ``n_micro``;
    the metrics are the last micro-batch's, as the reference's scan
    returns them.
    """

    if n_micro <= 1:
        return value_and_grad(loss_fn, params, batch)
    b = next(iter(batch.values())).shape[0]
    if b % n_micro:
        raise ValueError(f"n_micro={n_micro} does not divide the batch of {b}")
    size = b // n_micro
    acc_g, acc_l, metrics = None, None, None
    for j in range(n_micro):
        mb = {k: v[j * size:(j + 1) * size] for k, v in batch.items()}
        loss, metrics, grads = value_and_grad(loss_fn, params, mb, micro=j)
        if acc_g is None:
            acc_g = tree_map(lambda g: g.float(), grads)
            acc_l = loss.float()
        else:
            tree_map(lambda a, g: a.add_(g.float()), acc_g, grads)
            acc_l = acc_l + loss
        del grads
    grads = tree_map(lambda g: g.div_(n_micro), acc_g)
    return acc_l / n_micro, metrics, grads


__all__ = [
    "AdamWConfig",
    "accumulate_gradients",
    "adamw_update",
    "clip_by_global_norm",
    "global_norm",
    "init_opt_state",
    "lr_at",
    "tree_leaves",
    "tree_map",
    "tree_unflatten",
    "value_and_grad",
]
