"""Training steps of the reference: the masked mean cross-entropy, its
gradients, global-norm clipping and AdamW.

AdamW [arXiv:1711.05101] as the cells' traffic files state it: moments
``b1``, ``b2``, bias-corrected, ``eps`` outside the square root,
decoupled weight decay on every leaf of two or more dimensions (the
stacked per-layer norm weights included), the learning rate read at the
step being taken (1 for the first): a linear warm-up over
``warmup_steps``, then a cosine decay to 0 at ``total_steps``; the
gradients clipped to global norm ``clip_norm`` first.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import models


def leaves(tree, prefix=""):
    """``[(name, tensor)]`` of a nested dict, keys sorted."""

    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in leaves(tree[k], f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def layer_norms(named) -> dict:
    """``{name: norm}`` of ``[(name, tensor)]``: a stacked leaf (under
    ``blocks.``) gives one norm a layer, named ``name[i]``; any other leaf
    one norm."""

    out = {}
    for name, x in named:
        x = x.detach().float()
        if name.startswith("blocks."):
            for i, n in enumerate(torch.linalg.vector_norm(x.flatten(1), dim=1).tolist()):
                out[f"{name}[{i}]"] = n
        else:
            out[name] = float(torch.linalg.vector_norm(x))
    return out


def lr_at(opt: dict, t: int) -> float:
    warm = min(t / max(opt["warmup_steps"], 1), 1.0)
    frac = min(max((t - opt["warmup_steps"]) / max(opt["total_steps"] - opt["warmup_steps"], 1),
                   0.0), 1.0)
    return opt["lr"] * warm * 0.5 * (1.0 + math.cos(math.pi * frac))


def loss_and_grads(params, conf, batch, precision: str):
    """The masked mean cross-entropy over every labelled token and its
    gradients (float32, the params' tree), a row at a time, each layer
    recomputed in the backward."""

    tokens, labels = batch["tokens"], batch["labels"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    total = mask.float().sum().clamp(min=1.0)
    named = leaves(params)
    grads = [torch.zeros_like(p) for _, p in named]
    loss = torch.zeros((), dtype=torch.float64, device=tokens.device)
    for r in range(tokens.shape[0]):
        if float(mask[r].sum()) == 0.0:
            continue
        lg = models.logits(params, conf, tokens[r:r + 1], precision, remat=True)
        ce = -torch.log_softmax(lg, dim=-1).gather(-1, labels[r:r + 1, :, None].long())[..., 0]
        row = (ce * mask[r:r + 1].float()).sum() / total
        gs = torch.autograd.grad(row, [p for _, p in named], allow_unused=True)
        for acc, g in zip(grads, gs):
            if g is not None:
                acc.add_(g)
        loss += row.detach().double()
        del lg, ce, row, gs
    return float(loss), grads


def train(params, conf, batches, opt: dict, precision: str = "fp32", on_first=None):
    """AdamW over ``batches`` from ``params`` (float32 leaves, updated in
    place).  Returns per step ``{"loss", "grad_norm"}`` and the
    :func:`layer_norms` of the first step's clipped gradient, as the
    optimizer takes it.  ``on_first``, where given, is called once with
    that gradient, ``[(name, tensor)]``, before it is freed."""

    named = leaves(params)
    for _, p in named:
        p.requires_grad_(True)
    m = [torch.zeros_like(p) for _, p in named]
    v = [torch.zeros_like(p) for _, p in named]
    history, first_grad = [], None
    for t, batch in enumerate(batches, start=1):
        loss, grads = loss_and_grads(params, conf, batch, precision)
        norm = math.sqrt(sum(float(g.double().pow(2).sum()) for g in grads))
        scale = min(1.0, opt["clip_norm"] / max(norm, 1e-9))
        lr = lr_at(opt, t)
        b1, b2 = opt["b1"], opt["b2"]
        with torch.no_grad():
            for (_, p), g, mi, vi in zip(named, grads, m, v):
                g.mul_(scale)
                mi.mul_(b1).add_(g, alpha=1 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (mi / (1 - b1 ** t)) / ((vi / (1 - b2 ** t)).sqrt() + opt["eps"])
                if p.ndim >= 2:
                    upd.add_(p, alpha=opt["weight_decay"])
                p.sub_(upd, alpha=lr)
                del upd
        if t == 1:
            first_grad = layer_norms((name, g) for (name, _), g in zip(named, grads))
            if on_first is not None:
                on_first([(name, g) for (name, _), g in zip(named, grads)])
        del grads
        history.append({"loss": loss, "grad_norm": norm})
    for _, p in named:
        p.requires_grad_(False)
    del m, v
    return history, first_grad
