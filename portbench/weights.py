"""Weights from the seed, made on the device in one call per stacked leaf.

The tree is the program's layout (the layers of a leaf stacked on a
leading axis, projections ``(in, out)``): the family's layer leaves
(``families/<family>.py``, ``block_leaves``), then the final norm, the
output head (none where the family ties it to the embedding) and the
embedding, both over the family's held vocabulary.  Projections are normal with standard
deviation ``1/sqrt(fan_in)``, the embedding and the output head 0.02,
norm weights 1; a family may give a leaf an initialiser of its own.

``dtype`` is the type of the projections, the embedding and the head as
the cell hands them to the program (float32 masters to train, bfloat16
to serve); norm weights and a family's own leaves stay float32.  The
leaves are drawn in one order from one generator, so
:func:`iter_params` can make them again one at a time.
"""

from __future__ import annotations

import hashlib
import math

import torch

from portbench import families


def derive_seed(seed: int, tag: str) -> int:
    """A 63-bit generator seed for one stream (``tag``) of a run's seed."""

    return int.from_bytes(hashlib.sha256(f"{seed}:{tag}".encode()).digest()[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive_seed(seed, tag))


def leaf_specs(conf: dict) -> list:
    """``[(dotted name, shape, init)]`` of the whole tree, in draw order."""

    fam = families.load(conf["family"])
    nl, d, v = fam.n_layers(conf), fam.d_model(conf), fam.held_vocab(conf)
    blocks = [("blocks." + n, (nl,) + tuple(s), init) for n, s, init in fam.block_leaves(conf)]
    head = [] if fam.tied_head(conf) else [("lm_head", (d, v), "head")]
    return blocks + [("final_norm", (d,), "ones")] + head + [("embed", (v, d), "embed")]


def _draw(gen, init, shape, device, dtype):
    f32 = torch.float32
    if callable(init):
        return init(gen, shape, device)
    if init == "ones":
        return torch.ones(shape, dtype=f32, device=device)
    scale = {"proj": 1.0 / math.sqrt(shape[-2]), "head": 0.02, "embed": 0.02}[init]
    w = torch.randn(shape, generator=gen, device=device, dtype=f32)
    return w.mul_(scale).to(dtype)


def iter_params(conf: dict, seed: int, device, dtype=torch.float32):
    """``(dotted name, tensor)`` of the weights of ``seed``, a leaf at a time."""

    gen = generator(seed, "weights", device)
    for name, shape, init in leaf_specs(conf):
        yield name, _draw(gen, init, shape, device, dtype)


def make_params(conf: dict, seed: int, device, dtype=torch.float32) -> dict:
    """The weights of the configuration file ``conf`` for ``seed``."""

    tree = {}
    for name, x in iter_params(conf, seed, device, dtype):
        *path, last = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[last] = x
    return tree


def tree_signature(tree, prefix="") -> dict:
    """``{name: (shape, dtype)}`` of a nested dict of tensors."""

    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(tree_signature(tree[k], f"{prefix}{k}."))
        return out
    return {prefix[:-1]: (tuple(tree.shape), str(tree.dtype))}
