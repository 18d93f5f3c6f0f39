"""The numbers that decide ``correct``, each held to its limit."""

from __future__ import annotations

import math
import statistics


def rel_gap(p: float, r: float) -> float:
    return abs(p - r) / max(abs(r), 1e-30)


def leaf_gaps(prog: dict, ref: dict, keep=None) -> list:
    """Each leaf's gap between the program's norm and the reference's,
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger.  A leaf the program lacks reads infinitely far."""

    names = [n for n in ref if keep is None or keep(n)]
    med = statistics.median(ref[n] for n in names)
    return [abs(prog.get(n, math.inf) - ref[n]) / max(ref[n], med, 1e-30) for n in names]


def whole_leaves(norms: dict) -> dict:
    """Per-layer norms (``name[i]``) joined into their stacked leaf's norm:
    the leaves of the program's tree."""

    sq = {}
    for name, v in norms.items():
        leaf = name.split("[", 1)[0]
        sq[leaf] = sq.get(leaf, 0.0) + v * v
    return {k: math.sqrt(v) for k, v in sq.items()}


TRAINING = ("loss_gap", "grad_norm_gap", "first_grad_gap", "first_grad_diff_gap", "change_gap",
            "decay_gap")


def training_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: ``{"loss": [..], "grad_norm": [..],
    "first_grad": {leaf: norm}, "change": {leaf: norm}, "decay_share":
    {leaf: share}}``, the norms a layer of a stacked leaf, compared as
    the program's leaves (the stacks whole), by the worst leaf; the decay
    shares by the widest difference.  ``ref["first_grad_diff"]`` holds
    the norms of the judged first gradient's difference from the
    reference's, ``first_grad_diff_gap`` the worst leaf's over the
    reference's norm of that leaf (a leaf the judged side lacks reads
    infinitely far).  A leaf whose reference gradient is
    under a thousandth of the median leaf's is left out of the change and
    the decay share (its moves are round-off).  A cell compares the
    numbers its workload file gives limits."""

    if len(prog["loss"]) != len(ref["loss"]):
        return {k: math.inf for k in TRAINING}
    grad_p, grad_r = whole_leaves(prog["first_grad"]), whole_leaves(ref["first_grad"])
    diff = whole_leaves(ref["first_grad_diff"])
    floor = 1e-3 * statistics.median(grad_r.values())
    moved = [leaf for leaf in grad_r if grad_r[leaf] >= floor]
    change = leaf_gaps(whole_leaves(prog["change"]), whole_leaves(ref["change"]),
                       keep=lambda leaf: leaf in moved)
    decay_p, decay_r = prog["decay_share"], ref["decay_share"]
    return {
        "loss_gap": max(rel_gap(p, r) for p, r in zip(prog["loss"], ref["loss"])),
        "grad_norm_gap": max(rel_gap(p, r) for p, r in zip(prog["grad_norm"], ref["grad_norm"])),
        "first_grad_gap": max(leaf_gaps(grad_p, grad_r)),
        "first_grad_diff_gap": max(diff.get(leaf, math.inf) / max(grad_r[leaf], 1e-30)
                                   for leaf in grad_r),
        "change_gap": max(change),
        "decay_gap": max(abs(decay_p.get(leaf, math.inf) - decay_r[leaf]) for leaf in moved),
    }


def logprob_numbers(pairs) -> dict:
    """``pairs``: ``[(program, reference)]`` token log-probability tensors
    of the sampled requests.  The widest gap and the root mean square gap
    over every sampled token; a missing or misshapen answer reads
    infinitely far."""

    worst, sq, count = 0.0, 0.0, 0
    for p, r in pairs:
        if p is None or tuple(p.shape) != tuple(r.shape):
            return {"logprob_gap_max": math.inf, "logprob_gap_rms": math.inf}
        d = (p.double() - r.double()).abs()
        worst = max(worst, float(d.max()))
        sq += float(d.pow(2).sum())
        count += d.numel()
    return {"logprob_gap_max": worst, "logprob_gap_rms": math.sqrt(sq / max(count, 1))}


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number that has a limit read, finite and within it."""

    return all(k in numbers and math.isfinite(numbers[k]) and numbers[k] <= lim
               for k, lim in limits.items())
