"""The arithmetic the per-layer readers share.  A reader takes the run
(``run["window"]``: the untraced window's seconds and units;
``run["trace"]``: :func:`portbench.tracing.summarise` of the traced
units, with ``units``; ``run["peaks"]``) and returns a number, or None
where it finds nothing to read."""

from __future__ import annotations

from portbench.tracing import union


def mfu(run):
    """The model FLOPs of the window's units over its time at the peak, %."""

    w = run["window"]
    flops = sum(u["model_flops"] for u in w["units"])
    if not flops or w["seconds"] <= 0:
        return None
    return 100.0 * flops / (w["seconds"] * run["peaks"]["bf16_flops"])


def idle_share(run):
    """The share of the window's time with nothing on the device, %: the
    device's busy seconds a token from the trace, against the untraced
    window's seconds a token.  (The profiler slows the host and so
    lengthens the traced window's own idle gaps; it does not lengthen the
    kernels.)"""

    t, w = run.get("trace"), run["window"]
    if not t or not t["busy_s"] or not w["units"]:
        return None
    busy = t["busy_s"] / sum(u["tokens"] for u in t["units"])
    spent = w["seconds"] / sum(u["tokens"] for u in w["units"])
    return 100.0 * (1.0 - busy / spent)


def roofline(run, family: str, bound_key: str):
    """The traced units' bound over the device seconds of ``family``'s
    kernels, %."""

    t = run.get("trace")
    if not t:
        return None
    spent = t["family_s"].get(family, 0.0)
    bound = sum(u[bound_key] for u in t["units"])
    if spent <= 0 or bound <= 0:
        return None
    return 100.0 * bound / spent


def overlap(run, family: str):
    """The share of ``family``'s kernel time on the two busiest streams
    that runs on both at once, %."""

    t = run.get("trace")
    streams = (t or {}).get("streams", {}).get(family, {})
    if len(streams) < 2:
        return None
    merged = sorted((union(iv) for iv in streams.values()),
                    key=lambda iv: -sum(e - s for s, e in iv))[:2]
    total = sum(e - s for iv in merged for s, e in iv)
    both, j = 0.0, 0
    a, b = merged
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            both += min(e, b[k][1]) - max(s, b[k][0])
            k += 1
    return 100.0 * 2 * both / total if total > 0 else None
