"""A ``torch.profiler`` trace of a few of the window's units, reduced to
what the per-layer readers and the breakdown take.

The device is busy where a kernel, a copy or a fill runs: the union of
their intervals (the arithmetic of the program's
``launch/profile_decode.py``, copied here and frozen).  The traced window
is the span of the benchmark's own ``portbench.window`` annotation, which
ends after the last unit's synchronisation.  An idle gap is named after
the innermost host operation running at its middle.
"""

from __future__ import annotations

import json
import os
import re

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
MARK = "portbench.window"
TOP = 10


def kernel_families() -> dict:
    with open(os.path.join(HERE, "kernels.json")) as f:
        spec = json.load(f)
    return {k: re.compile(v) for k, v in spec.items() if k != "about"}


def union(intervals) -> list:
    """Merged ``[(start, end)]`` of possibly overlapping intervals."""

    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(iv, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in iv if e > lo and s < hi]


def summarise(device_events, host_events, window) -> dict:
    """``device_events``: ``[(name, start_us, end_us, stream)]``;
    ``host_events``: ``[(name, start_us, end_us)]``; ``window``: ``(lo,
    hi)`` in µs.  Returns the busy and window seconds, the device seconds
    of each kernel family, the top device operations and idle gaps, and
    each family's intervals by stream."""

    lo, hi = window
    dev = [(n, max(s, lo), min(e, hi), st) for n, s, e, st in device_events if e > lo and s < hi]
    busy = union((s, e) for _, s, e, _ in dev)
    fams = kernel_families()
    fam_s = {k: 0.0 for k in fams}
    by_name, streams = {}, {}
    for n, s, e, st in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
        for k, rx in fams.items():
            if rx.search(n):
                fam_s[k] += (e - s) / 1e6
                streams.setdefault(k, {}).setdefault(st, []).append((s, e))
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    host = sorted(host_events, key=lambda h: h[1])
    named_gaps = []
    for s, e in gaps[:TOP]:
        mid = (s + e) / 2
        inner = [h for h in host if h[1] <= mid <= h[2] and h[0] != MARK]
        label = max(inner, key=lambda h: h[1])[0] if inner else "no host operation"
        named_gaps.append([label, (e - s) / 1e6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": sum(e - s for s, e in busy) / 1e6,
        "family_s": fam_s,
        "streams": streams,
        "breakdown": {"device_ops": [[n[:160], us / 1e6] for n, us in ops],
                      "idle_gaps": named_gaps},
    }


def trace(run_units) -> dict:
    """Run ``run_units()`` under the profiler; returns :func:`summarise`
    of it, with ``units``: what ``run_units`` returned."""

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(MARK):
            units = run_units()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    events = prof.events()
    marks = [e for e in events if e.name == MARK and e.device_type == DeviceType.CPU]
    window = (marks[0].time_range.start, marks[0].time_range.end)
    device, host = [], []
    for e in events:
        if e.name == MARK:
            continue
        rec = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CPU:
            host.append(rec)
        else:
            device.append(rec + (getattr(e, "device_resource_id", 0),))
    out = summarise(device, host, window)
    out["units"] = units
    out["device_events"] = len(device)
    return out
