"""Trace report CLI: summarize a trace file, export Chrome trace JSON.

Reads either the native buffer format (``TraceBuffer.save``) or an
already-exported Chrome ``traceEvents`` file and prints a per-name
summary (count, total/mean/max duration) plus a per-device-class
rollup of the spans that carry scheduling provenance.

Robust to damaged inputs by design: the post-mortem tool for a killed
engine must not die of the kill itself.  A truncated or corrupt trace
file is *salvaged* — every record that still parses is kept, bad ones
are skipped and counted (``skipped_records`` in the meta, a WARNING in
the CLI header) — instead of crashing on the first bad byte.

Usage::

    python -m repro.observability.report trace.json [--chrome out.json]
                                                    [--top N]
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from typing import Optional, Sequence

from repro_torch.util.atomic import atomic_write_json


def _salvage_events(text: str) -> tuple[list[dict], int]:
    """Recover parseable event objects from a damaged trace file.

    Scans the region after the first ``"events"``/``"traceEvents"`` key
    (or the whole text when neither survives), decoding one JSON object
    at a time; anything that fails to parse is skipped to the next ``{``
    and counted.  Lossy by nature — the point is that a truncated tail
    (killed engine, full disk) costs only the torn record, not the run's
    whole trace.
    """

    m = re.search(r'"(?:traceEvents|events)"\s*:\s*\[', text)
    pos = m.end() if m else 0
    dec = json.JSONDecoder()
    events: list[dict] = []
    skipped = 0
    while True:
        nxt = text.find("{", pos)
        if nxt < 0:
            break
        # A '{' at depth 0 here is an event candidate; on decode failure
        # count it and resume after the brace.
        try:
            obj, end = dec.raw_decode(text, nxt)
        except json.JSONDecodeError:
            skipped += 1
            pos = nxt + 1
            continue
        if isinstance(obj, dict):
            events.append(obj)
        else:
            skipped += 1
        pos = end
    return events, skipped


def load_events(path: str) -> tuple[list[dict], dict]:
    """Normalize either trace format to native-style event dicts
    (``ts``/``dur`` in seconds); returns ``(events, meta)``.

    Corrupt or truncated files degrade to a salvage scan: bad records
    are skipped, and their count lands in ``meta["skipped_records"]``
    (0 when the file parsed cleanly).
    """

    with open(path) as f:
        text = f.read()
    skipped = 0
    try:
        data = json.loads(text)
    except json.JSONDecodeError:
        chrome = '"traceEvents"' in text
        raw, skipped = _salvage_events(text)
        skipped = max(skipped, 1)  # the torn tail itself counts
        if chrome:
            data = {"traceEvents": raw}
        else:
            data = {"events": raw}
    if isinstance(data, dict) and "traceEvents" in data:
        events = []
        for ev in data["traceEvents"]:
            if not isinstance(ev, dict):
                skipped += 1
                continue
            events.append({
                "name": ev.get("name", "?"),
                "cat": ev.get("cat", "span"),
                "ph": ev.get("ph", "X"),
                "ts": float(ev.get("ts", 0.0)) / 1e6,
                "dur": float(ev.get("dur", 0.0)) / 1e6,
                "tid": ev.get("tid", 0),
                "parent": (ev.get("args") or {}).get("parent"),
                "args": ev.get("args") or {},
            })
        meta = {"format": "chrome", **(data.get("otherData") or {})}
        meta["skipped_records"] = skipped
        return events, meta
    if isinstance(data, dict) and "events" in data:
        meta = {k: v for k, v in data.items() if k != "events"}
        events = []
        for ev in data["events"]:
            if isinstance(ev, dict):
                events.append(ev)
            else:
                skipped += 1
        meta = {"format": "native", **meta}
        meta["skipped_records"] = skipped
        return events, meta
    raise ValueError(f"{path}: neither a native trace nor a Chrome trace")


def summarize(events: list[dict], *, top: int = 20) -> str:
    spans = [e for e in events if e.get("ph") == "X"]
    instants = [e for e in events if e.get("ph") == "i"]

    by_name: dict[str, list[float]] = {}
    for e in spans:
        by_name.setdefault(e.get("name", "?"), []).append(
            float(e.get("dur", 0.0))
        )
    by_class: dict[str, list[float]] = {}
    for e in spans:
        dc = (e.get("args") or {}).get("device_class")
        if dc:
            by_class.setdefault(str(dc), []).append(float(e.get("dur", 0.0)))

    lines = [
        f"{len(events)} events ({len(spans)} spans, {len(instants)} instants)",
        "",
        f"{'span':<32}{'count':>8}{'total_ms':>12}{'mean_ms':>10}{'max_ms':>10}",
    ]
    ranked = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))
    for name, durs in ranked[:top]:
        total = sum(durs)
        lines.append(
            f"{name:<32}{len(durs):>8}{total * 1e3:>12.2f}"
            f"{total / len(durs) * 1e3:>10.3f}{max(durs) * 1e3:>10.3f}"
        )
    if len(ranked) > top:
        lines.append(f"... {len(ranked) - top} more span names (--top to widen)")

    if by_class:
        lines += ["", f"{'device_class':<32}{'spans':>8}{'total_ms':>12}"]
        for dc, durs in sorted(by_class.items()):
            lines.append(f"{dc:<32}{len(durs):>8}{sum(durs) * 1e3:>12.2f}")

    if instants:
        counts: dict[str, int] = {}
        for e in instants:
            name = e.get("name", "?")
            counts[name] = counts.get(name, 0) + 1
        lines += ["", "instants: " + ", ".join(
            f"{n}×{c}" for n, c in sorted(counts.items())
        )]

    kv = kv_pool_rollup(instants)
    if kv is not None:
        lines += ["", (
            "kv page pool: peak {peak_live_pages} pages live "
            "({allocs} allocs / {frees} frees, {pages_allocated} pages in / "
            "{pages_freed} out, final live {final_live_pages})"
        ).format(**kv)]
    return "\n".join(lines)


def kv_pool_rollup(instants: list[dict]) -> Optional[dict]:
    """Peak page occupancy from ``engine.page_alloc``/``engine.page_free``.

    Each instant carries the pool's ``pages_live`` *after* the event, so
    the peak over the stream is the pool's true high-water mark (matching
    ``PagePool.peak_live`` when the trace covers the engine's lifetime).
    Returns None when the trace has no page events.
    """

    allocs = [e for e in instants if e.get("name") == "engine.page_alloc"]
    frees = [e for e in instants if e.get("name") == "engine.page_free"]
    if not allocs and not frees:
        return None
    events = sorted(allocs + frees, key=lambda e: float(e.get("ts", 0.0)))
    live = [int((e.get("args") or {}).get("pages_live", 0)) for e in events]
    return {
        "allocs": len(allocs),
        "frees": len(frees),
        "pages_allocated": sum(
            int((e.get("args") or {}).get("pages", 0)) for e in allocs),
        "pages_freed": sum(
            int((e.get("args") or {}).get("pages", 0)) for e in frees),
        "peak_live_pages": max(live) if live else 0,
        "final_live_pages": live[-1] if live else 0,
    }


def export_chrome(events: list[dict], path: str) -> str:
    import os

    out = []
    for e in events:
        rec = {
            "name": e.get("name", "?"),
            "cat": e.get("cat", "span"),
            "ph": e.get("ph", "X"),
            "ts": round(max(float(e.get("ts", 0.0)), 0.0) * 1e6, 3),
            "pid": os.getpid(),
            "tid": e.get("tid", 0),
            "args": dict(e.get("args") or {}),
        }
        if rec["ph"] == "X":
            rec["dur"] = round(float(e.get("dur", 0.0)) * 1e6, 3)
        if rec["ph"] == "i":
            rec["s"] = "t"
        if e.get("parent"):
            rec["args"]["parent"] = e["parent"]
        out.append(rec)
    return atomic_write_json(
        path, {"traceEvents": out, "displayTimeUnit": "ms"},
        indent=1, sort_keys=False, default=str,
    )


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro.observability.report",
        description="Summarize a repro trace file; optionally export Chrome trace.",
    )
    ap.add_argument("trace", help="native trace (TraceBuffer.save) or Chrome JSON")
    ap.add_argument("--chrome", default=None,
                    help="write a Chrome traceEvents JSON here")
    ap.add_argument("--top", type=int, default=20,
                    help="span names to show in the duration table")
    args = ap.parse_args(argv)

    events, meta = load_events(args.trace)
    dropped = meta.get("dropped", 0)
    head = f"{args.trace} [{meta.get('format')}]"
    if dropped:
        head += f" — WARNING: {dropped} events dropped (buffer capacity)"
    skipped = meta.get("skipped_records", 0)
    if skipped:
        head += (
            f" — WARNING: {skipped} corrupt/truncated records skipped"
        )
    print(head)
    print(summarize(events, top=args.top))
    if args.chrome:
        print(f"wrote Chrome trace to {export_chrome(events, args.chrome)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
