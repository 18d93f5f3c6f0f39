"""Profile the serving engine's steady-state decode: where a step's time goes.

Four measurements of the dense and the paged engine on the same weights
and requests:

  * **windows** — the engine serves ``--batch`` requests for ``--gen-len``
    tokens, ``REPEATS`` times per engine in alternation; each run's
    steady-state tokens/s and ms per step (warm-up excluded), so the
    spread between runs of one configuration is on record;
  * **trace** — a ``torch.profiler`` trace of up to ``TRACE_STEPS`` steady
    decode steps: wall per step, the device's busy time per step (the
    union of its kernel and copy intervals), the idle share, the kernels
    by time and the host operations by self CPU time (host synchronisations
    among them);
  * **python** — a ``cProfile`` of as many further steps: the Python
    functions by own time, and by cumulative time within the package;
  * **block search** — the host cost of one ``derive_block_config`` search
    at each of the decode step's GEMM shapes, uncached and memoised.

Example (one H100; ``--arch qwen2-moe-a2.7b`` profiles the MoE step)::

    PYTHONPATH=src python -m repro_torch.launch.profile_decode \\
        --arch internlm2-1.8b --out profile_decode.json

The whole record goes to ``--out`` as JSON; a summary is printed.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import statistics
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.asymmetric import AsymmetricMesh, biglittle_classes
from repro_torch.core.blocking import derive_block_config
from repro_torch.models import model_zoo as Z
from repro_torch.models import transformer as T
from repro_torch.runtime.serving import ServingEngine, resolve_device
from repro_torch.util.atomic import atomic_write_json

_ENGINES = ("dense", "paged")
REPEATS = 4        # windows per engine: enough to show the spread between runs
TRACE_STEPS = 10   # steps per profiled span (fewer if --gen-len cannot hold two)
PAGE_SIZE = 8      # the paged engine's page, as in chip_smoke.py: three pages a slot


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=40,
                    help="tokens per request; a window has gen-len - 2 steady steps")
    ap.add_argument("--out", default=None, help="JSON record (default: print only)")
    return ap


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _engine(cfg, params, args, kind: str, device) -> ServingEngine:
    asym = AsymmetricMesh(biglittle_classes(chips_per_pod=1), batch_tile=1)
    return ServingEngine(
        cfg, params, asym,
        seq_cap=args.prompt_len + args.gen_len,
        slots_per_pod=asym.batch_layout(args.batch).c_max,
        paged="on" if kind == "paged" else "off",
        page_size=PAGE_SIZE,
        device=device,
    )


def _windows(cfg, params, prompts, args, device) -> dict:
    runs = {k: [] for k in _ENGINES}
    for _ in range(REPEATS):
        for kind in _ENGINES:
            eng = _engine(cfg, params, args, kind, device)
            eng.generate(prompts, args.gen_len)
            st = eng.stats
            runs[kind].append({
                "tokens_per_s": st.tokens_per_s,
                "ms_per_step": 1e3 * st.decode_s / st.decode_steps,
                "steps": st.decode_steps,
                "warmup_s": st.compile_s,
            })
    out = {}
    for kind, rs in runs.items():
        tps = [r["tokens_per_s"] for r in rs]
        out[kind] = {"runs": rs, "tokens_per_s_median": statistics.median(tps),
                     "tokens_per_s_min": min(tps), "tokens_per_s_max": max(tps)}
    return out


def _union_us(intervals) -> float:
    busy, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def _trace(eng: ServingEngine, n: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if eng.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(eng.device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n

    device_ev = [e for e in prof.events() if e.device_type != DeviceType.CPU]
    busy_ms = _union_us((e.time_range.start, e.time_range.end) for e in device_ev) / 1e3 / n
    by_kernel: dict[str, list] = {}
    for e in device_ev:
        rec = by_kernel.setdefault(e.name, [0, 0.0])
        rec[0] += 1
        rec[1] += e.time_range.elapsed_us()
    kernels = sorted(
        ({"name": k[:120], "per_step": c / n, "ms_per_step": us / 1e3 / n}
         for k, (c, us) in by_kernel.items()),
        key=lambda r: -r["ms_per_step"],
    )
    host = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    ops = sorted(
        ({"name": e.key, "per_step": e.count / n, "self_cpu_ms_per_step": e.self_cpu_time_total / 1e3 / n}
         for e in host),
        key=lambda r: -r["self_cpu_ms_per_step"],
    )
    syncs = [o for o in ops if "Synchronize" in o["name"]]
    return {
        "steps": n,
        "wall_ms_per_step": wall_ms,
        "device_seen": bool(device_ev),
        "device_busy_ms_per_step": busy_ms if device_ev else None,
        "device_idle_share": 1 - busy_ms / wall_ms if device_ev else None,
        "device_ops_per_step": len(device_ev) / n,
        "host_op_self_cpu_ms_per_step": sum(o["self_cpu_ms_per_step"] for o in ops),
        "sync_calls_per_step": sum(o["per_step"] for o in syncs),
        "sync_ms_per_step": sum(o["self_cpu_ms_per_step"] for o in syncs),
        "kernels": kernels[:12],
        "host_ops": ops[:20],
    }


def _where(path: str) -> str:
    i = path.find("repro_torch")
    return path[i:] if i >= 0 else os.path.basename(path)


def _python(eng: ServingEngine, n: int) -> dict:
    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    for _ in range(n):
        eng.step()
    pr.disable()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = [
        {"fn": f"{_where(f)}:{line}({name})", "calls_per_step": nc / n,
         "own_ms_per_step": tt * 1e3 / n, "cum_ms_per_step": ct * 1e3 / n}
        for (f, line, name), (_, nc, tt, ct, _) in pstats.Stats(pr).stats.items()
    ]
    ours = [r for r in rows if r["fn"].startswith("repro_torch")]
    return {
        "steps": n,
        "wall_ms_per_step": wall_ms,
        "by_own_time": sorted(rows, key=lambda r: -r["own_ms_per_step"])[:20],
        "package_by_cum_time": sorted(ours, key=lambda r: -r["cum_ms_per_step"])[:20],
    }


def _block_search(cfg, m: int) -> dict:
    """Host µs of one block derivation per decode GEMM shape, and the
    total over one step's GEMMs (``transformer.gemm_shapes``), with and
    without the memo."""

    shapes = T.gemm_shapes(cfg)
    out = {"uncached_ms_per_step": 0.0, "memoised_ms_per_step": 0.0, "shapes": []}
    reps = 50
    for (k, n), count in shapes:
        row = {"shape": [m, k, n], "per_step": count}
        for key, fn in (("uncached_us", derive_block_config.__wrapped__),
                        ("memoised_us", derive_block_config)):
            fn(m, k, n)
            t0 = time.perf_counter()
            for _ in range(reps):
                fn(m, k, n)
            row[key] = (time.perf_counter() - t0) * 1e6 / reps
        out["uncached_ms_per_step"] += count * row["uncached_us"] / 1e3
        out["memoised_ms_per_step"] += count * row["memoised_us"] / 1e3
        out["shapes"].append(row)
    return out


def profile_decode(args) -> dict:
    n_steps = min(TRACE_STEPS, (args.gen_len - 2) // 2)
    if n_steps < 1:
        raise SystemExit("--gen-len must cover the warm-up step and two profiled steps")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = Z.init_params(cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab, size=(args.batch, args.prompt_len), dtype=np.int32)

    record = {"arch": cfg.name, "batch": args.batch, "prompt_len": args.prompt_len,
              "gen_len": args.gen_len, "page_size": PAGE_SIZE,
              "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    record["windows"] = _windows(cfg, params, prompts, args, device)
    for kind in _ENGINES:
        eng = _engine(cfg, params, args, kind, device)
        for r in range(args.batch):
            eng.submit(prompts[r], args.gen_len)
        eng.admit()
        eng.step()  # warm-up
        record[kind] = {"trace": _trace(eng, n_steps), "python": _python(eng, n_steps)}
        record[kind]["slots"] = eng.n_slots
    record["block_search"] = _block_search(cfg, record["dense"]["slots"])
    return record


def _summary(rec: dict) -> str:
    lines = [f"{rec['arch']} on {rec['device']}: {rec['batch']} requests, "
             f"prompt {rec['prompt_len']}, {rec['gen_len']} new tokens"]
    for kind in _ENGINES:
        w = rec["windows"][kind]
        tps = ", ".join(f"{r['tokens_per_s']:.6g}" for r in w["runs"])
        tr, py = rec[kind]["trace"], rec[kind]["python"]
        lines.append(f"{kind}: tokens/s per window [{tps}] ({w['runs'][0]['steps']} steady steps each)")
        lines.append(
            f"  trace: {tr['wall_ms_per_step']:.6g} ms/step wall, device busy "
            f"{tr['device_busy_ms_per_step']} ms/step, idle share {tr['device_idle_share']}, "
            f"{tr['device_ops_per_step']:.6g} device ops/step, host ops self CPU "
            f"{tr['host_op_self_cpu_ms_per_step']:.6g} ms/step, syncs {tr['sync_calls_per_step']:.6g}"
            f"/step taking {tr['sync_ms_per_step']:.6g} ms")
        for k in tr["kernels"][:5]:
            lines.append(f"    kernel {k['ms_per_step']:.6g} ms/step x{k['per_step']:.6g} {k['name'][:70]}")
        for o in tr["host_ops"][:8]:
            lines.append(f"    host op {o['self_cpu_ms_per_step']:.6g} ms/step x{o['per_step']:.6g} {o['name']}")
        lines.append(f"  python: {py['wall_ms_per_step']:.6g} ms/step under cProfile")
        for r in py["by_own_time"][:8]:
            lines.append(f"    own {r['own_ms_per_step']:.6g} ms/step x{r['calls_per_step']:.6g} {r['fn']}")
        for r in py["package_by_cum_time"][:8]:
            lines.append(f"    cum {r['cum_ms_per_step']:.6g} ms/step x{r['calls_per_step']:.6g} {r['fn']}")
    bs = rec["block_search"]
    lines.append(f"block search per step: uncached {bs['uncached_ms_per_step']:.6g} ms, "
                 f"memoised {bs['memoised_ms_per_step']:.6g} ms")
    return "\n".join(lines)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    rec = profile_decode(args)
    if args.out:
        atomic_write_json(args.out, rec)
    print(_summary(rec))
    return rec


if __name__ == "__main__":
    main()
