"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The run makes its weights and inputs from
the seed on the card, builds the program's object for the cell and warms
up every shape the cell uses (``setup_s``), measures whole units of work
(training steps or scoring requests) until ``--seconds`` have passed,
and with ``--trace 1`` traces a few more units.  Then it reads the
memory peak, frees the program's state, runs the plain reference on the
same inputs and compares.  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` and, traced, ``breakdown``; last in it,
``checks``: each compared number beside its limit, which also end
standard error.

The program is ``src/repro_torch``; nothing here imports JAX or the JAX
package, and a run that finds either loaded fails.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

from portbench import compare, counts, tracing
from portbench.cell import ROOT, check_port_config, load_cell, manifest
from portbench.reference.precision import strict_fp32

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACED_UNITS = {"train": 2, "score": 32}   # a score cell's deck, whole


def process_age_s() -> float:
    """Seconds since this process started (10 ms resolution)."""

    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def prepare_environment() -> None:
    """Caches at fixed paths inside the checkout; no tuning cache from the
    caller's environment; the program's sources on the path."""

    build = os.path.join(ROOT, "build")
    os.environ["REPRO_TORCH_BUILD_DIR"] = os.path.join(build, "kernels")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(build, "inductor")
    os.environ["USE_FLAX"] = "0"
    for var in ("REPRO_TORCH_TUNING_CACHE", "REPRO_TORCH_TUNING_SPEC"):
        os.environ.pop(var, None)
    src = os.path.join(ROOT, "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def plain(x):
    """``x`` with every non-finite float written as a string, so the line
    stays JSON."""

    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [plain(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    return x


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_reader(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reported(man: dict, cell: str) -> tuple:
    """The end-to-end and the per-layer metrics that ``cell`` reports."""

    e2e = [m for m in man["end_to_end"] if "workloads" not in m or cell in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def end_to_end(units: list, seconds: float, setup_s: float, peak_bytes: int) -> dict:
    tokens = sum(u["tokens"] for u in units)
    out = {"setup_s": setup_s, "peak_mem_gb": peak_bytes / 1e9,
           "train_tokens_per_s": tokens / seconds, "score_tokens_per_s": tokens / seconds}
    lat = [u["latency_s"] for u in units if "latency_s" in u]
    if lat:
        p95 = statistics.quantiles(lat, n=20)[-1] if len(lat) > 1 else lat[0]
        out["score_p95_ms"] = 1e3 * p95
    return out


def window(session, seconds: float) -> tuple:
    """Whole units until ``seconds`` have passed; each unit ends
    synchronised.  Returns ``(units, elapsed seconds)``."""

    units = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        units.append(session.unit(len(units)))
    return units, time.perf_counter() - t0


def run_cell(cell, seed: int, seconds: float, trace: bool, device, *, fault=None,
             control: bool = False, setup_clock=None) -> dict:
    """One run of ``cell``: set-up, window, optional trace, comparison.
    Returns the result object (without printing it).

    The memory peak is the window's: it is reset once set-up is done, so
    set-up's own readings for the comparison do not set it.  ``fault``
    plants a fault in the program's call (the driver's ``fault``);
    ``control`` puts the control, the reference with fp8 operands, in the
    program's place for the comparison (``calibrate.py``).  ``checks``
    holds every number the driver compares, each beside its limit (None
    where the cell sets none)."""

    kind = cell.traffic["kind"]
    driver = importlib.import_module(f"portbench.drivers.{kind}")
    session = driver.Session(cell, seed, device, fault=fault)
    built = setup_clock() if setup_clock else 0.0
    session.setup()
    setup_s = setup_clock() if setup_clock else 0.0
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    units, elapsed = window(session, seconds)
    traced = None
    if trace:
        n = TRACED_UNITS[kind]
        start = -(-len(units) // n) * n      # the next whole deck (or step)
        traced = tracing.trace(lambda: [session.unit(start + i) for i in range(n)])
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    prog = session.finish()
    t_ref = time.perf_counter()
    with strict_fp32():
        if control:
            prog = session.reference(prog, "fp8")
        ref = session.reference(prog, "fp32")
    numbers = driver.numbers(prog, ref)
    print(f"portbench: setup {setup_s:.3f} s ({built:.3f} s to the session), window "
          f"{elapsed:.3f} s over {len(units)} units, reference "
          f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    limits = cell.limits
    result = {"correct": compare.verdict(numbers, limits), "attempted": len(units), "failed": 0}
    man = manifest(ROOT)
    e2e, layer = reported(man, cell.name)
    if not trace:
        values = end_to_end(units, elapsed, setup_s, peak)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in e2e}
    else:
        run = {"window": {"seconds": elapsed, "units": units}, "trace": traced,
               "peaks": counts.peaks()}
        metrics = {}
        for m in layer:
            v = load_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result["metrics"] = metrics
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.entry["chips"], "memory_peak_bytes": peak}
    if trace:
        dev["busy_s"], dev["window_s"] = traced["busy_s"], traced["window_s"]
        result["breakdown"] = traced["breakdown"]
    result["device"] = dev
    result["checks"] = {k: {"value": numbers.get(k, math.inf), "limit": limits.get(k)}
                        for k in list(limits) + sorted(set(numbers) - set(limits))}
    return result


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    prepare_environment()
    cell = load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.entry["chips"]:
        print(f"portbench: {args.workload} needs {cell.entry['chips']} CUDA card(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from repro_torch.configs import get_config

    cell.port_cfg = get_config(cell.conf["port_arch"])
    check_port_config(cell.conf, cell.port_cfg)
    print(f"portbench: {args.workload} seed {args.seed} on {power_limit()}", file=sys.stderr)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                      setup_clock=process_age_s)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(plain(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
