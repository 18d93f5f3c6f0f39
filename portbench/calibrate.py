"""The readings a cell's limits are set from, in one process.

    python3 -m portbench.calibrate --workload <name> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--fault half_batch:7,8,9] [--seconds 0] [--out <file>]

Each reading is one run of the harness's own ``run.run_cell`` with a
window of ``--seconds`` (0 for a training cell, whose checked steps are
set-up's; a scoring cell needs a window that answers a whole deck): for
each seed of ``--seeds`` the program; for each ``--control-seeds`` seed
the control, the reference computed with fp8 operands, judged in the
program's place; ``--fault kind:seeds`` plants a fault in the program's
call (the driver's ``fault``).  Each reading is one JSON line on standard
output (and in ``--out``): every number the driver compares, limited or
not.  The limits in ``workloads/<name>.json`` come from them (README).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import run as RUN


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", action="append", default=[], help="kind:seed,seed,...")
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    RUN.prepare_environment()
    import torch

    from portbench.cell import check_port_config, load_cell
    from repro_torch.configs import get_config

    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload, RUN.ROOT)
    cell.port_cfg = get_config(cell.conf["port_arch"])
    check_port_config(cell.conf, cell.port_cfg)
    print(f"portbench.calibrate: {args.workload} on {RUN.power_limit()}", file=sys.stderr)
    jobs = [dict(seed=s) for s in _seeds(args.seeds)]
    jobs += [dict(seed=s, control=True) for s in _seeds(args.control_seeds)]
    for spec in args.fault:
        kind, seeds = spec.split(":")
        jobs += [dict(seed=s, fault=kind) for s in _seeds(seeds)]
    out = open(args.out, "a") if args.out else None
    try:
        for job in jobs:
            t0 = time.perf_counter()
            res = RUN.run_cell(cell, job["seed"], args.seconds, False, "cuda",
                               fault=job.get("fault"), control=job.get("control", False))
            rec = dict(job, workload=args.workload, correct=res["correct"],
                       numbers={k: c["value"] for k, c in res["checks"].items()},
                       seconds=time.perf_counter() - t0)
            line = json.dumps(RUN.plain(rec))
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
