"""Roofline analysis over the dry-run artifacts.

The port's counterpart of ``repro.launch.roofline``.  Per (arch x shape x
mesh) cell, the three roofline terms from the dry-run's operator counts
(``launch.op_analysis``; all per device: one card, or rank 0 of a
production mesh, whose ``hlo_flops_global`` is its FLOPs times the
mesh's devices, as the reference's):

    compute term    = FLOPs / peak FLOP/s              [s]
    memory term     = bytes / HBM bandwidth            [s]
    collective term = collective bytes / NVLink        [s]

Hardware model: an H100 as ``core.blocking.HopperClassSpec`` describes it
(``peak_flops``, dense bf16 on the tensor cores; ``hbm_bw``) and one
NVLink link a direction (``core.asymmetric.DeviceClass.ici_bw``).  The
collective term is 0 on one card except for a class-sharded cell, whose
cross-pod reduction would cross NVLink were its pods on two cards.  On
the 16x16 and 2x16x16 meshes it is a device's collective bytes over that
one link: a lower bound, since a 16-wide ``model`` axis spans two 8-card
NVLink domains of H100 nodes and its collectives cross the slower
inter-node network.

``memory_flash_s`` drops the attention's score traffic (the plain
attentions the dry-run runs write their scores, probabilities and fp32
copies to memory; ``flash_attention_cuda`` and ``paged_attention_cuda``
keep them on chip), and the bottleneck is classified on that path.  Also reported: MODEL_FLOPS = 6·N·D for training
(2·N·D forward-only; N active parameters for MoE) and its ratio to the
counted FLOPs (remat and the plain paths push it below 1).

These are counts from shapes and the card's data-sheet rates, not times.
"""

from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass
from typing import Optional

from repro_torch.configs import get_config
from repro_torch.core.asymmetric import DeviceClass
from repro_torch.core.blocking import H100

PEAK_FLOPS = H100.peak_flops
HBM_BW = H100.hbm_bw
LINK_BW = DeviceClass(name=H100.name).ici_bw


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    tag: str
    chips: int
    compute_s: float
    memory_s: float          # as run (plain attention: scores reach memory)
    memory_flash_s: float    # with the attention kernels (scores stay on chip)
    collective_s: float
    bottleneck: str          # classified on the flash path (the card's hot path)
    model_flops: float
    hlo_flops_global: float
    useful_ratio: float
    roofline_fraction: float  # compute_s / max(all terms): 1.0 == compute-bound at peak
    memory_gib: Optional[float]
    fits: Optional[bool] = None

    def step_time_s(self) -> float:
        """Lower-bound step time: terms assumed perfectly overlapped."""

        return max(self.compute_s, self.memory_flash_s, self.collective_s)


def model_flops(arch: str, shape_name: str) -> float:
    cfg = get_config(arch)
    shape = next(s for s in cfg.shapes(include_skipped=True) if s.name == shape_name)
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.global_batch


def terms(cost: dict) -> dict:
    """The three roofline terms (seconds) of one counted step."""

    score = cost.get("attn_score_bytes", 0.0)
    return {
        "compute_s": cost["flops"] / PEAK_FLOPS,
        "memory_s": cost["bytes"] / HBM_BW,
        "memory_flash_s": max(cost["bytes"] - score, 0.0) / HBM_BW,
        "collective_s": cost["collective_bytes"] / LINK_BW,
    }


def analyze_record(rec: dict) -> Optional[RooflineRow]:
    if not rec.get("ok"):
        return None
    chips = rec["n_chips"]
    hlo = rec["hlo_cost"]
    t = terms(hlo)
    bound = {"compute": t["compute_s"], "memory": t["memory_flash_s"],
             "collective": t["collective_s"]}
    bottleneck = max(bound, key=bound.get)
    try:
        mf = model_flops(rec["arch"], rec["shape"])
    except (KeyError, StopIteration, ModuleNotFoundError):
        mf = 0.0  # a reduced or hand-made cell: no published config
    hlo_global = hlo["flops"] * chips
    mem = rec.get("memory", {}).get("total_bytes")
    return RooflineRow(
        arch=rec["arch"],
        shape=rec["shape"],
        mesh=rec["mesh"],
        tag=rec.get("tag", ""),
        chips=chips,
        compute_s=t["compute_s"],
        memory_s=t["memory_s"],
        memory_flash_s=t["memory_flash_s"],
        collective_s=t["collective_s"],
        bottleneck=bottleneck,
        model_flops=mf,
        hlo_flops_global=hlo_global,
        useful_ratio=mf / hlo_global if hlo_global else 0.0,
        roofline_fraction=t["compute_s"] / max(max(bound.values()), 1e-30),
        memory_gib=mem / 2**30 if mem else None,
        fits=rec.get("fits"),
    )


def load_rows(art_dir: str = os.path.join("artifacts", "dryrun_torch"),
              mesh: Optional[str] = "card1", tag: str = "") -> list[RooflineRow]:
    rows = []
    for path in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if mesh and rec.get("mesh") != mesh:
            continue
        if rec.get("tag", "") != tag:
            continue
        row = analyze_record(rec)
        if row:
            rows.append(row)
    return rows


def format_table(rows: list[RooflineRow]) -> str:
    hdr = (
        f"{'arch':18s} {'shape':12s} {'chips':>5s} {'compute_s':>10s} {'mem_s':>10s} "
        f"{'mem_flash':>10s} {'collect_s':>10s} {'bound':>10s} {'MF/HLO':>7s} "
        f"{'roofl%':>7s} {'GiB/card':>9s} {'fits':>5s}"
    )
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r.arch:18s} {r.shape:12s} {r.chips:5d} {r.compute_s:10.3e} "
            f"{r.memory_s:10.3e} {r.memory_flash_s:10.3e} {r.collective_s:10.3e} "
            f"{r.bottleneck:>10s} {r.useful_ratio:7.2f} {100 * r.roofline_fraction:6.1f}% "
            f"{r.memory_gib if r.memory_gib is not None else float('nan'):9.2f} "
            f"{str(r.fits):>5s}"
        )
    return "\n".join(lines)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.roofline")
    ap.add_argument("--dir", default=os.path.join("artifacts", "dryrun_torch"))
    ap.add_argument("--mesh", default="card1",
                    help="card1, pod16x16 or pod2x16x16 (the dry-run's mesh tags)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--csv", default=None)
    args = ap.parse_args(argv)
    rows = load_rows(args.dir, args.mesh, args.tag)
    print(format_table(rows))
    if args.csv:
        with open(args.csv, "w") as f:
            f.write(
                "arch,shape,mesh,chips,compute_s,memory_s,memory_flash_s,"
                "collective_s,bottleneck,model_flops,hlo_flops_global,"
                "useful_ratio,roofline_fraction,memory_gib,fits\n"
            )
            for r in rows:
                f.write(
                    f"{r.arch},{r.shape},{r.mesh},{r.chips},{r.compute_s},"
                    f"{r.memory_s},{r.memory_flash_s},{r.collective_s},"
                    f"{r.bottleneck},{r.model_flops},{r.hlo_flops_global},"
                    f"{r.useful_ratio},{r.roofline_fraction},{r.memory_gib},{r.fits}\n"
                )


if __name__ == "__main__":
    main()


__all__ = ["HBM_BW", "LINK_BW", "PEAK_FLOPS", "RooflineRow", "analyze_record",
           "format_table", "load_rows", "main", "model_flops", "terms"]
