"""The Mamba2 scan's share of its roofline in training: the least time of
the work the model needs (each forward ``ssm.scan`` span's
``families.ssm.ssd_bound_s`` at its own tags, three times: the forward and
a backward of twice its work; no recompute) over the device seconds of
every ``ssm.scan`` span, recompute included, and every
``ssm.scan.backward`` span.  It judges the scan whatever implements it."""

from portbench.families import ssm
from portbench.spans import program_spans


def read(run):
    spans = program_spans() or []
    scans = [s for s in spans if s.name == "ssm.scan"]
    back = [s for s in spans if s.name == "ssm.scan.backward"]
    if not scans or not back or any(s.device_s is None for s in scans + back):
        return None
    need = sum(3 * ssm.ssd_bound_s(s.args, run["peaks"]) for s in scans
               if s.args.get("phase") == "forward")
    spent = sum(s.device_s for s in scans + back)
    return 100.0 * need / spent if need > 0 and spent > 0 else None
