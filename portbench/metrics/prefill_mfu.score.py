"""The traced requests' model FLOPs over the ``model.prefill`` spans'
device seconds at the bf16 peak: ``mfu.score`` without the host's gaps
between requests and without the client's log-probability reduction."""

from portbench.spans import program_spans, span_mfu, traced_units


def read(run):
    return span_mfu(program_spans(), traced_units(run), run["peaks"])
