"""The host's seconds of a scoring forward against its device seconds: the
``model.prefill`` spans' host time over their hold on the stream."""

from portbench.spans import program_spans, ratio


def read(run):
    return ratio(program_spans(), ("model.prefill", "host_s"), ("model.prefill", "device_s"))
