"""The host's seconds of a training step against its device seconds: the
``trainer.step`` spans' host time over their hold on the stream.  Near
100% the host paces the step."""

from portbench.spans import program_spans, ratio


def read(run):
    return ratio(program_spans(), ("trainer.step", "host_s"), ("trainer.step", "device_s"))
