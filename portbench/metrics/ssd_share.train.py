"""The Mamba2 scan's share of a training step on the device: the device
seconds of the ``ssm.scan`` spans (the forward and the remat recompute)
and of the ``ssm.scan.backward`` spans, over the ``trainer.step`` spans'
of the traced steps."""

from portbench.spans import program_spans, ratio

STEP = ("trainer.step", "device_s")


def read(run):
    spans = program_spans()
    parts = [ratio(spans, (name, "device_s"), STEP) for name in ("ssm.scan", "ssm.scan.backward")]
    return None if None in parts else sum(parts)
