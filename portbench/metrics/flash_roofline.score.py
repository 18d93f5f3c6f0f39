"""The causal attention of every traced request at its length, at the
roofline, over the device time of ``flash_attention_cuda``."""

from portbench.readers import roofline


def read(run):
    return roofline(run, "flash", "flash_bound_s")
