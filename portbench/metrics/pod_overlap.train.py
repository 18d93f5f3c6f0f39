"""The share of the two pods' GEMM kernel time that runs at once."""

from portbench.readers import overlap


def read(run):
    return overlap(run, "gemm")
