"""The GEMM funnel's products of a forward at their roofline, over the
device time of the ``gemm_cuda`` kernels."""

from portbench.readers import roofline


def read(run):
    return roofline(run, "gemm", "gemm_bound_s")
