"""sign_kernels_roofline: the sum of the bounds of every K1-K4 launch and
int8 GEMM of the traced signing calls over the sum of their device time,
in percent (`benchmark/roofline/counts.py`)."""

from benchmark.roofline.share import kernels_roofline_percent


def read(out):
    return kernels_roofline_percent(out.trace)
