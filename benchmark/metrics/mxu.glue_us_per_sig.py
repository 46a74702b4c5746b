"""mxu.glue_us_per_sig: device time of every kernel, device copy and fill
that is neither one of the port's kernels (K1-K7) nor an int8 GEMM, nor a
copy between host and device, per signature of the traced stretch."""

from benchmark.tracing import glue_us_per_answer


def read(out):
    return glue_us_per_answer(out.trace)
