"""mxu.glue_us_per_verify: as mxu.glue_us_per_sig, per verification of
the traced stretch."""

from benchmark.tracing import glue_us_per_answer


def read(out):
    return glue_us_per_answer(out.trace)
