"""The device's idle share in the traced stretch: 1 - (the union of its
kernels, copies and fills) / (first call's start to last call's end)."""

from benchmark.tracing import idle_share


def read(out):
    return idle_share(out.trace)
