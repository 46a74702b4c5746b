"""scheme.launches_per_call: kernels that ran on the device per call of
the traced stretch (the profiler's kernel records: the port's own, the
GEMMs' and PyTorch's)."""


def read(out):
    t = out.trace
    return t["launches"] / t["calls"] if t and t["calls"] else None
