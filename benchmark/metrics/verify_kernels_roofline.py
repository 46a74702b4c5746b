"""verify_kernels_roofline: as sign_kernels_roofline, over the traced
verify calls."""

from benchmark.roofline.share import kernels_roofline_percent


def read(out):
    return kernels_roofline_percent(out.trace)
