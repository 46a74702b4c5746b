"""The kernels' roofline share of a traced stretch."""

from __future__ import annotations

from benchmark import tracing
from benchmark.roofline import counts


def kernels_roofline_percent(summary):
    """100 x (sum of the bounds of the K1-K4 launches, by the program's
    launch counter, and of the `aten::_int_mm` calls, by their shapes) /
    (their device time); None where the stretch ran none of them."""
    if not summary:
        return None
    bound = 0.0
    for key, n in summary["shapes"].items():
        kernel, *args = key.split("|")
        work = counts.launch_work((kernel, *map(int, args)))
        if work is not None:
            bound += n * counts.bound_s(work)
    for mkn, n in summary["int_mm"].items():
        bound += n * counts.bound_s(counts.int8_gemm_work(*map(int, mkn.split("x"))), counts.INT8_OPS_PER_S)
    groups = tracing.group_seconds(summary)
    device_s = sum(groups[k] for k in tracing.ROOFLINE_KERNELS) + groups["int8_gemm"]
    return 100 * bound / device_s if bound > 0 and device_s > 0 else None
