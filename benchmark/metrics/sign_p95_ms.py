"""sign_p95_ms: the 95th percentile (linear interpolation) of every call
in the window, on the host clock from the call to its returned bytes.
The count of calls and their median go to stderr beside it."""

import numpy as np

from benchmark.harness import log


def read(out):
    lat = np.asarray(out.latencies_s) * 1e3
    if lat.size < 20:  # fewer than one call beyond the percentile
        return None
    p95 = float(np.percentile(lat, 95))
    log(f"sign latency: {lat.size} calls, median {float(np.median(lat))} ms, p95 {p95} ms, max {float(lat.max())} ms")
    return p95
