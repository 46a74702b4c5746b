"""signs_per_s: every signature returned in the window over the window's
time, from the first call's start to the last call's end (with several
ranks, the global count over the slowest rank's window)."""


def read(out):
    return out.answered / out.window_s if out.window_s > 0 else None
