"""verifies_per_s: every (message, signature) pair answered in the window
over the window's time, from the first call's start to the last call's
end."""


def read(out):
    return out.answered / out.window_s if out.window_s > 0 else None
