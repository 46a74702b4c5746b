"""setup_s: seconds from the process's start to the window's first call:
imports, kernel and library builds (a checkout's first run), the key,
the program's operators, the inputs and the warm-up calls."""


def read(out):
    return out.setup_s
