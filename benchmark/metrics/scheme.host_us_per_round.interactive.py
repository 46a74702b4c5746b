"""scheme.host_us_per_round.interactive: as scheme.host_us_per_round.sign,
over the one-message calls of the interactive cell (a window of one
slot)."""

from benchmark import program_trace


def read(out):
    return program_trace.host_us_per_round(program_trace.totals())
