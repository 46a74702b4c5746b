"""scheme.host_us_per_round.sign: the round loop's host time per round
of the traced signing calls, in us: each scheme.round span less its one
host sync (scheme.sync), the device's wait."""

from benchmark import program_trace


def read(out):
    return program_trace.host_us_per_round(program_trace.totals())
