"""scheme.slot_yield: the attempts the traced calls' messages needed
(scheme.attempts, the serial signer's count) over the attempt slots the
round loop ran for them (scheme.slots: the window each round): 1 where
no slot idles or tries past a message's accepted kappa."""

from benchmark import program_trace


def read(out):
    return program_trace.counter_ratio(program_trace.totals(), "scheme.attempts", "scheme.slots")
