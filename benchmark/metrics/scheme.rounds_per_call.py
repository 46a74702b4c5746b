"""scheme.rounds_per_call: rounds of the round loop (scheme.rounds) per
`Signer.sign` call (api.sign spans) of the traced stretch. With one slot
a round, a call's rounds are its message's attempts."""

from benchmark import program_trace


def read(out):
    return program_trace.counter_ratio(program_trace.totals(), "scheme.rounds", "api.sign", den_span=True)
