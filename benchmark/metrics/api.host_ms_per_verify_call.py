"""api.host_ms_per_verify_call: the api layer's own host time per
`Verifier.verify` call of the traced stretch, in ms: each api.verify
span less the time under api.h2d, api.d2h and the mxu and scheme spans
(the pair loop, mu hashing, the bool list and the call's own Python)."""

from benchmark import program_trace


def read(out):
    return program_trace.api_host_ms_per_call(program_trace.totals(), "api.verify")
