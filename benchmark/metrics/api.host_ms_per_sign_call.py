"""api.host_ms_per_sign_call: as api.host_ms_per_verify_call, per
`Signer.sign` call (api.sign span) of the traced stretch: mu hashing,
the bytes rows and the call's own Python."""

from benchmark import program_trace


def read(out):
    return program_trace.api_host_ms_per_call(program_trace.totals(), "api.sign")
