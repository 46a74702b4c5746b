"""scheme.glue_us_per_sig: as mxu.glue_us_per_sig, over the traced calls
of the keyed stream signer (`scheme.sign_stream_keys`): the NTT-form
attempt's PyTorch glue (its int64 matvec and rounding), the slots' key
gathers and the loop's bookkeeping, per signature."""

from benchmark.tracing import glue_us_per_answer


def read(out):
    return glue_us_per_answer(out.trace)
