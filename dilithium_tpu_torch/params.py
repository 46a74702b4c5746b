"""Per-level Dilithium parameter sets, shared with the JAX package.

`dilithium_tpu.params` is plain dataclasses (no JAX import), and
`dilithium_tpu/__init__.py` imports nothing else, so both packages read
one definition of every constant.
"""

from dilithium_tpu.params import (  # noqa: F401
    CRHBYTES, D, LEVELS, MONT_R, MONT_R2, N, POLYT0_PACKEDBYTES,
    POLYT1_PACKEDBYTES, Q, QINV, SEEDBYTES, SHAKE128_RATE, SHAKE256_RATE,
    TRBYTES, DilithiumParams, get_params,
)
