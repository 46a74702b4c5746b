"""Carry state from the JAX package into the port.

Hand the JAX-side arrays over as numpy (`np.asarray(x)`); these build the
port's containers from them. uint32 coefficient arrays become int32
tensors (every value is below 2^23), bytes stay uint8.
"""

from __future__ import annotations

import numpy as np
import torch

from dilithium_tpu_torch.mxu import KeyOperators, gemm_layout
from dilithium_tpu_torch.scheme import KeyPair


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)


def keypair_from_numpy(pk, sk, rho, key, tr, s1, s2, t0, t1, ok, device=None) -> KeyPair:
    """The fields of a JAX `scheme.KeyPair`, as numpy, -> `KeyPair`."""
    u8 = [_tensor(a, np.uint8, device) for a in (pk, sk, rho, key, tr)]
    i32 = [_tensor(a, np.int32, device) for a in (s1, s2, t0, t1)]
    return KeyPair(*u8, *i32, _tensor(ok, np.bool_, device))


def key_operators_from_numpy(wy_cat, c_cat, key, tr, device=None) -> KeyOperators:
    """The fields of a JAX `mxu.KeyOperators`, as numpy, -> `KeyOperators`
    in the GEMM layout (`mxu.gemm_layout`)."""
    return KeyOperators(
        gemm_layout(_tensor(wy_cat, np.int8, device)),
        gemm_layout(_tensor(c_cat, np.int8, device)),
        _tensor(key, np.uint8, device),
        _tensor(tr, np.uint8, device),
    )
