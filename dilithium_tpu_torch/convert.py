"""Carry state from the JAX package into the port.

Hand the JAX-side arrays over as numpy (`np.asarray(x)`); these build the
port's containers from them, on the card unless `device` says otherwise
(pass device="cpu" for the plain path). uint32 coefficient arrays become
int32 tensors (every value is below 2^23), bytes stay uint8.
"""

from __future__ import annotations

import numpy as np
import torch

from dilithium_tpu_torch.mxu import KeyOperators, VerifyOperators, gemm_layout
from dilithium_tpu_torch.scheme import ExpandedKey, ExpandedPk, KeyPair


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)


def keypair_from_numpy(pk, sk, rho, key, tr, s1, s2, t0, t1, ok, device="cuda") -> KeyPair:
    """The fields of a JAX `scheme.KeyPair`, as numpy, -> `KeyPair`."""
    u8 = [_tensor(a, np.uint8, device) for a in (pk, sk, rho, key, tr)]
    i32 = [_tensor(a, np.int32, device) for a in (s1, s2, t0, t1)]
    return KeyPair(*u8, *i32, _tensor(ok, np.bool_, device))


def key_operators_from_numpy(wy_cat, c_cat, key, tr, device="cuda") -> KeyOperators:
    """The fields of a JAX `mxu.KeyOperators`, as numpy, -> `KeyOperators`
    in the GEMM layout (`mxu.gemm_layout`)."""
    return KeyOperators(
        gemm_layout(_tensor(wy_cat, np.int8, device)),
        gemm_layout(_tensor(c_cat, np.int8, device)),
        _tensor(key, np.uint8, device),
        _tensor(tr, np.uint8, device),
    )


def verify_operators_from_numpy(wz_limbs, t1_limbs, tr, device="cuda") -> VerifyOperators:
    """The fields of a JAX `mxu.VerifyOperators`, as numpy: limbs int8
    [3, rows, K*256] -> `VerifyOperators`, the limbs side by side
    ([rows, 3*K*256]) in the GEMM layout."""
    return VerifyOperators(
        gemm_layout(_tensor(np.concatenate(list(wz_limbs), axis=-1), np.int8, device)),
        gemm_layout(_tensor(np.concatenate(list(t1_limbs), axis=-1), np.int8, device)),
        _tensor(tr, np.uint8, device),
    )


def expanded_pk_from_numpy(a_hat, t1_hat, tr, device="cuda") -> ExpandedPk:
    """The fields of a JAX `scheme.ExpandedPk`, as numpy, -> `ExpandedPk`."""
    return ExpandedPk(_tensor(a_hat, np.int32, device), _tensor(t1_hat, np.int32, device),
                      _tensor(tr, np.uint8, device))


def expanded_key_from_numpy(a_hat, s1_hat, s2_hat, t0_hat, key, tr, device="cuda") -> ExpandedKey:
    """The fields of a JAX `scheme.ExpandedKey`, as numpy, -> `ExpandedKey`."""
    return ExpandedKey(*(_tensor(a, np.int32, device) for a in (a_hat, s1_hat, s2_hat, t0_hat)),
                       _tensor(key, np.uint8, device), _tensor(tr, np.uint8, device))
