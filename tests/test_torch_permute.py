"""PyTorch port: the bare Keccak-f[1600] (kernel K5's plain version) vs the
JAX package's permutation, byte-equal.

JAX's `keccak.keccak_f1600` takes uint32 [..., 25, 2] (low and high half
of each lane); `keccak._f1600_soa` is the body that the Pallas kernel
`keccak_pallas.f1600_folded` runs on lane-half planes. The port takes
int64 lanes [B, 25], or planes [25, B]. The JAX package's outputs are
recorded in `tests/jax_reference.py`.
"""

import numpy as np
import pytest
import torch

from dilithium_tpu_torch.ops import keccak
from jax_reference import assert_matches_jax, jax_ref

BATCHES = [1, 130, 1000]


def _states(b: int, seed: int) -> np.ndarray:
    """uint32 [b, 25, 2] random states."""
    return np.random.default_rng(seed).integers(0, 1 << 32, (b, 25, 2), dtype=np.uint64).astype(np.uint32)


def _to_lanes(halves: np.ndarray) -> torch.Tensor:
    """uint32 [b, 25, 2] -> int64 lanes [b, 25]."""
    return torch.from_numpy(np.array(halves, copy=True).view(np.int64)[..., 0])


@pytest.mark.parametrize("b", BATCHES)
def test_matches_jax_permutation_and_soa_body(b):
    st = _states(b, 100 + b)
    got = keccak.keccak_f1600(_to_lanes(st))
    halves = got.numpy().view(np.uint32).reshape(b, 25, 2)  # JAX's form, little-endian halves
    ref = jax_ref("permute_f1600")
    assert_matches_jax(halves, ref[f"f1600 {b}"], "keccak_f1600")
    assert_matches_jax(halves, ref[f"soa {b}"], "_f1600_soa")


def test_plane_form_equals_batch_form_and_rejects_bad_shapes():
    lanes = _to_lanes(_states(77, 7))
    out = keccak.keccak_f1600(lanes)
    planes_out = keccak.keccak_f1600_planes(lanes.t().contiguous())
    assert planes_out.shape == (25, 77)
    assert torch.equal(planes_out.t(), out)
    assert torch.equal(keccak.keccak_f1600(out), keccak.keccak_f1600_plain(out))
    with pytest.raises(ValueError):
        keccak.keccak_f1600(lanes.t().contiguous())
    with pytest.raises(ValueError):
        keccak.keccak_f1600_planes(lanes.to(torch.int32))
