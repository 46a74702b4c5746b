"""PyTorch port: the bit packers under every codec vs the JAX package,
byte-equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dilithium_tpu.ops import pack as jpack
from dilithium_tpu_torch.ops import pack


def _eq(got: torch.Tensor, exp) -> None:
    np.testing.assert_array_equal(got.numpy().astype(np.int64), np.asarray(exp).astype(np.int64))


@pytest.mark.parametrize("bits", [3, 4, 6, 10, 13, 18, 20])
def test_pack_bits_matches_jax(bits):
    rng = np.random.default_rng(1005 + bits)
    vals = rng.integers(0, 1 << bits, size=(3, 256)).astype(np.uint32)
    packed = pack.pack_bits(torch.from_numpy(vals.astype(np.int32)), bits)
    _eq(packed, jpack.pack_bits(jnp.asarray(vals), bits))
    _eq(pack.unpack_bits(packed, bits), vals)


@pytest.mark.parametrize("bits", [4, 18, 20, 24])
def test_unpack_bits_w_matches_jax(bits):
    words = np.random.default_rng(1030 + bits).integers(0, 1 << 32, size=(3, 90), dtype=np.int64)  # 90 = 2*3^2*5 words
    got = pack.unpack_bits_w(torch.from_numpy(words), bits)
    _eq(got, jpack.unpack_bits_w(jnp.asarray(words.astype(np.uint32)), bits))
