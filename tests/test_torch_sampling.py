"""PyTorch port: ExpandA and ExpandS vs the JAX package, values and ok
flags byte-equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dilithium_tpu.ops import sampling as jsampling
from dilithium_tpu_torch import params
from dilithium_tpu_torch.ops import sampling

LEVELS = [2, 3, 5]


def _u8(rng, shape):
    return rng.integers(0, 256, size=shape, dtype=np.uint8)


def _eq(got, exp):
    np.testing.assert_array_equal(got.numpy().astype(np.int64), np.asarray(exp).astype(np.int64))


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("max_skips", [8, 12])
def test_expand_a_matches_jax(level, max_skips):
    p = params.get_params(level)
    rho = _u8(np.random.default_rng(level), (2, 32))
    a, ok = sampling.expand_a(torch.from_numpy(rho), p, max_skips=max_skips)
    a_j, ok_j = jsampling.expand_a(jnp.asarray(rho), p, max_skips=max_skips)
    _eq(a, a_j)
    _eq(ok, ok_j)
    assert a.shape == (2, p.K, p.L, 256) and bool(ok.all())


@pytest.mark.parametrize("level", LEVELS)
def test_expand_s_matches_jax(level):
    p = params.get_params(level)
    sigma = _u8(np.random.default_rng(10 + level), (2, 64))
    s, ok = sampling.expand_s(torch.from_numpy(sigma), 0, p.L + p.K, p)
    s_j, ok_j = jsampling.expand_s(jnp.asarray(sigma), 0, p.L + p.K, p)
    _eq(s, s_j)
    _eq(ok, ok_j)
