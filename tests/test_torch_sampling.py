"""PyTorch port: ExpandA and ExpandS vs the JAX package (its outputs
recorded in `tests/jax_reference.py`), values and ok flags byte-equal."""

import numpy as np
import pytest
import torch

from dilithium_tpu_torch import params
from dilithium_tpu_torch.ops import sampling
from jax_reference import assert_matches_jax, jax_ref

LEVELS = [2, 3, 5]


def _u8(rng, shape):
    return rng.integers(0, 256, size=shape, dtype=np.uint8)


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("max_skips", [8, 12])
def test_expand_a_matches_jax(level, max_skips):
    p = params.get_params(level)
    rho = _u8(np.random.default_rng(level), (2, 32))
    a, ok = sampling.expand_a(torch.from_numpy(rho), p, max_skips=max_skips)
    ref = jax_ref("sampling_expand_a")
    assert_matches_jax(a, ref[f"a {level} {max_skips}"], "a")
    assert_matches_jax(ok, ref[f"ok {level} {max_skips}"], "ok")
    assert a.shape == (2, p.K, p.L, 256) and bool(ok.all())


@pytest.mark.parametrize("level", LEVELS)
def test_expand_s_matches_jax(level):
    p = params.get_params(level)
    sigma = _u8(np.random.default_rng(10 + level), (2, 64))
    s, ok = sampling.expand_s(torch.from_numpy(sigma), 0, p.L + p.K, p)
    ref = jax_ref("sampling_expand_s")
    assert_matches_jax(s, ref[f"s {level}"], "s")
    assert_matches_jax(ok, ref[f"ok {level}"], "ok")
