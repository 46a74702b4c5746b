"""PyTorch port: mod-q helpers and the int8 limb packing of the operators
vs the JAX package.

Exact integer arithmetic throughout: every comparison is byte-equal, no
tolerance. Inputs come from numpy seeds and go through both packages.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dilithium_tpu import mxu as jmxu
from dilithium_tpu.ops import reduce as jreduce
from dilithium_tpu_torch import mxu, params
from dilithium_tpu_torch.ops import reduce

Q = params.Q


def _rng(tag: int) -> np.random.Generator:
    return np.random.default_rng(1000 + tag)


def _canon(rng, shape) -> np.ndarray:
    return rng.integers(0, Q, size=shape, dtype=np.int64).astype(np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy -> torch, uint32 carried as int32 (values below 2^31)."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got: torch.Tensor, exp) -> None:
    np.testing.assert_array_equal(got.numpy().astype(np.int64), np.asarray(exp).astype(np.int64))


@pytest.mark.parametrize("name", ["center", "csubq", "add_mod", "sub_mod", "mont_mul", "uncenter"])
def test_reduce_helpers_match_jax(name):
    rng = _rng(1)
    a, b = _canon(rng, (4096,)), _canon(rng, (4096,))
    if name == "center":
        _eq(reduce.center(_t(a)), jreduce.center(jnp.asarray(a)))
    elif name == "csubq":
        x = rng.integers(0, 2 * Q, size=4096).astype(np.uint32)
        _eq(reduce.csubq(_t(x)), jreduce.csubq(jnp.asarray(x)))
    elif name == "uncenter":
        x = rng.integers(-Q + 1, Q, size=4096).astype(np.int32)
        _eq(reduce.uncenter(_t(x)), jreduce.uncenter(jnp.asarray(x)))
    else:
        fn_t, fn_j = getattr(reduce, name), getattr(jreduce, name)
        _eq(fn_t(_t(a), _t(b)), fn_j(jnp.asarray(a), jnp.asarray(b)))


def test_mod_q_i32_exact():
    x = _rng(2).integers(-1_200_000_000, 1_200_000_000, size=(1 << 16,), dtype=np.int64).astype(np.int32)
    got = mxu._mod_q_i32(_t(x))
    _eq(got, jmxu._mod_q_i32(jnp.asarray(x)))
    _eq(got, x.astype(np.int64) % Q)


def test_limb_split_and_recombine_match_jax():
    rng = _rng(3)
    x = rng.integers(-(Q // 2), Q // 2 + 1, size=(4096,), dtype=np.int64).astype(np.int32)
    for d_t, d_j in zip(mxu._to_limbs_i8(_t(x)), jmxu._to_limbs_i8(jnp.asarray(x))):
        assert d_t.dtype == torch.int8
        _eq(d_t, d_j)
    prods = [rng.integers(-21_000_000, 21_000_000, size=(8, 64), dtype=np.int64).astype(np.int32)
             for _ in range(5)]
    got = mxu._recombine(*map(_t, prods))
    _eq(got, jmxu._recombine(*map(jnp.asarray, prods)))
    exact = sum(p.astype(object) * (1 << (8 * k)) for k, p in enumerate(prods)) % Q
    _eq(got, exact.astype(np.int64))


def test_conv_matrix_matches_jax():
    s = _rng(4).integers(-(Q // 2), Q // 2, size=(2, 256)).astype(np.int32)
    _eq(mxu._conv_matrix(_t(s)), jmxu._conv_matrix(jnp.asarray(s)))
