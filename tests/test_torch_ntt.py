"""PyTorch port: NTT, inverse NTT and matvec vs the JAX package's roll form,
its Pallas kernel (interpret mode on the CPU; recorded in
`tests/jax_reference.py`) and the C++ oracle."""

import numpy as np
import pytest
import torch

from dilithium_tpu import oracle
from dilithium_tpu_torch import params
from dilithium_tpu_torch.ops import ntt
from jax_reference import assert_matches_jax, jax_ref

Q = params.Q
SHAPES = [(1,), (6,), (3, 5)]


def _rand(seed, shape):
    return np.random.default_rng(seed).integers(0, Q, size=shape + (256,), dtype=np.int64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(a.astype(np.int32))


def _eq(got, exp):
    np.testing.assert_array_equal(got.numpy().astype(np.int64), np.asarray(exp).astype(np.int64))


@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_jax(shape):
    x = _rand(1, shape)
    got = ntt.ntt(_t(x))
    assert got.shape == x.shape and got.dtype == torch.int32
    assert_matches_jax(got, jax_ref("ntt_forward")[str(shape)], f"ntt {shape}")


@pytest.mark.parametrize("from_product", [True, False])
def test_inverse_matches_jax(from_product):
    x = _rand(2, (6,))
    assert_matches_jax(ntt.invntt(_t(x), from_product=from_product), jax_ref("ntt_inverse")[str(from_product)],
                       f"invntt from_product={from_product}")


def test_matches_pallas_kernel_interpreted():
    # forward, and the inverse with the scale keygen uses (the two scalings
    # differ in one constant)
    x = _rand(3, (4,))
    ref = jax_ref("ntt_pallas_interpreted")
    assert_matches_jax(ntt.ntt(_t(x)), ref["ntt"], "ntt")
    assert_matches_jax(ntt.invntt(_t(x), from_product=True), ref["invntt"], "invntt")


def test_matches_oracle():
    x = _rand(4, (5,))
    _eq(ntt.ntt(_t(x)), oracle.ntt(x.astype(np.int32)))
    _eq(ntt.invntt(_t(x), from_product=False), oracle.invntt(x.astype(np.int32)))
    y = _rand(5, (5,))
    _eq(ntt.pointwise(_t(x), _t(y)), oracle.pointwise(x.astype(np.int32), y.astype(np.int32)))


@pytest.mark.parametrize("level", [2, 3, 5])
def test_matvec_matches_jax(level):
    p = params.get_params(level)
    a_hat = _rand(10 + level, (2, p.K, p.L))
    s_hat = _rand(20 + level, (2, p.L))
    assert_matches_jax(ntt.matvec(_t(a_hat), _t(s_hat)), jax_ref("ntt_matvec")[str(level)], f"level {level}")


def test_roundtrip_and_plain_forms():
    x = _rand(6, (7,))
    _eq(ntt.invntt(ntt.ntt(_t(x)), from_product=False), x)
    _eq(ntt.ntt_plain(_t(x)), ntt.ntt(_t(x)))
    _eq(ntt.invntt_plain(_t(x), from_product=True), ntt.invntt(_t(x)))
