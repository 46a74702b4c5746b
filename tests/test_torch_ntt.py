"""PyTorch port: NTT, inverse NTT and matvec vs the JAX package's roll form,
its Pallas kernel (interpret mode on the CPU) and the C++ oracle."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from dilithium_tpu import oracle
from dilithium_tpu.ops import ntt as jntt
from dilithium_tpu.ops import ntt_pallas
from dilithium_tpu_torch import params
from dilithium_tpu_torch.ops import ntt

Q = params.Q


def _rand(seed, shape):
    return np.random.default_rng(seed).integers(0, Q, size=shape + (256,), dtype=np.int64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(a.astype(np.int32))


def _eq(got, exp):
    np.testing.assert_array_equal(got.numpy().astype(np.int64), np.asarray(exp).astype(np.int64))


@pytest.mark.parametrize("shape", [(1,), (6,), (3, 5)])
def test_forward_matches_jax(shape):
    x = _rand(1, shape)
    got = ntt.ntt(_t(x))
    assert got.shape == x.shape and got.dtype == torch.int32
    _eq(got, jntt.ntt(jnp.asarray(x)))


@pytest.mark.parametrize("from_product", [True, False])
def test_inverse_matches_jax(from_product):
    x = _rand(2, (6,))
    _eq(ntt.invntt(_t(x), from_product=from_product), jntt.invntt(jnp.asarray(x), from_product=from_product))


def test_matches_pallas_kernel_interpreted():
    # ~30 s per interpreted call on the CPU: forward, and the inverse with
    # the scale keygen uses (the two scalings differ in one constant)
    x = _rand(3, (4,))
    with pltpu.force_tpu_interpret_mode():
        fwd = ntt_pallas.ntt(jnp.asarray(x))
        inv = ntt_pallas.invntt(jnp.asarray(x), from_product=True)
    _eq(ntt.ntt(_t(x)), fwd)
    _eq(ntt.invntt(_t(x), from_product=True), inv)


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
    _eq(ntt.matvec(_t(a_hat), _t(s_hat)), jntt.matvec(jnp.asarray(a_hat), jnp.asarray(s_hat)))


def test_roundtrip_and_plain_forms():
    x = _rand(6, (7,))
    _eq(ntt.invntt(ntt.ntt(_t(x)), from_product=False), x)
    _eq(ntt.ntt_plain(_t(x)), ntt.ntt(_t(x)))
    _eq(ntt.invntt_plain(_t(x), from_product=True), ntt.invntt(_t(x)))
