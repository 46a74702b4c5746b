"""PyTorch port: key / signature codecs and rounding vs the JAX package at
levels 2/3/5, byte-equal."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dilithium_tpu.ops import pack as jpack
from dilithium_tpu.ops import rounding as jrounding
from dilithium_tpu_torch import params
from dilithium_tpu_torch.ops import pack, reduce, rounding

Q = params.Q
LEVELS = [2, 3, 5]


def _rng(tag: int) -> np.random.Generator:
    return np.random.default_rng(1000 + tag)


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy -> torch, uint32 carried as int32 (values below 2^31)."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got: torch.Tensor, exp) -> None:
    np.testing.assert_array_equal(got.numpy().astype(np.int64), np.asarray(exp).astype(np.int64))


def _hints(rng, p, batch):
    """0/1 [batch, K, 256] with total weight <= omega per row."""
    h = np.zeros((batch, p.K * 256), dtype=np.uint32)
    for r in range(batch):
        k = rng.integers(0, p.omega + 1)
        h[r, rng.choice(p.K * 256, size=k, replace=False)] = 1
    return h.reshape(batch, p.K, 256)


@pytest.mark.parametrize("level", LEVELS)
def test_codecs_match_jax(level):
    p = params.get_params(level)
    rng = _rng(40 + level)
    B = 3
    eta = rng.integers(-p.eta, p.eta + 1, size=(B, p.L, 256)).astype(np.int32)
    s_canon = (eta % Q).astype(np.uint32)
    _eq(pack.pack_eta(_t(s_canon), p), jpack.pack_eta(jnp.asarray(s_canon), p))
    t1 = rng.integers(0, 1024, size=(B, p.K, 256)).astype(np.uint32)
    _eq(pack.pack_t1(_t(t1)), jpack.pack_t1(jnp.asarray(t1)))
    t0 = rng.integers(-(1 << 12) + 1, (1 << 12) + 1, size=(B, p.K, 256)).astype(np.int32)
    _eq(pack.pack_t0(_t(t0)), jpack.pack_t0(jnp.asarray(t0)))
    z = (rng.integers(-p.gamma1 + 1, p.gamma1 + 1, size=(B, p.L, 256)) % Q).astype(np.uint32)
    _eq(pack.pack_z(_t(z), p), jpack.pack_z(jnp.asarray(z), p))
    w1 = rng.integers(0, 1 << p.w1_bits, size=(B, p.K, 256)).astype(np.uint32)
    w1 = np.minimum(w1, 43) if p.w1_bits == 6 else w1
    _eq(pack.pack_w1(_t(w1), p), jpack.pack_w1(jnp.asarray(w1), p))
    h = _hints(rng, p, B)
    _eq(pack.pack_hints(_t(h), p), jpack.pack_hints(jnp.asarray(h), p))


@pytest.mark.parametrize("level", LEVELS)
def test_key_and_sig_containers_match_jax(level):
    p = params.get_params(level)
    rng = _rng(50 + level)
    B = 2
    rho, key, tr, c_tilde = (rng.integers(0, 256, size=(B, 32), dtype=np.uint8) for _ in range(4))
    s1 = (rng.integers(-p.eta, p.eta + 1, size=(B, p.L, 256)) % Q).astype(np.uint32)
    s2 = (rng.integers(-p.eta, p.eta + 1, size=(B, p.K, 256)) % Q).astype(np.uint32)
    t0 = rng.integers(-(1 << 12) + 1, (1 << 12) + 1, size=(B, p.K, 256)).astype(np.int32)
    t1 = rng.integers(0, 1024, size=(B, p.K, 256)).astype(np.uint32)

    pk = pack.pack_pk(_t(rho), _t(t1), p)
    _eq(pk, jpack.pack_pk(jnp.asarray(rho), jnp.asarray(t1), p))
    sk = pack.pack_sk(*map(_t, (rho, key, tr, s1, s2, t0)), p)
    sk_j = jpack.pack_sk(*map(jnp.asarray, (rho, key, tr, s1, s2, t0)), p)
    _eq(sk, sk_j)
    for got, exp in zip(pack.unpack_sk(sk, p), jpack.unpack_sk(sk_j, p)):
        _eq(got, exp)

    z = (rng.integers(-p.gamma1 + 1, p.gamma1 + 1, size=(B, p.L, 256)) % Q).astype(np.uint32)
    h = _hints(rng, p, B)
    sig = pack.pack_sig(_t(c_tilde), _t(z), _t(h).to(torch.uint8), p)
    assert sig.shape == (B, p.sig_bytes)
    _eq(sig, jpack.pack_sig(jnp.asarray(c_tilde), jnp.asarray(z), jnp.asarray(h), p))


@pytest.mark.parametrize("level", LEVELS)
def test_rounding_matches_jax(level):
    p = params.get_params(level)
    rng = _rng(60 + level)
    a = rng.integers(0, Q, size=(8, 256), dtype=np.int64).astype(np.uint32)
    a[0, :4] = [0, Q - 1, (Q - 1) // 2, p.gamma2]
    for got, exp in zip(rounding.power2round(_t(a)), jrounding.power2round(jnp.asarray(a))):
        _eq(got, exp)
    w1, w0 = rounding.decompose(_t(a), p)
    w1_j, w0_j = jrounding.decompose(jnp.asarray(a), p)
    _eq(w1, w1_j)
    _eq(w0, w0_j)
    a0 = rng.integers(-2 * p.gamma2, 2 * p.gamma2, size=(8, 256)).astype(np.int32)
    a0[0, :3] = [-p.gamma2, p.gamma2, -p.gamma2 - 1]
    _eq(rounding.make_hint(_t(a0), w1, p), jrounding.make_hint(jnp.asarray(a0), w1_j, p))
    bound = p.gamma2 - p.beta
    cent = rng.integers(-bound - 3, bound + 3, size=(8, 2, 256)).astype(np.int32)
    _eq(rounding.norm_exceeds(_t(cent), bound), jrounding.norm_exceeds(jnp.asarray(cent), bound))
    _eq(rounding.norm_exceeds(_t(cent), bound, dim=(-2, -1)),
        jrounding.norm_exceeds(jnp.asarray(cent), bound, axis=(-2, -1)))
    canon = (cent % Q).astype(np.uint32)  # the JAX function centers uint32 itself
    _eq(rounding.norm_exceeds(reduce.center(_t(canon)), bound, dim=(-2, -1)),
        jrounding.norm_exceeds(jnp.asarray(canon), bound, axis=(-2, -1)))
