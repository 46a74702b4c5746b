"""PyTorch port: key / signature codecs and rounding vs the JAX package at
levels 2/3/5 (its outputs recorded in `tests/jax_reference.py`),
byte-equal."""

import numpy as np
import pytest
import torch

from dilithium_tpu_torch import params
from dilithium_tpu_torch.ops import pack, reduce, rounding
from jax_reference import assert_matches_jax, jax_ref

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


def _hints(rng, p, batch):
    """0/1 [batch, K, 256] with total weight <= omega per row."""
    h = np.zeros((batch, p.K * 256), dtype=np.uint32)
    for r in range(batch):
        k = rng.integers(0, p.omega + 1)
        h[r, rng.choice(p.K * 256, size=k, replace=False)] = 1
    return h.reshape(batch, p.K, 256)


def _codec_inputs(level):
    """Random coefficient vectors in every codec's range, B = 3."""
    p = params.get_params(level)
    rng = _rng(40 + level)
    B = 3
    eta = rng.integers(-p.eta, p.eta + 1, size=(B, p.L, 256)).astype(np.int32)
    x = {"s_canon": (eta % Q).astype(np.uint32)}
    x["t1"] = rng.integers(0, 1024, size=(B, p.K, 256)).astype(np.uint32)
    x["t0"] = rng.integers(-(1 << 12) + 1, (1 << 12) + 1, size=(B, p.K, 256)).astype(np.int32)
    x["z"] = (rng.integers(-p.gamma1 + 1, p.gamma1 + 1, size=(B, p.L, 256)) % Q).astype(np.uint32)
    w1 = rng.integers(0, 1 << p.w1_bits, size=(B, p.K, 256)).astype(np.uint32)
    x["w1"] = np.minimum(w1, 43) if p.w1_bits == 6 else w1
    x["h"] = _hints(rng, p, B)
    return x


@pytest.mark.parametrize("level", LEVELS)
def test_codecs_match_jax(level):
    p = params.get_params(level)
    x = {k: _t(v) for k, v in _codec_inputs(level).items()}
    ref = jax_ref("pack_rounding_codecs")
    for name, got in (("eta", pack.pack_eta(x["s_canon"], p)), ("t1", pack.pack_t1(x["t1"])),
                      ("t0", pack.pack_t0(x["t0"])), ("z", pack.pack_z(x["z"], p)),
                      ("w1", pack.pack_w1(x["w1"], p)), ("hints", pack.pack_hints(x["h"], p))):
        assert_matches_jax(got, ref[f"{name} {level}"], name)


def _container_inputs(level):
    """The parts of two keys and two signatures."""
    p = params.get_params(level)
    rng = _rng(50 + level)
    B = 2
    x = dict(zip(("rho", "key", "tr", "c_tilde"), (rng.integers(0, 256, size=(B, 32), dtype=np.uint8)
                                                   for _ in range(4))))
    x["s1"] = (rng.integers(-p.eta, p.eta + 1, size=(B, p.L, 256)) % Q).astype(np.uint32)
    x["s2"] = (rng.integers(-p.eta, p.eta + 1, size=(B, p.K, 256)) % Q).astype(np.uint32)
    x["t0"] = rng.integers(-(1 << 12) + 1, (1 << 12) + 1, size=(B, p.K, 256)).astype(np.int32)
    x["t1"] = rng.integers(0, 1024, size=(B, p.K, 256)).astype(np.uint32)
    x["z"] = (rng.integers(-p.gamma1 + 1, p.gamma1 + 1, size=(B, p.L, 256)) % Q).astype(np.uint32)
    x["h"] = _hints(rng, p, B)
    return x


@pytest.mark.parametrize("level", LEVELS)
def test_key_and_sig_containers_match_jax(level):
    p = params.get_params(level)
    x = {k: _t(v) for k, v in _container_inputs(level).items()}
    ref = jax_ref("pack_rounding_containers")

    pk = pack.pack_pk(x["rho"], x["t1"], p)
    assert_matches_jax(pk, ref[f"pk {level}"], "pk")
    sk = pack.pack_sk(*(x[k] for k in ("rho", "key", "tr", "s1", "s2", "t0")), p)
    assert_matches_jax(sk, ref[f"sk {level}"], "sk")
    for i, got in enumerate(pack.unpack_sk(sk, p)):
        assert_matches_jax(got, ref[f"unpack_sk {level} {i}"], f"unpack_sk part {i}")

    sig = pack.pack_sig(x["c_tilde"], x["z"], x["h"].to(torch.uint8), p)
    assert sig.shape == (2, p.sig_bytes)
    assert_matches_jax(sig, ref[f"sig {level}"], "sig")


def _rounding_case(level):
    """-> (a canonical [8, 256] with the edges, a0 centered [8, 256], cent
    centered [8, 2, 256] around the norm bound, cent canonical)."""
    p = params.get_params(level)
    rng = _rng(60 + level)
    a = rng.integers(0, Q, size=(8, 256), dtype=np.int64).astype(np.uint32)
    a[0, :4] = [0, Q - 1, (Q - 1) // 2, p.gamma2]
    a0 = rng.integers(-2 * p.gamma2, 2 * p.gamma2, size=(8, 256)).astype(np.int32)
    a0[0, :3] = [-p.gamma2, p.gamma2, -p.gamma2 - 1]
    bound = p.gamma2 - p.beta
    cent = rng.integers(-bound - 3, bound + 3, size=(8, 2, 256)).astype(np.int32)
    return a, a0, cent, (cent % Q).astype(np.uint32)  # the JAX function centers uint32 itself


@pytest.mark.parametrize("level", LEVELS)
def test_rounding_matches_jax(level):
    p = params.get_params(level)
    a, a0, cent, canon = _rounding_case(level)
    ref = jax_ref("pack_rounding_rounding")
    for i, got in enumerate(rounding.power2round(_t(a))):
        assert_matches_jax(got, ref[f"power2round {level} {i}"], f"power2round {i}")
    w1, w0 = rounding.decompose(_t(a), p)
    assert_matches_jax(w1, ref[f"decompose {level} 0"], "decompose w1")
    assert_matches_jax(w0, ref[f"decompose {level} 1"], "decompose w0")
    bound = p.gamma2 - p.beta
    assert_matches_jax(rounding.make_hint(_t(a0), w1, p), ref[f"make_hint {level}"], "make_hint")
    assert_matches_jax(rounding.norm_exceeds(_t(cent), bound), ref[f"norm {level}"], "norm_exceeds")
    assert_matches_jax(rounding.norm_exceeds(_t(cent), bound, dim=(-2, -1)), ref[f"norm2 {level}"],
                       "norm_exceeds over (-2, -1)")
    assert_matches_jax(rounding.norm_exceeds(reduce.center(_t(canon)), bound, dim=(-2, -1)),
                       ref[f"norm_canon {level}"], "norm_exceeds of canonical input")
