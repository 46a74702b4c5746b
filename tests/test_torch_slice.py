"""PyTorch port, the one-key signing slice as a whole: keygen ->
build_operators -> sign_stream_mxu, byte-equal to the JAX package and to
the C++ oracle."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dilithium_tpu import mxu as jmxu
from dilithium_tpu import oracle
from dilithium_tpu import scheme as jscheme
from dilithium_tpu_torch import convert, mxu, params, scheme

RNG_SEED = 77


@pytest.fixture(scope="module")
def level2():
    """The shapes tests/test_mxu.py compiles: level 2, 10 mu, window 4."""
    p = params.get_params(2)
    rng = np.random.default_rng(RNG_SEED)
    seed = rng.integers(0, 256, size=32, dtype=np.uint8)
    mus = rng.integers(0, 256, size=(10, 64), dtype=np.uint8)
    kp_j = jscheme.keygen(jnp.asarray(seed), p)
    ops_j = jmxu.build_operators(kp_j.sk, p)
    res_j = jmxu.sign_stream_mxu(ops_j, jnp.asarray(mus), p, window=4, max_rounds=512)
    jax_np = {
        "kp": [np.asarray(x) for x in kp_j],
        "ops": [np.asarray(x) for x in ops_j],
        "res": [np.asarray(x) for x in res_j],
    }
    return p, seed, mus, jax_np


def _eq(got: torch.Tensor, exp: np.ndarray, what: str):
    np.testing.assert_array_equal(got.numpy().astype(np.int64), np.asarray(exp).astype(np.int64), err_msg=what)


def test_keygen_matches_jax(level2):
    p, seed, _, j = level2
    kp = scheme.keygen(torch.from_numpy(seed), p)
    for name, got, exp in zip(scheme.KeyPair._fields, kp, j["kp"]):
        _eq(got, exp, name)


def test_build_operators_matches_jax(level2):
    p, seed, _, j = level2
    ops = mxu.build_operators(scheme.keygen(torch.from_numpy(seed), p).sk, p)
    for name, got, exp in zip(mxu.KeyOperators._fields, ops, j["ops"]):
        _eq(got, exp, name)
    assert ops.wy_cat.t().is_contiguous() and ops.c_cat.t().is_contiguous()


def test_sign_stream_matches_jax(level2):
    p, seed, mus, j = level2
    ops = mxu.build_operators(scheme.keygen(torch.from_numpy(seed), p).sk, p)
    res = mxu.sign_stream_mxu(ops, torch.from_numpy(mus), p, window=4, max_rounds=512)
    assert bool(res.ok.all())
    for name, got, exp in zip(("sig", "attempts", "ok"), res[:3], j["res"]):
        _eq(got, exp, name)


def test_converted_state_signs_like_jax(level2):
    """JAX's keys and operators, carried over as numpy, drive the port."""
    p, _, mus, j = level2
    kp = convert.keypair_from_numpy(*j["kp"], device="cpu")
    _eq(kp.sk, j["kp"][1], "sk")
    assert kp.s1.dtype == torch.int32 and kp.ok.dtype == torch.bool
    ops = convert.key_operators_from_numpy(*j["ops"], device="cpu")
    signer = mxu.MxuSigner(ops, p, window=4, max_rounds=512)
    res = signer(torch.from_numpy(mus))
    for name, got, exp in zip(("sig", "attempts", "ok"), res[:3], j["res"]):
        _eq(got, exp, name)


@pytest.mark.parametrize("level,window", [(2, 4), (3, 3), (5, 4), (2, 7)])
def test_slice_matches_oracle(level, window):
    """Keygen and stream signing (steady rounds, then the elastic drain)
    against the C++ oracle: keys, signature bytes and attempts. At W = Q
    (7 messages) no queue item is left to refill a slot, so from the first
    signature on every round is a drain, in which idle slots try the
    unsigned items' next kappas, up to W attempts an item a round."""
    p = params.get_params(level)
    rng = np.random.default_rng(RNG_SEED + level)
    seed = rng.integers(0, 256, size=(1, 32), dtype=np.uint8)
    mus = rng.integers(0, 256, size=(7, 64), dtype=np.uint8)
    kp = scheme.keygen(torch.from_numpy(seed[0]), p)
    pk_o, sk_o = oracle.keygen(level, seed)
    _eq(kp.pk, pk_o[0], "pk")
    _eq(kp.sk, sk_o[0], "sk")
    assert bool(kp.ok)
    res = mxu.sign_stream_mxu(mxu.build_operators(kp.sk, p), torch.from_numpy(mus), p,
                              window=window, max_rounds=512)
    sig_o, att_o = oracle.sign(level, np.repeat(sk_o, len(mus), axis=0), mus)
    assert bool(res.ok.all())
    _eq(res.sig, sig_o, "sig")
    _eq(res.attempts, att_o, "attempts")
    assert oracle.verify(level, np.repeat(pk_o, len(mus), axis=0), mus, res.sig.numpy()).all()


def test_rhoprime_rules_and_round_limit():
    p = params.get_params(2)
    rng = np.random.default_rng(RNG_SEED + 9)
    kp = scheme.keygen(torch.from_numpy(rng.integers(0, 256, size=32, dtype=np.uint8)), p)
    ops = mxu.build_operators(kp.sk, p)
    mus = torch.from_numpy(rng.integers(0, 256, size=(5, 64), dtype=np.uint8))
    with pytest.raises(ValueError, match="per-message"):
        mxu.sign_stream_mxu(ops, mus, p, rhoprime=torch.zeros((1, 64), dtype=torch.uint8))
    with pytest.raises(ValueError, match="uint8"):
        mxu.sign_stream_mxu(ops, mus, p, rhoprime=torch.zeros((5, 64), dtype=torch.int32))
    # the deterministic rhoprime passed explicitly signs identically
    from dilithium_tpu_torch.ops import keccak
    rp = keccak.shake256(torch.cat([ops.key.expand(5, 32), mus], dim=-1), 64)
    a = mxu.sign_stream_mxu(ops, mus, p, window=4)
    b = mxu.sign_stream_mxu(ops, mus, p, window=4, rhoprime=rp)
    assert torch.equal(a.sig, b.sig) and torch.equal(a.attempts, b.attempts)
    # one round signs the first window's items that accept at their first
    # attempt; the rest are not ok (zero c_tilde, as in the JAX package)
    cut = mxu.sign_stream_mxu(ops, mus, p, window=4, max_rounds=1)
    assert cut.rounds == 1
    assert torch.equal(cut.ok, cut.attempts > 0)
    assert torch.equal(cut.ok, (a.attempts == 1) & (torch.arange(5) < 4))
    assert not bool(cut.sig[~cut.ok, :32].any())
    assert torch.equal(cut.sig[cut.ok], a.sig[cut.ok])
