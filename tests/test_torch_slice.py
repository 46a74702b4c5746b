"""PyTorch port, the one-key signing slice as a whole: keygen ->
build_operators -> sign_stream_mxu, byte-equal to the JAX package (its
outputs recorded in `tests/jax_reference.py`) and to the C++ oracle."""

import numpy as np
import pytest
import torch

from dilithium_tpu import oracle
from dilithium_tpu_torch import convert, mxu, params, scheme
from jax_reference import assert_matches_jax, jax_ref

RNG_SEED = 77


def _level2_inputs():
    """The shapes tests/test_mxu.py compiles: level 2, 10 mu (window 4).
    -> (seed uint8 [32], mus uint8 [10, 64])."""
    rng = np.random.default_rng(RNG_SEED)
    seed = rng.integers(0, 256, size=32, dtype=np.uint8)
    return seed, rng.integers(0, 256, size=(10, 64), dtype=np.uint8)


@pytest.fixture(scope="module")
def level2():
    return (params.get_params(2), *_level2_inputs(), jax_ref("slice_level2"))


def _eq(got: torch.Tensor, exp: np.ndarray, what: str):
    np.testing.assert_array_equal(got.numpy().astype(np.int64), np.asarray(exp).astype(np.int64), err_msg=what)


def _match(fields, got, j, prefix):
    for name, g in zip(fields, got):
        assert_matches_jax(g, j[f"{prefix}.{name}"], name)


def test_keygen_matches_jax(level2):
    p, seed, _, j = level2
    _match(scheme.KeyPair._fields, scheme.keygen(torch.from_numpy(seed), p), j, "kp")


def test_build_operators_matches_jax(level2):
    p, seed, _, j = level2
    ops = mxu.build_operators(scheme.keygen(torch.from_numpy(seed), p).sk, p)
    _match(mxu.KeyOperators._fields, ops, j, "ops")
    assert ops.wy_cat.t().is_contiguous() and ops.c_cat.t().is_contiguous()


def test_sign_stream_matches_jax(level2):
    p, seed, mus, j = level2
    ops = mxu.build_operators(scheme.keygen(torch.from_numpy(seed), p).sk, p)
    res = mxu.sign_stream_mxu(ops, torch.from_numpy(mus), p, window=4, max_rounds=512)
    assert bool(res.ok.all())
    _match(("sig", "attempts", "ok"), res[:3], j, "res")


def test_converted_state_signs_like_jax(level2):
    """JAX's keys and operators, carried over as numpy, drive the port:
    the port's own, once they are matched with JAX's bytes."""
    p, seed, mus, j = level2
    kp_t = scheme.keygen(torch.from_numpy(seed), p)
    ops_t = mxu.build_operators(kp_t.sk, p)
    _match(scheme.KeyPair._fields, kp_t, j, "kp")
    _match(mxu.KeyOperators._fields, ops_t, j, "ops")
    kp = convert.keypair_from_numpy(*(x.numpy() for x in kp_t), device="cpu")
    assert_matches_jax(kp.sk, j["kp.sk"], "sk")
    assert kp.s1.dtype == torch.int32 and kp.ok.dtype == torch.bool
    ops = convert.key_operators_from_numpy(*(x.numpy() for x in ops_t), device="cpu")
    signer = mxu.MxuSigner(ops, p, window=4, max_rounds=512)
    res = signer(torch.from_numpy(mus))
    _match(("sig", "attempts", "ok"), res[:3], j, "res")


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
