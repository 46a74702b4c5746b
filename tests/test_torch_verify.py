"""PyTorch port, one-key Verify as a whole: `mxu.build_verify_operators` +
`mxu.verify_mxu` (and `MxuVerifier`), `scheme.expand_pk` +
`scheme.verify_expanded`, and `scheme.verify`, against the JAX package's
dense-operator verifier at level 2 and the C++ oracle at levels 2, 3 and 5,
on valid signatures and on every corruption class of
`tools/verify_cases.py`.

Two tests: the JAX comparison (JAX's outputs recorded in
`tests/jax_reference.py`) and the other levels against the oracle alone."""

import numpy as np
import pytest
import torch

from dilithium_tpu_torch import convert, mxu, oracle, params, scheme
from dilithium_tpu_torch.tools import verify_cases
from jax_reference import assert_matches_jax, jax_ref

RNG_SEED = 616
N_VALID = 8


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tensors here are small, and beside other
    test workers torch's default thread pool spends most of its time
    waiting for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(level: int, seed: int):
    """One oracle key, N_VALID signatures under it and the corrupted rows.
    -> (pk uint8 [pk_bytes], sk uint8 [sk_bytes], sig [R, sig_bytes],
    mu [R, 64], class names)."""
    p = params.get_params(level)
    rng = np.random.default_rng(seed)
    pk, sk = oracle.keygen(level, rng.integers(0, 256, (2, 32), dtype=np.uint8))
    mus = rng.integers(0, 256, (N_VALID + 1, 64), dtype=np.uint8)
    sig, _ = oracle.sign(level, np.stack([sk[0]] * N_VALID + [sk[1]]), mus)
    bad_sig, bad_mu, names = verify_cases.negative_cases(sig[:N_VALID], mus[:N_VALID], sig[-1], mus[-1],
                                                         p, seed=seed)
    return (pk[0], sk[0], np.concatenate([sig[:N_VALID], bad_sig]), np.concatenate([mus[:N_VALID], bad_mu]),
            ["valid"] * N_VALID + names)


def _port_verifiers(pk, sig, mu, p):
    """The port's three verifiers on the CPU -> {name: bool numpy [R]}."""
    pk_t, sig_t, mu_t = (torch.from_numpy(x) for x in (pk, sig, mu))
    verifier = mxu.MxuVerifier(mxu.build_verify_operators(pk_t, p), p)
    return {
        "verify_mxu": verifier(sig_t, mu_t).numpy(),
        "verify_expanded": scheme.verify_expanded(scheme.expand_pk(pk_t, p), sig_t, mu_t, p).numpy(),
        "verify": scheme.verify(pk_t.expand(len(mu), -1), sig_t, mu_t, p).numpy(),
    }


def _check_against_oracle(level, pk, sig, mu, names, got):
    expect = oracle.verify(level, np.repeat(pk[None], len(mu), axis=0), mu, sig)
    assert expect[:N_VALID].all() and not expect[N_VALID:].any(), (level, expect)
    assert set(names[N_VALID:]) == set(verify_cases.CLASSES)
    for name, ok in got.items():
        assert ok.dtype == np.bool_, name
        np.testing.assert_array_equal(ok, expect, err_msg=f"level {level} {name}")


def test_verify_matches_jax_level2():
    """The port's verify operators equal JAX's `build_verify_operators`
    byte for byte (JAX's limb form [3, rows, K*256], carried over by
    `convert`), and its three verifiers give JAX's `verify_mxu` bool vector
    and the oracle's."""
    level = 2
    p = params.get_params(level)
    pk, sk, sig, mu, names = _batch(level, RNG_SEED)
    ref = jax_ref("verify_level2")

    mine = mxu.build_verify_operators(torch.from_numpy(pk), p)
    wz_limbs, t1_limbs = (m.reshape(m.shape[0], 3, -1).permute(1, 0, 2) for m in (mine.wz_cat, mine.t1_cat))
    for name, got in (("wz_limbs", wz_limbs), ("t1_limbs", t1_limbs), ("tr", mine.tr)):
        assert_matches_jax(got, ref[f"vops.{name}"], name)
    ok_j = ref["ok"]
    carried = convert.verify_operators_from_numpy(wz_limbs.numpy(), t1_limbs.numpy(), mine.tr.numpy(),
                                                  device="cpu")
    for field, a, b in zip(mxu.VerifyOperators._fields, mine, carried):
        assert a.dtype == b.dtype and torch.equal(a, b), field
    assert mine.wz_cat.shape == (p.L * 256, 3 * p.K * 256) and mine.t1_cat.shape == (256, 3 * p.K * 256)
    assert mine.wz_cat.t().is_contiguous() and mine.t1_cat.t().is_contiguous()
    # the verifier's z -> Az map is the signer's y -> w map
    assert torch.equal(mxu.build_operators(torch.from_numpy(sk), p).wy_cat, mine.wz_cat)

    got = _port_verifiers(pk, sig, mu, p)
    sig_t, mu_t = torch.from_numpy(sig), torch.from_numpy(mu)
    got["verify_mxu carried"] = mxu.verify_mxu(carried, sig_t, mu_t, p).numpy()
    epk = convert.expanded_pk_from_numpy(*(x.numpy() for x in scheme.expand_pk(torch.from_numpy(pk), p)),
                                         device="cpu")
    assert epk.a_hat.dtype == torch.int32 and epk.tr.dtype == torch.uint8
    got["verify_expanded carried"] = scheme.verify_expanded(epk, sig_t, mu_t, p).numpy()
    for name, ok in got.items():
        np.testing.assert_array_equal(ok, ok_j, err_msg=f"{name} against JAX verify_mxu")
    _check_against_oracle(level, pk, sig, mu, names, got)


def test_verify_matches_oracle_levels_3_5():
    """Levels 3 and 5: the three verifiers against `oracle.verify` on valid
    and corrupted rows; single-row and unbatched calls; and at level 3
    signatures that the port's own `sign_stream_mxu` made."""
    for level in (3, 5):
        p = params.get_params(level)
        pk, _, sig, mu, names = _batch(level, RNG_SEED + level)
        _check_against_oracle(level, pk, sig, mu, names, _port_verifiers(pk, sig, mu, p))
        pk_t = torch.from_numpy(pk)
        one = mxu.verify_mxu(mxu.build_verify_operators(pk_t, p), torch.from_numpy(sig[:1]),
                             torch.from_numpy(mu[:1]), p)
        unbatched = scheme.verify(pk_t, torch.from_numpy(sig[-1]), torch.from_numpy(mu[-1]), p)
        assert one.shape == (1,) and bool(one[0]) and unbatched.shape == () and not bool(unbatched)

    p = params.get_params(3)
    rng = np.random.default_rng(RNG_SEED + 30)
    kp = scheme.keygen(torch.from_numpy(rng.integers(0, 256, 32, dtype=np.uint8)), p)
    mus = torch.from_numpy(rng.integers(0, 256, (3, 64), dtype=np.uint8))
    res = mxu.sign_stream_mxu(mxu.build_operators(kp.sk, p), mus, p, window=3, max_rounds=512)
    assert bool(res.ok.all())
    verifier = mxu.MxuVerifier(mxu.build_verify_operators(kp.pk, p), p)
    epk = scheme.expand_pk(kp.pk, p)
    assert torch.equal(epk.tr, kp.tr) and torch.equal(verifier.tr, kp.tr)
    bad = res.sig.clone()
    bad[1, 40] ^= 4
    for sigs, expect in ((res.sig, [True] * 3), (bad, [True, False, True])):
        for ok in (verifier(sigs, mus), scheme.verify_expanded(epk, sigs, mus, p),
                   scheme.verify(kp.pk.expand(3, -1), sigs, mus, p)):
            assert ok.tolist() == expect
