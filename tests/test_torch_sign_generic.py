"""PyTorch port, the generic NTT signers: `scheme.expand_sk` and one
`scheme._sign_attempt` against the JAX package's (level 2, byte for byte),
and the lockstep (`sign`, `sign_expanded`) and stream (`sign_stream`,
`sign_stream_keys`) signers against the C++ oracle at levels 2, 3 and 5,
in bytes and attempts.

Three tests: the JAX comparison (one jitted `expand_sk`, one eager
`_sign_attempt` at two lanes; the JAX side is keyed from oracle bytes so
that its keygen is not compiled), the signers against the oracle, and the
stream signers' default window (the loop stubbed, no signing)."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dilithium_tpu import params as jparams
from dilithium_tpu import scheme as jscheme
from dilithium_tpu_torch import api, convert, mxu, oracle, params, scheme
from dilithium_tpu_torch.ops import ntt, pack

RNG_SEED = 707


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tensors here are small, and beside other
    test workers torch's default thread pool spends most of its time
    waiting for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _negacyclic(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Schoolbook a * b mod (X^256 + 1, q) of two [256] int arrays."""
    out = np.zeros(512, dtype=object)
    for i in range(256):
        out[i:i + 256] += int(a[i]) * b.astype(object)
    return np.array([(out[k] - out[k + 256]) % params.Q for k in range(256)], dtype=np.int64)


def test_expand_sk_and_sign_attempt_match_jax():
    """Level 2: the port's ExpandedKey equals JAX's `expand_sk` (also
    carried over by `convert`), and one `_sign_attempt` over two lanes, one
    accepting at a nonzero kappa and one rejecting at kappa 0, gives JAX's
    c_tilde, z, h and accept; the accepting lane packs to the oracle's
    signature. `ntt.poly_mul` equals the schoolbook product."""
    level = 2
    p, jp = params.get_params(level), jparams.get_params(level)
    rng = np.random.default_rng(RNG_SEED)
    _, sk = oracle.keygen(level, rng.integers(0, 256, (1, 32), dtype=np.uint8))
    pool = rng.integers(0, 256, (16, 64), dtype=np.uint8)
    sig_o, att_o = oracle.sign(level, np.repeat(sk, len(pool), axis=0), pool)
    late = np.nonzero(att_o > 1)[0]
    acc_row, rej_row = late[0], late[1]
    mus = pool[[acc_row, rej_row]]
    kappa = np.array([(att_o[acc_row] - 1) * p.L, 0], dtype=np.uint32)
    key = sk[0, 32:64].tobytes()
    rhoprime = np.stack([np.frombuffer(hashlib.shake_256(key + m.tobytes()).digest(64), dtype=np.uint8)
                         for m in mus])

    ek_j = jscheme.expand_sk(jnp.asarray(sk[0]), jp)
    ek = scheme.expand_sk(torch.from_numpy(sk[0]), p)
    carried = convert.expanded_key_from_numpy(*(np.asarray(x) for x in ek_j), device="cpu")
    for field, mine, ref, conv in zip(scheme.ExpandedKey._fields, ek, ek_j, carried):
        assert mine.dtype == conv.dtype == (torch.uint8 if field in ("key", "tr") else torch.int32), field
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref).astype(np.int64), err_msg=field)
        assert torch.equal(mine, conv), field

    out_j = jscheme._sign_attempt(ek_j.a_hat, ek_j.s1_hat, ek_j.s2_hat, ek_j.t0_hat, jnp.asarray(mus),
                                  jnp.asarray(rhoprime), jnp.asarray(kappa), jp)
    out = scheme._sign_attempt(ek.a_hat, ek.s1_hat, ek.s2_hat, ek.t0_hat, torch.from_numpy(mus),
                               torch.from_numpy(rhoprime), torch.from_numpy(kappa.astype(np.int64)), p)
    for name, mine, ref in zip(("c_tilde", "z", "h", "accept"), out, out_j):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref), err_msg=name)
    assert out[3].tolist() == [True, False]
    sig = pack.pack_sig(out[0][:1], out[1][:1], out[2][:1], p)
    np.testing.assert_array_equal(sig.numpy()[0], sig_o[acc_row])

    polys = rng.integers(0, params.Q, (2, 3, 256)).astype(np.int32)
    got = ntt.poly_mul(torch.from_numpy(polys[0]), torch.from_numpy(polys[1])).numpy()
    for a, b, g in zip(polys[0], polys[1], got):
        np.testing.assert_array_equal(g, _negacyclic(a, b))


def test_signers_match_oracle():
    """Levels 2, 3, 5: `sign` (a key a lane), `sign_expanded` (one key
    broadcast), `sign_stream` (W < Q, so the drain runs) and
    `sign_stream_keys` (three keys, mixed) equal `oracle.sign` in bytes and
    attempts; a randomized queue verifies under the oracle; a lockstep run
    cut at max_rounds reports its unfinished lanes; `validate_rhoprime`
    rejects a shared or wrongly typed rhoprime."""
    for level in (2, 3, 5):
        p = params.get_params(level)
        rng = np.random.default_rng(RNG_SEED + level)
        pk, sk = oracle.keygen(level, rng.integers(0, 256, (3, 32), dtype=np.uint8))
        mus = rng.integers(0, 256, (5, 64), dtype=np.uint8)
        ks = np.array([0, 1, 2, 0, 1])
        sig_k, att_k = oracle.sign(level, sk[ks], mus)
        sig_0, att_0 = oracle.sign(level, np.repeat(sk[:1], 5, axis=0), mus)
        mus_t, sk_t = torch.from_numpy(mus), torch.from_numpy(sk)
        ek0 = scheme.expand_sk(sk_t[0], p)
        eks = scheme.expand_sk(sk_t, p)
        runs = {
            "sign": (scheme.sign(sk_t[ks], mus_t, p), sig_k, att_k),
            "sign_expanded": (scheme.sign_expanded(ek0, mus_t, p, attempts_per_round=2), sig_0, att_0),
            "sign_stream": (scheme.sign_stream(ek0, mus_t, p, window=2), sig_0, att_0),
            "sign_stream_keys": (scheme.sign_stream_keys(eks, torch.from_numpy(ks), mus_t, p, window=3),
                                 sig_k, att_k),
        }
        for name, (res, sig_o, att_o) in runs.items():
            assert res.sig.dtype == torch.uint8 and res.attempts.dtype == torch.int32, name
            np.testing.assert_array_equal(res.sig.numpy(), sig_o, err_msg=f"level {level} {name}")
            np.testing.assert_array_equal(res.attempts.numpy(), att_o, err_msg=f"level {level} {name}")
            assert bool(res.ok.all()) and res.rounds > 0, name
        # lockstep rounds: the slowest lane's attempts over A, rounded up
        assert runs["sign"][0].rounds == -(-int(att_k.max()) // 4)

        rp = torch.from_numpy(rng.integers(0, 256, (5, 64), dtype=np.uint8))
        rand = scheme.sign_stream(ek0, mus_t, p, window=2, rhoprime=rp)
        assert bool(rand.ok.all()) and not torch.equal(rand.sig, runs["sign_stream"][0].sig)
        assert oracle.verify(level, np.repeat(pk[:1], 5, axis=0), mus, rand.sig.numpy()).all()

    # cut at one round of one attempt: lanes that needed more are not ok
    cut = scheme.sign_expanded(ek0, mus_t, p, attempts_per_round=1, max_rounds=1)
    assert cut.rounds == 1 and cut.attempts.tolist() == [1] * 5
    assert cut.ok.tolist() == (att_0 == 1).tolist()
    with pytest.raises(ValueError, match="per-message"):
        scheme.sign_stream(ek0, mus_t, p, rhoprime=rp[:1].expand(1, 64))
    with pytest.raises(ValueError, match="uint8"):
        scheme.sign_expanded(ek0, mus_t, p, rhoprime=rp.to(torch.int32))
    with pytest.raises(ValueError, match="key_idx"):
        scheme.sign_stream_keys(eks, torch.zeros(4, dtype=torch.int64), mus_t, p)
    with pytest.raises(IndexError):
        scheme.sign_stream_keys(eks, torch.tensor([0, 1, 2, 3, 0]), mus_t, p)


def test_default_window_by_level(monkeypatch):
    """window=None takes the level's `scheme.default_window` in every
    stream signer (the dense attempt, the one-key and the keyed NTT-form
    attempts) and in the api's services; an explicit window wins, and a
    call runs min(window, Q) slots. The loop is stubbed to record the W it
    is handed, so no key material is built but level 2's, for the api."""
    seen = []

    def loop(attempt_fn, mu, rhoprime, p, W, max_rounds):
        seen.append(W)
        n = mu.shape[0]
        return scheme.SignResult(torch.zeros((n, p.sig_bytes), dtype=torch.uint8),
                                 torch.ones(n, dtype=torch.int32), torch.ones(n, dtype=torch.bool), 1)

    monkeypatch.setattr(scheme, "_stream_loop", loop)
    key = torch.zeros(32, dtype=torch.uint8)
    ops = mxu.KeyOperators(torch.zeros((4, 4), dtype=torch.int8), torch.zeros((4, 4), dtype=torch.int8),
                           key, key)
    ek = scheme.ExpandedKey(None, None, None, None, key, key)
    eks = ek._replace(key=key[None])
    for level in (2, 3, 5):
        p = params.get_params(level)
        default = scheme.default_window(p)
        assert isinstance(default, int) and default >= 768, (level, default)
        q = default + 1
        mu = torch.zeros((q, 64), dtype=torch.uint8)
        signers = {
            "mxu": lambda m, **kw: mxu.sign_stream_mxu(ops, m, p, rhoprime=m, **kw),
            "stream": lambda m, **kw: scheme.sign_stream(ek, m, p, rhoprime=m, **kw),
            "keys": lambda m, **kw: scheme.sign_stream_keys(eks, torch.zeros(len(m), dtype=torch.int64), m,
                                                            p, rhoprime=m, **kw),
        }
        for name, sign in signers.items():
            for kw, n, want in (({}, q, default), ({"window": None}, 3, 3), ({"window": 5}, q, 5)):
                sign(mu[:n], **kw)
                assert seen.pop() == want, (level, name, kw, n)
        mxu.MxuSigner(ops, p)(mu)
        mxu.MxuSigner(ops, p, window=5)(mu)
        assert seen == [default, 5], level
        seen.clear()

    p = params.get_params(2)
    _, sk = oracle.keygen(2, np.zeros((1, 32), dtype=np.uint8))
    q = scheme.default_window(p) + 1
    msgs = [i.to_bytes(2, "little") for i in range(q)]
    for window, want in ((None, q - 1), (5, 5)):
        assert len(api.Signer(2, sk[0], mode="mxu", window=window, device="cpu").sign(msgs)) == q
        assert len(api.MultiSigner(2, [sk[0]], window=window, device="cpu").sign([(0, m) for m in msgs])) == q
        assert seen == [want, want], window
        seen.clear()
