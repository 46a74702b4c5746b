"""PyTorch port, the bytes API and the CLI on the CPU: `api.keygen`,
`api.sign` (deterministic and randomized), `api.verify`, `Signer` and
`Verifier` in both modes (with their .npz caches written and reloaded) and
`MultiSigner`, against the C++ oracle at levels 2, 3 and 5; the mu hashes
against hashlib and the JAX package's `api.compute_mu`; and
`python -m dilithium_tpu_torch` in process, with its exit codes.

Two tests, one for the API and one for the CLI."""

import hashlib
import os
import warnings

import numpy as np
import pytest
import torch

from dilithium_tpu import api as japi
from dilithium_tpu_torch import api, oracle, params
from dilithium_tpu_torch.__main__ import main
from dilithium_tpu_torch.tools import verify_cases

RNG_SEED = 808
N_MSG = 5


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tensors here are small, and beside other
    test workers torch's default thread pool spends most of its time
    waiting for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u8(rows) -> np.ndarray:
    return np.stack([np.frombuffer(bytes(r), dtype=np.uint8) for r in rows])


def _level(level: int, tmp_path):
    p = params.get_params(level)
    rng = np.random.default_rng(RNG_SEED + level)
    seeds = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes() for _ in range(3)]
    pks, sks = api.keygen(level, seeds, device="cpu")
    pk_o, sk_o = oracle.keygen(level, _u8(seeds))
    assert pks == [bytes(r) for r in pk_o] and sks == [bytes(r) for r in sk_o]

    msgs = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes() for n in rng.integers(0, 300, N_MSG)]
    msgs[0] = b""
    tr = sks[0][64:96]
    mus = api.compute_mu_many(tr, msgs)
    want = [bytes(r) for r in oracle.sign(level, np.repeat(sk_o[:1], N_MSG, axis=0), mus)[0]]
    assert api.sign(level, sks[0], msgs, device="cpu") == want

    rand = api.sign(level, sks[0], msgs, randomized=True, device="cpu")
    assert all(a != b for a, b in zip(rand, want))
    assert oracle.verify(level, np.repeat(pk_o[:1], N_MSG, axis=0), mus, _u8(rand)).all()

    ks = [i % 3 for i in range(N_MSG)]
    multi = api.MultiSigner(level, sks, window=3, device="cpu")
    mus_k = api.compute_mu_many([sks[k][64:96] for k in ks], msgs)
    assert multi.sign(list(zip(ks, msgs))) == [bytes(r) for r in oracle.sign(level, sk_o[ks], mus_k)[0]]
    assert multi.sign([]) == [] and api.sign(level, sks[0], [], device="cpu") == []
    assert api.verify(level, pks[0], [], device="cpu") == []
    with pytest.raises(IndexError):
        multi.sign([(3, b"m")])

    # valid pairs, a row of every corruption class (a corrupted mu becomes
    # another message), and a signature of the wrong length
    _, sk_f = oracle.keygen(level, rng.integers(0, 256, (1, 32), dtype=np.uint8))
    mu_f = rng.integers(0, 256, (1, 64), dtype=np.uint8)
    bad_sig, bad_mu, names = verify_cases.negative_cases(_u8(want), mus, oracle.sign(level, sk_f, mu_f)[0][0],
                                                         mu_f[0], p, seed=level)
    assert set(names) == set(verify_cases.CLASSES)
    msg_of = {m.tobytes(): msg for m, msg in zip(mus, msgs)}
    pairs = list(zip(msgs, want)) + [(msg_of.get(m.tobytes(), msgs[1] + b"!"), s.tobytes())
                                     for s, m in zip(bad_sig, bad_mu)]
    expect = oracle.verify(level, np.repeat(pk_o[:1], len(pairs), axis=0),
                           api.compute_mu_many(tr, [m for m, _ in pairs]), _u8(s for _, s in pairs))
    assert expect.tolist() == [True] * N_MSG + [False] * len(names)
    pairs.append((msgs[1], want[1][:-1]))
    want_ok = expect.tolist() + [False]
    assert api.verify(level, pks[0], pairs, device="cpu") == want_ok

    for mode in ("mxu", "batch"):
        path = str(tmp_path / f"sk{level}{mode}")
        for cached in (False, True):  # the write, then the reload
            assert os.path.exists(path + ".npz") == cached
            signer = api.Signer(level, sks[0], mode=mode, window=2, cache_path=path, device="cpu")
            assert signer.mode == mode and signer.sign(msgs) == want, (mode, cached)
            verifier = api.Verifier(level, pks[0], mode=mode, cache_path=path + "v", device="cpu")
            assert verifier.mode == mode and verifier.verify(pairs) == want_ok, (mode, cached)
    assert signer.sign([]) == [] and verifier.verify([]) == []
    assert api.Signer(level, sks[0], device="cpu").mode == "batch"  # auto on the CPU
    return tr, msgs, mus


def test_bytes_api_matches_oracle(tmp_path):
    """Levels 2, 3, 5 against the oracle; a cache file of another kind or
    key is not loaded; the mu hashes; device="cuda" raises without a
    card."""
    for level in (2, 3, 5):
        tr, msgs, mus = _level(level, tmp_path)

    # a file that holds another key's expansion, or another kind, misses
    _, sk_o = oracle.keygen(5, np.zeros((2, 32), dtype=np.uint8) + np.arange(2, dtype=np.uint8)[:, None])
    path = str(tmp_path / "other")
    api.Signer(5, sk_o[0].tobytes(), mode="batch", cache_path=path, device="cpu")
    meta0 = api._expansion_meta("torch.ExpandedKey", 5, sk_o[0].tobytes())
    assert api._load_expansion(path, meta0, "cpu") is not None
    assert api._load_expansion(path, api._expansion_meta("torch.ExpandedKey", 5, sk_o[1].tobytes()), "cpu") is None
    assert api._load_expansion(path, dict(meta0, kind="ExpandedKey"), "cpu") is None

    for m in msgs:
        assert api.compute_mu(tr, m) == japi.compute_mu(tr, m)
    np.testing.assert_array_equal(mus, _u8(japi.compute_mu(tr, m) for m in msgs))
    many = [bytes([i % 251]) * (i % 97) for i in range(70)]
    trs = [hashlib.sha256(bytes([i])).digest() for i in range(70)]
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the native path runs here: no fallback warning
        got = api.compute_mu_many(trs, many)
    np.testing.assert_array_equal(got, _u8(hashlib.shake_256(t + m).digest(64) for t, m in zip(trs, many)))
    np.testing.assert_array_equal(api.compute_mu_many(trs[0], many), _u8(api.compute_mu(trs[0], m) for m in many))
    fixed = np.stack([np.frombuffer(m, dtype=np.uint8) for m in many if len(m) == 20] * 2)
    batch = api.compute_mu_batch(np.frombuffer(trs[0], dtype=np.uint8), fixed, device="cpu")
    np.testing.assert_array_equal(batch.numpy(), _u8(api.compute_mu(trs[0], m.tobytes()) for m in fixed))
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            api.keygen(2, [bytes(32)])


def test_cli_exit_codes(tmp_path, capsys):
    """keygen, sign and verify at level 2 on the CPU: exit codes 0, 0, 0;
    1 after one byte of a signature is flipped; 2 on a seed of the wrong
    length. The files equal the oracle's keys and signatures."""
    seed, pk, sk = tmp_path / "seed", tmp_path / "k.pk", tmp_path / "k.sk"
    seed.write_bytes(bytes(range(32)))
    msgs = [tmp_path / "a", tmp_path / "b"]
    msgs[0].write_bytes(b"hello")
    msgs[1].write_bytes(b"")
    common = ["--level", "2", "--device", "cpu"]
    assert main(common + ["keygen", "--seed", str(seed), "--pk", str(pk), "--sk", str(sk)]) == 0
    pk_o, sk_o = oracle.keygen(2, np.frombuffer(bytes(range(32)), dtype=np.uint8)[None])
    assert pk.read_bytes() == pk_o[0].tobytes() and sk.read_bytes() == sk_o[0].tobytes()
    assert main(common + ["sign", "--sk", str(sk)] + [str(m) for m in msgs]) == 0
    mus = api.compute_mu_many(sk_o[0, 64:96].tobytes(), [m.read_bytes() for m in msgs])
    sig_o, _ = oracle.sign(2, np.repeat(sk_o, 2, axis=0), mus)
    assert [(tmp_path / f"{m.name}.sig").read_bytes() for m in msgs] == [s.tobytes() for s in sig_o]
    assert main(common + ["verify", "--pk", str(pk)] + [str(m) for m in msgs]) == 0
    sig_b = tmp_path / "b.sig"
    flipped = bytearray(sig_b.read_bytes())
    flipped[40] ^= 1
    sig_b.write_bytes(bytes(flipped))
    assert main(common + ["verify", "--pk", str(pk)] + [str(m) for m in msgs]) == 1
    assert capsys.readouterr().out.splitlines()[-2:] == [f"{msgs[0]}: OK", f"{msgs[1]}: FAIL"]
    seed.write_bytes(bytes(31))
    assert main(common + ["keygen", "--seed", str(seed), "--pk", str(pk), "--sk", str(sk)]) == 2
