"""The benchmark's reference (`benchmark/reference/`) against the
program's plain CPU path at levels 2, 3 and 5: key bytes from a seed,
deterministic signatures, and verify's answers on valid and altered
signatures (c_tilde, z, a hint count, a hint index, a wrong length)."""

import numpy as np
import pytest

from benchmark.reference import dilithium as ref
from dilithium_tpu_torch import api

N_MSG = 5


@pytest.mark.parametrize("level", [2, 3, 5])
def test_reference_matches_program(level):
    p = ref.PARAMS[level]
    rng = np.random.default_rng(1300 + level)
    seed = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
    pk, sk = ref.keygen(seed, p)
    pks, sks = api.keygen(level, [seed], device="cpu")
    assert (pks[0], sks[0]) == (pk, sk)
    assert (len(pk), len(sk)) == (p.pk_bytes, p.sk_bytes)

    msgs = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes() for n in (0, 1, 59, 130, 333)]
    sigs = api.Signer(level, sk, device="cpu").sign(msgs)
    rsk = ref.unpack_sk(sk, p)
    mus = [ref.compute_mu(rsk.tr, m) for m in msgs]
    assert ref.sign(rsk, mus, p) == sigs
    assert all(len(s) == p.sig_bytes for s in sigs)

    z_bytes = p.L * ref.N * p.z_bits // 8
    bad = [bytearray(s) for s in sigs]
    bad[1][0] ^= 1  # c_tilde
    bad[2][ref.SEEDBYTES + z_bytes // 2] ^= 1  # z
    bad[3][-1] ^= 1  # the last hint count
    bad[4][ref.SEEDBYTES + z_bytes] ^= 0x80  # a hint index
    bad = [bytes(b) for b in bad] + [sigs[0][:-1]]
    pairs = list(zip(msgs + msgs[:1], bad))
    got = ref.verify(ref.unpack_pk(pk, p), mus + mus[:1], bad, p)
    assert list(got) == api.Verifier(level, pk, device="cpu").verify(pairs)
    assert got[0] and not got[1:].any()
    assert ref.verify(ref.unpack_pk(pk, p), mus, sigs, p).all()
