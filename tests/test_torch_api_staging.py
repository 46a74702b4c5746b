"""The verify path's input staging in the PyTorch port's bytes API, on the
CPU at level 2: `Verifier.verify` (rows written once into the buffers the
verifier keeps) and the one-off `api.verify` (a fresh buffer) against
`oracle.verify` on signatures given as bytes, bytearray and memoryview
(one of 4-byte items, its length counted in bytes; one strided), rows
of the wrong length, an empty message and a corrupted row; and one
verifier over batches of 8, 3, 12 and 8 pairs, whose buffers grow, are
reused in part and grow again, with the staging counters under
`torch.profiler`, then shared by two threads with batches of their own.

Two tests: a port file of two tests or fewer is handed out last by
xdist's loadfile order (see ROADMAP)."""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dilithium_tpu_torch import api, oracle, params, trace

LEVEL = 2
P = params.get_params(LEVEL)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus():
    """A key and 12 signed messages (the first empty) as oracle rows."""
    rng = np.random.default_rng(915)
    pk, sk = oracle.keygen(LEVEL, rng.integers(0, 256, (1, 32), dtype=np.uint8))
    msgs = [b""] + [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes() for n in rng.integers(1, 200, 11)]
    tr = api._tr_of_sk(sk[0].tobytes())
    sigs, _ = oracle.sign(LEVEL, np.repeat(sk, len(msgs), axis=0), api.compute_mu_many(tr, msgs))
    return pk[0].tobytes(), tr, msgs, [s.tobytes() for s in sigs]


def _oracle(pk: bytes, tr: bytes, pairs) -> list:
    """The oracle's verdicts; a signature of the wrong byte length is False."""
    sigs = [memoryview(s).tobytes() for _, s in pairs]
    fits = [len(s) == P.sig_bytes for s in sigs]
    rows = np.stack([np.frombuffer(s if f else bytes(P.sig_bytes), dtype=np.uint8) for s, f in zip(sigs, fits)])
    mus = api.compute_mu_many(tr, [m for m, _ in pairs])
    ok = oracle.verify(LEVEL, np.repeat(np.frombuffer(pk, dtype=np.uint8)[None], len(pairs), axis=0), mus, rows)
    return [bool(o) and f for o, f in zip(ok.tolist(), fits)]


def test_mixed_rows_match_oracle(corpus):
    """bytes, bytearray, memoryview and <u4 memoryview rows, a short and a
    long row, the empty message and a corrupted row: Verifier and
    api.verify equal oracle.verify, as a list of bool."""
    pk, tr, msgs, sigs = corpus
    bad = bytearray(sigs[4])
    bad[0] ^= 0x01
    pairs = [(msgs[0], sigs[0]),
             (msgs[1], bytearray(sigs[1])),
             (memoryview(msgs[2]), memoryview(sigs[2])),
             (msgs[3], memoryview(np.frombuffer(sigs[3], dtype="<u4"))),  # 605 items, 2420 bytes
             (msgs[4], bytes(bad)),
             (msgs[5], sigs[5][:-1]),
             (msgs[6], sigs[6] + b"\x00"),
             (msgs[7], memoryview(bytearray(sigs[7]))[:-4]),
             (msgs[8], sigs[8]),
             (msgs[9], memoryview(np.frombuffer(sigs[9], dtype=np.uint8).repeat(2))[::2])]  # strided
    want = _oracle(pk, tr, pairs)
    assert want == [True, True, True, True, False, False, False, False, True, True]
    for got in (api.Verifier(LEVEL, pk, device="cpu").verify(pairs), api.verify(LEVEL, pk, pairs, device="cpu")):
        assert got == want
        assert type(got) is list and all(type(v) is bool for v in got)


def test_buffer_grows_and_is_reused(corpus):
    """One verifier over batches of 8, 3, 12 and 8 pairs, each with a
    corrupted and a short row, under the profiler: each call equals the
    oracle, an earlier answer is not changed by a later call, rows staged
    = pairs given, allocations = 2. Then two threads share the verifier,
    each with its own messages and bad rows: every call equals the oracle."""
    pk, tr, msgs, sigs = corpus
    verifier = api.Verifier(LEVEL, pk, device="cpu")
    calls = []
    for n, flip, short in ((8, 2, 6), (3, 0, 1), (12, 11, 3), (8, 5, 0), (6, 1, 4)):  # all bytes rows
        pairs = list(zip(msgs[:n], sigs[:n]))
        s = bytearray(sigs[flip])
        s[-1] ^= 0x01
        pairs[flip] = (msgs[flip], bytes(s))
        pairs[short] = (msgs[short], sigs[short][:-1])
        calls.append((pairs, _oracle(pk, tr, pairs)))
    pairs = calls.pop()[0]
    pairs = pairs + [(m[::-1] + b"?", s) for m, s in pairs]  # other messages: their signatures fail
    shared = [calls[2], (pairs, _oracle(pk, tr, pairs))]
    with profile(activities=[ProfilerActivity.CPU]):
        answers = []
        for pairs, want in calls:
            answers.append(verifier.verify(pairs))
            assert answers[-1] == want
        counters = trace.totals()["counters"]
    assert answers[0] == calls[0][1] and answers[0].count(False) == 2
    assert counters == {"api.staged_rows": 8 + 3 + 12 + 8, "api.stage_allocs": 2}
    assert len(verifier._sigs) == 12

    start, wrong = threading.Barrier(len(shared)), []

    def run(pairs, want):
        start.wait()
        wrong.extend(got for got in (verifier.verify(pairs) for _ in range(8)) if got != want)

    threads = [threading.Thread(target=run, args=c) for c in shared]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert wrong == []
