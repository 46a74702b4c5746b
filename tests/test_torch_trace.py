"""The port's spans and counters (`dilithium_tpu_torch.trace`) on the CPU
at level 2, two messages: with no profiler nothing records and every
span is the shared no-op; under `torch.profiler` the bytes API, the
dense-operator path and both round loops record their spans (also as
the profiler's own events) and counters, equal to the loops' rounds,
slots and attempts, a session's totals only its own; the signatures and
verdicts are the same bytes either way.

Two tests: a port file of two tests or fewer is handed out last by
xdist's loadfile order (see ROADMAP)."""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dilithium_tpu_torch import api, scheme, trace

MSGS = [b"", b"a message to sign"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def keys():
    pks, sks = api.keygen(2, [bytes(range(32))], device="cpu")
    return pks[0], sks[0]


def _mus(signer):
    return torch.from_numpy(api.compute_mu_many(signer.tr, MSGS))


def test_off_records_nothing(keys):
    pk, sk = keys
    signer = api.Signer(2, sk, mode="mxu", device="cpu")
    assert not trace.recording()
    assert trace.span("api.sign") is trace.span("scheme.round") is trace._NOOP
    before = trace.totals()
    sigs = signer.sign(MSGS)
    trace.count("scheme.rounds", 5)
    assert api.Verifier(2, pk, mode="mxu", device="cpu").verify(list(zip(MSGS, sigs))) == [True, True]
    assert trace.totals() == before


def test_on_records_spans_and_counters(keys):
    pk, sk = keys
    mxu_signer = api.Signer(2, sk, mode="mxu", device="cpu")
    batch_signer = api.Signer(2, sk, mode="batch", device="cpu")
    verifier = api.Verifier(2, pk, mode="mxu", device="cpu")
    want = mxu_signer.sign(MSGS)  # untraced
    pairs = list(zip(MSGS, want))
    pairs[1] = (MSGS[1], want[1][:-1] + bytes([want[1][-1] ^ 1]))
    want_ok = verifier.verify(pairs)
    res = mxu_signer.signer(_mus(mxu_signer))  # the same loop the API runs, for its rounds and attempts

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert mxu_signer.sign(MSGS) == want
        # another thread does not record, and its spans keep the session's totals
        other = threading.Thread(target=lambda: trace.span("api.sign").__enter__())
        other.start()
        other.join(timeout=60)
        assert not other.is_alive()
        assert verifier.verify(pairs) == want_ok == [True, False]
    t = trace.totals()
    spans, counters = t["spans"], t["counters"]
    names = {"api.sign", "api.verify", "api.mu", "api.stage", "api.h2d", "api.d2h", "api.rows",
             "mxu.sign_stream", "mxu.verify", "scheme.round", "scheme.sync"}
    assert set(spans) == names
    assert not any("(" in n for n in set(spans) | set(counters))
    assert spans["api.sign"]["n"] == spans["api.verify"]["n"] == spans["mxu.sign_stream"]["n"] == 1
    assert spans["scheme.round"]["n"] == spans["scheme.sync"]["n"] == res.rounds
    # the verifier's staging buffers were allocated by its untraced call
    assert counters == {"scheme.rounds": res.rounds, "scheme.slots": res.rounds * len(MSGS),
                        "scheme.attempts": int(res.attempts.sum()), "api.staged_rows": len(pairs)}
    for s in spans.values():
        assert 0 <= s["self_ms"] <= s["total_ms"]
    assert spans["api.sign"]["total_ms"] >= spans["mxu.sign_stream"]["total_ms"] >= spans["scheme.round"]["total_ms"]
    # the raw events: prof.events() builds the whole event tree, many times slower
    assert names <= {e.name() for e in prof.profiler.kineto_results.events()}

    # a second session: the lockstep loop (B x A slots a round), its own totals only
    A = 4
    mus = _mus(batch_signer)
    res = scheme.sign_expanded(batch_signer.expanded, mus, batch_signer.p, attempts_per_round=A)
    with profile(activities=[ProfilerActivity.CPU]):
        assert batch_signer.sign(MSGS) == want
    t = trace.totals()
    assert set(t["spans"]) == {"api.sign", "api.mu", "api.h2d", "api.d2h", "api.rows", "scheme.round", "scheme.sync"}
    assert t["spans"]["api.sign"]["n"] == 1 and t["spans"]["scheme.round"]["n"] == res.rounds
    assert t["counters"] == {"scheme.rounds": res.rounds, "scheme.slots": res.rounds * len(MSGS) * A,
                             "scheme.attempts": int(res.attempts.sum())}
    assert np.array_equal(np.stack([np.frombuffer(s, np.uint8) for s in want]), res.sig.numpy())

