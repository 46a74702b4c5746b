"""`api.MultiSigner`'s spans and counter on the CPU at level 2: three
keys, six messages with skewed key indices. Under `torch.profiler` the
call records `api.keys` (the index check and the per-message tr list)
and `scheme.sign_stream_keys` inside `api.sign`, and one `scheme.gather`
(the slots' key material) inside each `scheme.round`; `api.distinct_keys`
counts the keys the call touched. With no profiler nothing records. The
signatures are the same bytes either way, and each equals the oracle's
under its message's own key.

One test: a port file of two tests or fewer is handed out last by
xdist's loadfile order (see ROADMAP)."""

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from dilithium_tpu_torch import api, oracle, trace

LEVEL = 2
KEYS = [0, 2, 0, 0, 2, 0]  # key 0 hot, key 1 never used
MSGS = [b"", b"m1", b"a message to sign", b"m3" * 40, b"m4", b"m5"]
NESTED = [  # (inner span, the span that holds each of its events)
    ("api.keys", "api.sign"),
    ("api.mu", "api.sign"),
    ("scheme.sign_stream_keys", "api.sign"),
    ("scheme.round", "scheme.sign_stream_keys"),
    ("scheme.gather", "scheme.round"),
]


def _events(prof) -> dict:
    """name -> [(start ns, end ns)] of the profiler's CPU events."""
    out: dict = {}
    for e in prof.profiler.kineto_results.events():
        out.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    return out


def test_multisigner_spans_and_counter():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        seeds = [bytes([k]) * 32 for k in range(3)]
        _, sks = api.keygen(LEVEL, seeds, device="cpu")
        signer = api.MultiSigner(LEVEL, sks, device="cpu")
        pairs = list(zip(KEYS, MSGS))

        assert not trace.recording()
        before = trace.totals()
        want = signer.sign(pairs)  # untraced: records nothing
        assert trace.totals() == before
        assert trace.span("api.keys") is trace.span("scheme.gather") is trace._NOOP

        with profile(activities=[ProfilerActivity.CPU]) as prof:
            got = signer.sign(pairs)
        t = trace.totals()
    finally:
        torch.set_num_threads(n)

    assert got == want
    sk_o = np.stack([np.frombuffer(s, np.uint8) for s in sks])
    mus = api.compute_mu_many([sks[k][64:96] for k in KEYS], MSGS)
    assert want == [bytes(r) for r in oracle.sign(LEVEL, sk_o[KEYS], mus)[0]]

    spans, counters = t["spans"], t["counters"]
    assert {"api.sign", "api.keys", "api.mu", "scheme.sign_stream_keys", "scheme.round", "scheme.sync",
            "scheme.gather"} <= set(spans)
    assert not any("(" in name for name in set(spans) | set(counters))
    assert spans["api.sign"]["n"] == spans["api.keys"]["n"] == spans["scheme.sign_stream_keys"]["n"] == 1
    rounds = counters["scheme.rounds"]
    assert spans["scheme.round"]["n"] == spans["scheme.gather"]["n"] == rounds > 0
    assert counters["api.distinct_keys"] == len(set(KEYS)) == 2
    # the round loop's time is the scheme span's, not the api's own
    assert spans["api.sign"]["self_ms"] <= spans["api.sign"]["total_ms"] - spans["scheme.sign_stream_keys"]["total_ms"]

    ev = _events(prof)
    for inner, outer in NESTED:
        assert ev.get(inner), inner
        for s, e in ev[inner]:
            assert any(s0 <= s and e <= e0 for s0, e0 in ev[outer]), (inner, outer)
    (k0, k1), = ev["api.keys"]
    (s0, _), = ev["scheme.sign_stream_keys"]
    assert k1 <= s0  # the key work precedes the loop
