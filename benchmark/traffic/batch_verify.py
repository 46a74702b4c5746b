"""Closed-loop verification through the bytes API, one client: each call
is `api.Verifier(level, pk).verify(pairs)` on `batch` (message,
signature) pairs, back to back.

Set-up signs a corpus of `batch` messages with the program's `Signer`.
Each call verifies the whole corpus with `corrupt_per_call` rows of its
own given one flipped bit: in turn c_tilde's first byte, a byte in the
middle of z and the last hint count (the corruption pattern of the
port's `bench.py`), rows drawn from the seed. There are
`distinct_calls` such call inputs, which the window cycles over.

Parameters: batch, message_prefix_hex, message_random_bytes,
corrupt_per_call, distinct_calls, warm_calls, sample_per_call (answers a
call keeps beside its corrupted rows'), max_checked (kept answers of
uncorrupted rows that the reference recomputes; it recomputes every
corrupted one), trace_calls.

Checks (limit 0 each): the key's bytes against the reference's key
generation; calls that answered fewer pairs than asked; kept answers
that differ from the reference's verification of the same pair; and,
since the corpus is the program's own, checked rows whose reference
verdict is not what the row is (an untouched row the reference rejects,
a corrupted one it accepts), so a signer that emits invalid signatures
fails even where the verifier rejects everything.

Control (`control`): the program's verify with its last step left out,
the comparison of c_tilde with SHAKE256(mu || w1') (`scheme._verify_tail`
keeps only its other tests). It accepts altered signatures, which the
configuration says must be rejected.
"""

from __future__ import annotations

from benchmark import harness
from benchmark.reference import dilithium as ref
from benchmark.traffic import common


def positions(p: ref.Params) -> tuple:
    """The flipped byte of each corruption kind: c_tilde, z, hint count."""
    return 0, ref.SEEDBYTES + ref.N * p.z_bits // 8 // 2, p.sig_bytes - 1


def run(ctx):
    from dilithium_tpu_torch import _kernels, api

    if ctx.hook:
        ctx.hook(ctx)
    prm = ctx.params
    batch, n_bad = prm["batch"], prm["corrupt_per_call"]
    p = common.ref_params(ctx.config)
    level = ctx.config["level"]
    seed, pk, sk = common.program_keys(ctx)
    msgs = common.messages(ctx, 1, batch)[0]
    signer = api.Signer(level, sk, device=ctx.device)
    sigs = signer.sign(msgs)
    del signer
    base = list(zip(msgs, sigs))
    g = harness.rng(ctx.seed, common.CORRUPT)
    at = positions(p)
    pool = []
    for _ in range(prm["distinct_calls"]):
        pairs, bad = list(base), [int(r) for r in g.choice(batch, n_bad, replace=False)]
        for j, r in enumerate(bad):
            s = bytearray(sigs[r])
            s[at[j % len(at)]] ^= 0x01
            pairs[r] = (msgs[r], bytes(s))
        pool.append((pairs, bad))
    sample = common.sample_rows(ctx, batch, prm["sample_per_call"])
    verifier = api.Verifier(level, pk, device=ctx.device)
    kept, short = [], [0]

    def call(i):
        pairs, bad = pool[i % len(pool)]
        ok = verifier.verify(pairs)
        if len(ok) != batch:
            short[0] += 1
            return 0
        kept.extend((pairs[r], ok[r], True) for r in bad)
        kept.extend((pairs[r], ok[r], r in bad) for r in sample[i % len(sample)])
        return batch

    for _ in range(prm["warm_calls"]):
        verifier.verify(base)
    out = common.drive(ctx, call, batch, _kernels.SHAPES)
    del verifier
    common.release(ctx.device)

    checked = [k for k in kept if k[2]] + common.choose(ctx, [k for k in kept if not k[2]], prm["max_checked"])
    pairs = sorted({pair for pair, _, _ in checked})
    key_differ, ref_pk, _ = common.key_check(seed, pk, sk, p)
    rpk = ref.unpack_pk(ref_pk, p)
    want = dict(zip(pairs, ref.verify(rpk, [ref.compute_mu(rpk.tr, m) for m, _ in pairs],
                                      [s for _, s in pairs], p)))
    out.checks = {
        "key_bytes_differ": (key_differ, 0),
        "calls_short": (short[0], 0),
        "verdicts_differ": (sum(bool(v) != bool(want[pair]) for pair, v, _ in checked), 0),
        "corpus_rows_wrong": (sum(bool(want[pair]) == bad for pair, _, bad in checked), 0),
    }
    out.extra.update(checked=len(checked), rejected=sum(not want[pair] for pair, _, _ in checked))
    return out


def control(ctx) -> None:
    """The program's verify without its final c_tilde comparison."""
    from dilithium_tpu_torch import scheme

    scheme._verify_tail = lambda w, h, c_tilde, mu, pre_ok, p: pre_ok
