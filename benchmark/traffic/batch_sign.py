"""Closed-loop signing through the bytes API, one client: each call is
`api.Signer(level, sk).sign(messages)` on `batch` messages, back to back.
The signer is the program's default (mode and window): the harness
passes neither.

Parameters (the mix file's `params`):
  batch                 messages a call (1: a lone handshake signature)
  message_prefix_hex    bytes every message starts with
  message_random_bytes  the bytes after it, drawn from the seed
  distinct_calls        calls with messages of their own; the window
                        cycles over them
  warm_calls            calls in set-up, on messages of their own
  sample_per_call       signatures a call keeps for the reference
  max_checked           kept signatures the reference recomputes (a
                        sample drawn from the seed)
  trace_calls           calls the traced run profiles

Checks (limit 0 each): the program's pk and sk bytes against the
reference's key generation from the same seed; calls that answered fewer
signatures than messages; sampled signatures that differ from the
reference's deterministic signature, byte for byte.

Control (`control`): the program's own randomized signing switched on
(`api.Signer.sign(..., randomized=True)`). Its signatures verify, but the
configuration states deterministic signing: the sampled signatures differ
from the reference's.
"""

from __future__ import annotations

from benchmark.traffic import common


def run(ctx):
    from dilithium_tpu_torch import _kernels, api

    if ctx.hook:
        ctx.hook(ctx)
    prm = ctx.params
    batch = prm["batch"]
    p = common.ref_params(ctx.config)
    seed, pk, sk = common.program_keys(ctx)
    signer = api.Signer(ctx.config["level"], sk, device=ctx.device)
    pool = common.messages(ctx, prm["distinct_calls"], batch)
    sample = common.sample_rows(ctx, batch, prm["sample_per_call"])
    kept, short = [], [0]

    def call(i):
        msgs = pool[i % len(pool)]
        sigs = signer.sign(msgs)
        if len(sigs) != batch:
            short[0] += 1
            return 0
        kept.extend((msgs[r], sigs[r]) for r in sample[i % len(sample)])
        return batch

    for msgs in common.messages(ctx, prm["warm_calls"], batch, common.WARM):
        signer.sign(msgs)
    out = common.drive(ctx, call, batch, _kernels.SHAPES)
    del signer
    common.release(ctx.device)
    key_differ, _, ref_sk = common.key_check(seed, pk, sk, p)
    out.checks = {
        "key_bytes_differ": (key_differ, 0),
        "calls_short": (short[0], 0),
        "signatures_differ": (common.signature_check(ctx, ref_sk, common.choose(ctx, kept, prm["max_checked"]), p), 0),
    }
    out.extra["checked"] = min(len(kept), prm["max_checked"])
    return out


def control(ctx) -> None:
    """The program's Signer signs with randomized signing."""
    from dilithium_tpu_torch import api

    sign = api.Signer.sign
    api.Signer.sign = lambda self, messages, randomized=False: sign(self, messages, randomized=True)
