"""Closed-loop signing for many tenants through the bytes API, one client:
each call is `api.MultiSigner(level, sks).sign(pairs)` on `batch`
(key index, message) pairs, back to back. The signer holds the
configuration's `keys` keys, made by one `api.keygen` from seeds drawn
from the run's seed, and is the program's default (window): the harness
passes none. Each message's key follows a Zipf law of constant `zipf_s`
over the keys, the key of each popularity rank drawn from the seed.

Parameters (the mix file's `params`):
  batch                 (key, message) pairs a call
  zipf_s                the Zipf constant of the keys' popularity
  message_prefix_hex    bytes every message starts with
  message_random_bytes  the bytes after it, drawn from the seed
  distinct_calls        calls with pairs of their own; the window cycles
                        over them
  warm_calls            calls in set-up, on pairs of their own
  sample_per_call       signatures a call keeps for the reference
  max_checked           kept signatures the reference recomputes (a
                        sample drawn from the seed)
  trace_calls           calls the traced run profiles

Checks (limit 0 each): every key's pk and sk bytes against the
reference's key generation from the same seed; calls that answered fewer
signatures than pairs; sampled signatures that differ, byte for byte,
from the reference's deterministic signature of their message under
their message's own key.

Control (`control`): the program's own randomized signing switched on
(`api.MultiSigner.sign(..., randomized=True)`). Its signatures verify,
but the configuration states deterministic signing: the sampled
signatures differ from the reference's.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from benchmark import harness
from benchmark.traffic import common

TENANTS = 6  # the generator tag of the keys' draws, after common's tags
RANKS, CALLS, WARM = range(3)  # its streams


def key_seeds(ctx, n: int) -> list:
    """n 32-byte key seeds drawn from the run's seed."""
    blob = harness.rng(ctx.seed, common.KEY).bytes(32 * n)
    return [blob[32 * i:32 * (i + 1)] for i in range(n)]


def zipf_keys(ctx, n: int, calls: int, batch: int, stream: int) -> np.ndarray:
    """int [calls, batch]: each message's key, P(rank r) ~ 1 / r^zipf_s
    (r = 1..n), the key of each rank a permutation drawn from the seed."""
    w = 1.0 / np.arange(1, n + 1) ** ctx.params["zipf_s"]
    keys_by_rank = harness.rng(ctx.seed, TENANTS, RANKS).permutation(n)
    ranks = harness.rng(ctx.seed, TENANTS, stream).choice(n, (calls, batch), p=w / w.sum())
    return keys_by_rank[ranks]


def pairs(ctx, n: int, calls: int, batch: int, stream: int, msg_tag: int) -> list:
    """calls lists of batch (key index, message) pairs."""
    keys = zipf_keys(ctx, n, calls, batch, stream)
    msgs = common.messages(ctx, calls, batch, msg_tag)
    return [list(zip(k.tolist(), m)) for k, m in zip(keys, msgs)]


def run(ctx):
    from dilithium_tpu_torch import _kernels, api

    if ctx.hook:
        ctx.hook(ctx)
    prm = ctx.params
    batch, n_keys, level = prm["batch"], ctx.config["keys"], ctx.config["level"]
    p = common.ref_params(ctx.config)
    seeds = key_seeds(ctx, n_keys)
    pks, sks = api.keygen(level, seeds, device=ctx.device)
    signer = api.MultiSigner(level, sks, device=ctx.device)
    pool = pairs(ctx, n_keys, prm["distinct_calls"], batch, CALLS, common.MESSAGES)
    sample = common.sample_rows(ctx, batch, prm["sample_per_call"])
    kept, short = [], [0]

    def call(i):
        items = pool[i % len(pool)]
        sigs = signer.sign(items)
        if len(sigs) != batch:
            short[0] += 1
            return 0
        kept.extend((*items[r], sigs[r]) for r in sample[i % len(sample)])
        return batch

    for items in pairs(ctx, n_keys, prm["warm_calls"], batch, WARM, common.WARM):
        signer.sign(items)
    out = common.drive(ctx, call, batch, _kernels.SHAPES)
    del signer
    common.release(ctx.device)

    key_differ, ref_sks = 0, []
    for seed, pk, sk in zip(seeds, pks, sks):
        differ, _, ref_sk = common.key_check(seed, pk, sk, p)
        key_differ += differ
        ref_sks.append(ref_sk)
    by_key = defaultdict(list)
    for k, msg, sig in common.choose(ctx, kept, prm["max_checked"]):
        by_key[k].append((msg, sig))
    out.checks = {
        "key_bytes_differ": (key_differ, 0),
        "calls_short": (short[0], 0),
        "signatures_differ": (sum(common.signature_check(ctx, ref_sks[k], got, p) for k, got in by_key.items()), 0),
    }
    out.extra["checked"] = min(len(kept), prm["max_checked"])
    out.extra["checked_keys"] = len(by_key)
    return out


def control(ctx) -> None:
    """The program's MultiSigner signs with randomized signing."""
    from dilithium_tpu_torch import api

    sign = api.MultiSigner.sign
    api.MultiSigner.sign = lambda self, key_message_pairs, randomized=False: sign(self, key_message_pairs,
                                                                                  randomized=True)
