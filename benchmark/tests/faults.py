"""Faults planted in the program under a run (hooks of `run_cell`, called
first in every process of the run), for the tests that `correct` comes
out false. Each patches the program in the process it runs in."""

import sys
import types

import torch

from dilithium_tpu_torch import api, mxu, scheme
from dilithium_tpu_torch.ops import pack
from dilithium_tpu_torch.parallel import service


def altered_answers(ctx) -> None:
    """Every signature leaves the packer with a bit flipped; every
    verdict leaves verify inverted."""
    pack_sig, tail = pack.pack_sig, scheme._verify_tail

    def bad_pack(c_tilde, z, h, p):
        sig = pack_sig(c_tilde, z, h, p).clone()
        sig[..., 5] ^= 1
        return sig

    pack.pack_sig = bad_pack
    scheme._verify_tail = lambda *a: ~tail(*a)


def half_batch(ctx) -> None:
    """Only the first half of a call's batch is worked on; the rest gets
    copies of its answers."""
    sign, verify, stream = api.Signer.sign, api.Verifier.verify, mxu.sign_stream_mxu

    def half(items, fn):
        h = max(1, len(items) // 2)
        out = fn(items[:h])
        return (out * 2)[:len(items)]

    api.Signer.sign = lambda self, messages, randomized=False: half(messages, lambda m: sign(self, m, randomized))
    api.Verifier.verify = lambda self, pairs: half(pairs, lambda m: verify(self, m))

    def half_stream(ops, mu, p, window=768, max_rounds=8192, rhoprime=None):
        h = max(1, mu.shape[0] // 2)
        res = stream(ops, mu[:h], p, window, max_rounds, rhoprime)

        def fill(t):
            return torch.cat([t, t[:mu.shape[0] - h]])

        return scheme.SignResult(fill(res.sig), fill(res.attempts), fill(res.ok), res.rounds)

    mxu.sign_stream_mxu = half_stream


def stale_answers(ctx) -> None:
    """After its first call, a service returns that call's answers again."""
    sign, verify, stream = api.Signer.sign, api.Verifier.verify, mxu.sign_stream_mxu
    first = {}

    def once(key, fn):
        if key not in first:
            first[key] = fn()
        return first[key]

    api.Signer.sign = lambda self, messages, randomized=False: once("sign", lambda: sign(self, messages, randomized))
    api.Verifier.verify = lambda self, pairs: once("verify", lambda: verify(self, pairs))
    mxu.sign_stream_mxu = lambda ops, mu, p, *a, **k: once("stream", lambda: stream(ops, mu, p, *a, **k))


def all_invalid(ctx) -> None:
    """Every signature leaves the packer with a bit flipped, and verify
    rejects every pair: the verify cell's corpus, which the program signs,
    is all invalid, and the program's verdicts agree with the
    reference's."""
    altered_answers(ctx)
    api.Verifier.verify = lambda self, pairs: [False] * len(pairs)


def jax_in_rank_one(ctx) -> None:
    """Rank 1 of a run of one process a card loads a module named `jax`
    (a stub)."""
    if ctx.rank == 1:
        sys.modules.setdefault("jax", types.ModuleType("jax"))


def no_exchange(ctx) -> None:
    """The data-parallel services leave out their all-reduce: each rank's
    counters stay its own."""
    service._all_reduce = lambda mesh, *counts: tuple(c.to(device=mesh.device, dtype=torch.int64) for c in counts)


PATCHED = [(pack, "pack_sig"), (scheme, "_verify_tail"), (api.Signer, "sign"), (api.Verifier, "verify"),
           (mxu, "sign_stream_mxu"), (service, "_all_reduce")]
