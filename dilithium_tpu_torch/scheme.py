"""Key generation, signing in its NTT form, and verification.

The port of `dilithium_tpu/scheme.py`: `keygen`; the NTT-domain secret
key (`ExpandedKey`, `expand_sk`) and one signing attempt over it
(`_sign_attempt`); the lockstep signer (`sign`, `sign_expanded`: every
lane tries `attempts_per_round` kappas a round until all have accepted);
the elastic attempt-slot loop `_stream_loop` and its NTT-form signers for
one key (`sign_stream`) and for a queue that mixes keys
(`sign_stream_keys`), which `mxu.sign_stream_mxu` drives too, with the
stream signers' default windows (`default_window`); and verify,
per lane (`verify`) or under one expanded public key (`expand_pk` +
`verify_expanded`), with the epilogue `_verify_tail` that the
dense-operator verifier (`mxu.verify_mxu`) shares.

Key material is broadcast over the batch (and the lockstep signer's
attempt axis) as `expand` views and reaches only `ntt.pointwise` and
`ntt.matvec`, never a transform, so it is not copied per lane.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Tuple

import torch

from dilithium_tpu_torch import trace
from dilithium_tpu_torch.params import CRHBYTES, D, N, SEEDBYTES, TRBYTES, DilithiumParams
from dilithium_tpu_torch.ops import keccak, ntt, pack, rounding, sampling
from dilithium_tpu_torch.ops.reduce import add_mod, center, sub_mod, uncenter


class KeyPair(NamedTuple):
    pk: torch.Tensor  # uint8 [..., pk_bytes]
    sk: torch.Tensor  # uint8 [..., sk_bytes]
    rho: torch.Tensor  # uint8 [..., 32]
    key: torch.Tensor  # uint8 [..., 32]
    tr: torch.Tensor  # uint8 [..., 32]
    s1: torch.Tensor  # int32 [..., L, 256] canonical
    s2: torch.Tensor  # int32 [..., K, 256] canonical
    t0: torch.Tensor  # int32 [..., K, 256] centered
    t1: torch.Tensor  # int32 [..., K, 256]
    ok: torch.Tensor  # bool [...]: the samplers' budgets sufficed


def keygen(seed: torch.Tensor, p: DilithiumParams) -> KeyPair:
    """Dilithium KeyGen from seed uint8 [..., 32]: (rho, sigma, K) =
    SHAKE256(seed, 128); A = ExpandA(rho); (s1, s2) = ExpandS(sigma);
    t = INTT(A_hat . NTT(s1)) + s2; (t1, t0) = Power2Round(t);
    tr = SHAKE256(pk, 32)."""
    seedbuf = keccak.shake256(seed, 2 * SEEDBYTES + CRHBYTES)
    rho = seedbuf[..., :SEEDBYTES]
    sigma = seedbuf[..., SEEDBYTES:SEEDBYTES + CRHBYTES]
    key = seedbuf[..., SEEDBYTES + CRHBYTES:]

    a_hat, ok_a = sampling.expand_a(rho, p, max_skips=8)
    s12, ok_s = sampling.expand_s(sigma, 0, p.L + p.K, p)
    s1, s2 = s12[..., :p.L, :], s12[..., p.L:, :]

    t = ntt.invntt(ntt.matvec(a_hat, ntt.ntt(s1)), from_product=True)
    t1, t0 = rounding.power2round(add_mod(t, s2))

    pk = pack.pack_pk(rho, t1, p)
    tr = keccak.shake256(pk, TRBYTES)
    sk = pack.pack_sk(rho, key, tr, s1, s2, t0, p)
    return KeyPair(pk, sk, rho, key, tr, s1, s2, t0, t1, ok_a & ok_s)


class SignResult(NamedTuple):
    sig: torch.Tensor  # uint8 [Q, sig_bytes]
    attempts: torch.Tensor  # int32 [Q]: attempts used (1 = first try)
    ok: torch.Tensor  # bool [Q]: signed within max_rounds
    rounds: int  # rounds the loop ran


def validate_rhoprime(rhoprime: torch.Tensor, expected_shape: Tuple[int, ...]) -> None:
    """Reject a rhoprime that is not exactly one per message.

    y depends only on (rhoprime, kappa): two messages accepting at the same
    kappa under a shared rhoprime leak s1 = (z1 - z2) / (c1 - c2)."""
    if tuple(rhoprime.shape) != tuple(expected_shape):
        raise ValueError(
            f"rhoprime must be per-message, shape {tuple(expected_shape)}; "
            f"got {tuple(rhoprime.shape)}"
        )
    if rhoprime.dtype != torch.uint8:
        raise ValueError(f"rhoprime must be uint8 bytes; got dtype {rhoprime.dtype}")


def _rhoprime(key: torch.Tensor, mu: torch.Tensor, rhoprime: torch.Tensor | None) -> torch.Tensor:
    """rhoprime uint8 [..., 64] for mu uint8 [..., 64] under key rows uint8
    [..., 32]: SHAKE256(key || mu, 64) for deterministic signing, or the
    caller's (randomized signing), checked to be one a message."""
    if rhoprime is None:
        return keccak.shake256(torch.cat([key, mu], dim=-1), CRHBYTES)
    validate_rhoprime(rhoprime, tuple(mu.shape))
    return rhoprime


class ExpandedKey(NamedTuple):
    """NTT-domain secret-key material, computed once a key (or once for
    each row of a leading key axis)."""
    a_hat: torch.Tensor  # int32 [..., K, L, 256]
    s1_hat: torch.Tensor  # int32 [..., L, 256]
    s2_hat: torch.Tensor  # int32 [..., K, 256]
    t0_hat: torch.Tensor  # int32 [..., K, 256] = NTT(t0, canonical)
    key: torch.Tensor  # uint8 [..., 32]
    tr: torch.Tensor  # uint8 [..., 32]


def expand_sk(sk: torch.Tensor, p: DilithiumParams) -> ExpandedKey:
    """Unpack sk uint8 [..., sk_bytes] and precompute its NTT-domain
    material. Raises when ExpandA's candidate budget runs out (the JAX
    package checks this only under DILITHIUM_DEBUG_CHECKS)."""
    rho, key, tr, s1, s2, t0 = pack.unpack_sk(sk, p)
    a_hat, ok_a = sampling.expand_a(rho, p)
    if not bool(ok_a.all()):
        raise RuntimeError("ExpandA's candidate budget ran out for a key")
    return ExpandedKey(a_hat, ntt.ntt(s1), ntt.ntt(s2), ntt.ntt(uncenter(t0)), key, tr)


def _sign_attempt(a_hat, s1_hat, s2_hat, t0_hat, mu, rhoprime, kappa, p: DilithiumParams):
    """One candidate signature per lane for nonce kappa, in the NTT form:
    y -> w -> c -> z with the four rejection tests, 2L + 3K + 1 NTTs a
    lane. Key material int32 broadcastable to the lanes (a_hat [..., K, L,
    256], s1_hat [..., L, 256], s2_hat and t0_hat [..., K, 256]); mu and
    rhoprime uint8 [..., 64]; kappa int [...] -> (c_tilde uint8 [..., 32],
    z int32 [..., L, 256] canonical, h uint8 [..., K, 256], accept bool
    [...])."""
    batch = mu.shape[:-1]
    y = sampling.expand_mask(rhoprime, kappa, p)
    w = ntt.invntt(ntt.matvec(a_hat, ntt.ntt(y)))
    w1, w0 = rounding.decompose(w, p)
    w1_packed = pack.pack_w1(w1, p).reshape(batch + (p.K * p.polyw1_packedbytes,))
    c_tilde = keccak.shake256(torch.cat([mu, w1_packed], dim=-1), SEEDBYTES)
    c, ok_ball = sampling.sample_in_ball(c_tilde.reshape(-1, SEEDBYTES), p)
    c_hat = ntt.ntt(c).reshape(batch + (1, N))  # pointwise's first operand: the one it widens

    z = add_mod(y, ntt.invntt(ntt.pointwise(c_hat, s1_hat)))
    w0_cs2 = w0 - center(ntt.invntt(ntt.pointwise(c_hat, s2_hat)))
    ct0 = center(ntt.invntt(ntt.pointwise(c_hat, t0_hat)))
    h = rounding.make_hint(w0_cs2 + ct0, w1, p)
    reject = (
        rounding.norm_exceeds(center(z), p.gamma1 - p.beta, dim=(-2, -1))
        | rounding.norm_exceeds(w0_cs2, p.gamma2 - p.beta, dim=(-2, -1))
        | rounding.norm_exceeds(ct0, p.gamma2, dim=(-2, -1))
        | (h.sum(dim=(-2, -1), dtype=torch.int32) > p.omega)
    )
    return c_tilde, z, h, ~reject & ok_ball.reshape(batch)


def sign(sk: torch.Tensor, mu: torch.Tensor, p: DilithiumParams, attempts_per_round: int = 4,
         max_rounds: int = 64, rhoprime: torch.Tensor | None = None) -> SignResult:
    """Dilithium sign: sk uint8 [..., sk_bytes], mu uint8 [..., 64] ->
    SignResult [...], through `expand_sk` and the lockstep
    `sign_expanded`. Deterministic by default (rhoprime = SHAKE256(key ||
    mu, 64)); pass uniformly random rhoprime uint8 [..., 64] for
    randomized signing."""
    return sign_expanded(expand_sk(sk, p), mu, p, attempts_per_round, max_rounds, rhoprime)


def sign_expanded(ek: ExpandedKey, mu: torch.Tensor, p: DilithiumParams, attempts_per_round: int = 4,
                  max_rounds: int = 64, rhoprime: torch.Tensor | None = None) -> SignResult:
    """Sign mu uint8 [..., 64] in lockstep under an ExpandedKey that is
    unbatched (one key for every lane) or batched like mu.

    Each round, every lane tries A = attempts_per_round kappas (kappa +
    a*L for a < A) and commits its lowest accepting one, so bytes and
    attempts equal the serial signer's. The loop ends when every lane has
    accepted, read with one host sync a round, or after max_rounds rounds
    (ok is False for the lanes left). The signatures are packed once,
    after the loop."""
    batch = tuple(mu.shape[:-1])
    B = math.prod(batch)
    A = attempts_per_round
    dev = mu.device

    def lanes(x, core):  # key material -> a [B, A, ...] view, never copied
        shape = tuple(x.shape[x.dim() - core:])
        return x.expand(batch + shape).reshape((B,) + shape).unsqueeze(1).expand((B, A) + shape)

    a_hat, s1_hat, s2_hat, t0_hat = (lanes(x, core) for x, core in zip(ek[:4], (3, 2, 2, 2)))
    rhoprime = _rhoprime(ek.key.expand(batch + (SEEDBYTES,)), mu, rhoprime)
    mu_r = mu.reshape(B, CRHBYTES).unsqueeze(1).expand(B, A, CRHBYTES)
    rp_r = rhoprime.reshape(B, CRHBYTES).unsqueeze(1).expand(B, A, CRHBYTES)
    steps = torch.arange(A, device=dev)
    rows = torch.arange(B, device=dev)

    done = torch.zeros(B, dtype=torch.bool, device=dev)
    kappa = torch.zeros(B, dtype=torch.int64, device=dev)
    attempts = torch.zeros(B, dtype=torch.int32, device=dev)
    ct_out = torch.zeros((B, SEEDBYTES), dtype=torch.uint8, device=dev)
    z_out = torch.zeros((B, p.L, N), dtype=torch.int32, device=dev)
    h_out = torch.zeros((B, p.K, N), dtype=torch.uint8, device=dev)
    rounds, all_done = 0, B == 0
    while rounds < max_rounds and not all_done:
        with trace.span("scheme.round"):
            c_tilde, z, h, accept = _sign_attempt(a_hat, s1_hat, s2_hat, t0_hat, mu_r, rp_r,
                                                  kappa.unsqueeze(1) + steps * p.L, p)
            first = torch.where(accept, steps, A).amin(dim=1)  # A where no attempt accepted
            sel = first.clamp(max=A - 1)
            newly = (first < A) & ~done
            ct_out = torch.where(newly[:, None], c_tilde[rows, sel], ct_out)
            z_out = torch.where(newly[:, None, None], z[rows, sel], z_out)
            h_out = torch.where(newly[:, None, None], h[rows, sel], h_out)
            attempts = torch.where(newly, attempts + first.to(torch.int32) + 1,
                                   torch.where(done, attempts, attempts + A))
            kappa = torch.where(done | newly, kappa, kappa + A * p.L)
            done = done | newly
            rounds += 1
            with trace.span("scheme.sync"):
                all_done = bool(done.all())  # the round's one host sync
    sig = pack.pack_sig(ct_out, z_out, h_out, p)
    _count_rounds(rounds, B * A, attempts)
    return SignResult(sig.reshape(batch + (p.sig_bytes,)), attempts.reshape(batch), done.reshape(batch), rounds)


def _count_rounds(rounds: int, slots: int, attempts: torch.Tensor) -> None:
    """The loop's counters, while a profiler records: its rounds, the
    attempt slots it ran (slots a round each round) and the attempts its
    items needed (one reduction and one host read)."""
    if trace.recording():
        trace.count("scheme.rounds", rounds)
        trace.count("scheme.slots", rounds * slots)
        trace.count("scheme.attempts", int(attempts.sum()))


# Attempt slots a round where the caller names no window, by level. The
# round's host dispatch hardly depends on W, so a wider window runs fewer
# rounds until the device's work a round outlasts it. Set from a sweep of
# 16384-message queues on one H100 (PERF.md, section 6), in which the
# dense, the one-key NTT-form and the keyed NTT-form attempts were
# fastest at the same W at each level.
DEFAULT_WINDOWS = {2: 8192, 3: 8192, 5: 6144}


def default_window(p: DilithiumParams) -> int:
    """The attempt slots a round that every stream signer runs at p's
    level when it is given window=None (`DEFAULT_WINDOWS`). A call runs
    min(window, Q) slots."""
    return DEFAULT_WINDOWS[p.level]


def _slots(window: int | None, p: DilithiumParams, n: int) -> int:
    """W = min(window, n), window None taking `default_window`."""
    return min(default_window(p) if window is None else window, n)


AttemptFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
                     Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]]


def _stream_loop(attempt_fn: AttemptFn, mu: torch.Tensor, rhoprime: torch.Tensor,
                 p: DilithiumParams, W: int, max_rounds: int) -> SignResult:
    """Elastic attempt-slot loop: W slots per round over the active items.

    attempt_fn(mu_s uint8 [W, 64], rp_s uint8 [W, 64], kappa_s int32 [W],
    q_s int64 [W] clamped queue index) -> (c_tilde uint8 [W, 32], z int32
    [W, L, 256], h uint8 [W, K, 256], accept bool [W]).

    While every slot serves its own item (n_active == W) the slot map is
    the identity; in the drain, slot s serves item s % n_active at attempt
    index s // n_active, so idle slots try the remaining items' next
    kappas. Each item's kappa starts at 0 and advances by L per attempt,
    and its lowest accepting attempt is committed, so bytes and attempts
    equal the serial signer's however attempts are packed into slots.

    Bookkeeping stays on the device; the host reads n_active once per
    round. Committed payloads go straight to their queue rows with
    index_copy_ (row Q of each output is a scratch row for the slots that
    commit nothing).
    """
    Q = mu.shape[0]
    L = p.L
    dev = mu.device
    BIG = 1 << 20
    slots = torch.arange(W, device=dev)
    zeros_w = torch.zeros(W, dtype=torch.int64, device=dev)

    ct_out = torch.zeros((Q + 1, SEEDBYTES), dtype=torch.uint8, device=dev)
    z_out = torch.zeros((Q + 1, L, N), dtype=torch.int32, device=dev)
    h_out = torch.zeros((Q + 1, p.K, N), dtype=torch.uint8, device=dev)
    att_out = torch.zeros(Q + 1, dtype=torch.int32, device=dev)

    nxt = torch.tensor(W, device=dev)
    qidx = slots.clone()  # item -> queue index (Q = none)
    kappa = zeros_w.clone()  # item -> next kappa
    rounds, na = 0, W
    while rounds < max_rounds and na > 0:
        with trace.span("scheme.round"):
            steady = na == W
            if steady:
                q_s, kap_s, item, t = qidx, kappa, slots, zeros_w
            else:
                item, t = slots % na, slots // na
                q_s, kap_s = qidx[item], kappa[item] + t * L
            safe = q_s.clamp(max=Q - 1)
            c_tilde, z, h, accept = attempt_fn(mu[safe], rhoprime[safe], kap_s.to(torch.int32), safe)
            accept = accept & (q_s < Q)

            # elastic commit: per item, its lowest accepting attempt index
            win_t = torch.full((W,), BIG, device=dev).scatter_reduce(
                0, item, torch.where(accept, t, BIG), reduce="amin")
            committed = win_t < BIG
            won_t = torch.where(committed, win_t, 0)
            win_slot = (slots + na * won_t).clamp(max=W - 1)
            tgt = torch.where(committed, qidx, Q)
            att_val = kappa // L + won_t + 1
            # survivors advance kappa by their slot count, move to the front,
            # and fresh queue items fill the tail
            n_slots = W // na + (slots < W % na).to(torch.int64)
            alive = (slots < na) & ~committed
            alive_i = alive.to(torch.int64)
            n_surv = alive_i.sum()
            pos = torch.where(alive, torch.cumsum(alive_i, 0) - alive_i, W)
            qidx_new = torch.full((W + 1,), Q, device=dev).scatter(0, pos, qidx)[:W]
            kappa_new = torch.zeros(W + 1, dtype=torch.int64, device=dev).scatter(
                0, pos, kappa + n_slots * L)[:W]
            fresh = nxt + slots - n_surv
            take_fresh = (slots >= n_surv) & (fresh < Q)
            qidx_new = torch.where(take_fresh, fresh, qidx_new)
            kappa_new = torch.where(take_fresh, 0, kappa_new)
            n_fresh = take_fresh.sum()
            n_active_new, nxt_new = n_surv + n_fresh, nxt + n_fresh

            if steady:
                # steady commit (slot == item, refill in place), taken when the
                # queue covers every refill this round
                acc_i = accept.to(torch.int64)
                n_acc = acc_i.sum()
                use = nxt + n_acc <= Q
                committed = torch.where(use, accept, committed)
                win_slot = torch.where(use, slots, win_slot)
                tgt = torch.where(use, torch.where(accept, qidx, Q), tgt)
                att_val = torch.where(use, kappa // L + 1, att_val)
                qidx_new = torch.where(use, torch.where(accept, nxt + torch.cumsum(acc_i, 0) - acc_i, qidx), qidx_new)
                kappa_new = torch.where(use, torch.where(accept, 0, kappa + L), kappa_new)
                n_active_new = torch.where(use, W, n_active_new)
                nxt_new = torch.where(use, nxt + n_acc, nxt_new)

            ct_out.index_copy_(0, tgt, c_tilde[win_slot])
            z_out.index_copy_(0, tgt, z[win_slot])
            h_out.index_copy_(0, tgt, h[win_slot])
            att_out.index_copy_(0, tgt, att_val.to(torch.int32))
            n_active, nxt, qidx, kappa = n_active_new, nxt_new, qidx_new, kappa_new
            rounds += 1
            with trace.span("scheme.sync"):
                na = int(n_active)  # the round's one host sync

    sig = pack.pack_sig(ct_out[:Q], z_out[:Q], h_out[:Q], p)
    attempts = att_out[:Q]
    _count_rounds(rounds, W, attempts)
    return SignResult(sig, attempts, attempts > 0, rounds)


def sign_stream(ek: ExpandedKey, mu: torch.Tensor, p: DilithiumParams, window: int | None = None,
                max_rounds: int = 4096, rhoprime: torch.Tensor | None = None) -> SignResult:
    """Sign a queue mu uint8 [Q, 64] under one unbatched ExpandedKey with
    the elastic stream loop over W = min(window, Q) attempt slots, each
    running `_sign_attempt`; window None is the level's
    `default_window(p)`. Deterministic by default; pass
    uniformly random rhoprime uint8 [Q, 64] for randomized signing."""
    n = mu.shape[0]
    rhoprime = _rhoprime(ek.key.expand(n, SEEDBYTES), mu, rhoprime)

    def attempt(mu_s, rp_s, kappa_s, q_s):
        del q_s  # one key: the material is slot-invariant
        return _sign_attempt(ek.a_hat, ek.s1_hat, ek.s2_hat, ek.t0_hat, mu_s, rp_s, kappa_s, p)

    return _stream_loop(attempt, mu, rhoprime, p, _slots(window, p, n), max_rounds)


def sign_stream_keys(eks: ExpandedKey, key_idx: torch.Tensor, mu: torch.Tensor, p: DilithiumParams,
                     window: int | None = None, max_rounds: int = 8192,
                     rhoprime: torch.Tensor | None = None) -> SignResult:
    """Sign a queue mu uint8 [Q, 64] that mixes keys: eks holds the keys
    on a leading axis [Nk, ...] (`expand_sk` of a batched sk) and key_idx
    int [Q] names each message's row. Each attempt slot gathers its
    message's key material, so keys mix freely in one elastic window of
    W = min(window, Q) slots (window None: `default_window(p)`)
    and every message's bytes and attempts equal `sign`'s under its key."""
    n = mu.shape[0]
    if tuple(key_idx.shape) != (n,):
        raise ValueError(f"key_idx must have shape ({n},); got {tuple(key_idx.shape)}")
    with trace.span("scheme.sign_stream_keys"):
        key_idx = key_idx.to(torch.int64)
        n_keys = eks.key.shape[0]
        if n and not bool(((key_idx >= 0) & (key_idx < n_keys)).all()):
            raise IndexError(f"key index out of range 0..{n_keys - 1}")
        rhoprime = _rhoprime(eks.key[key_idx], mu, rhoprime)

        def attempt(mu_s, rp_s, kappa_s, q_s):
            with trace.span("scheme.gather"):  # each slot's own key material
                k = key_idx[q_s]
                a_hat, s1_hat, s2_hat, t0_hat = eks.a_hat[k], eks.s1_hat[k], eks.s2_hat[k], eks.t0_hat[k]
            return _sign_attempt(a_hat, s1_hat, s2_hat, t0_hat, mu_s, rp_s, kappa_s, p)

        return _stream_loop(attempt, mu, rhoprime, p, _slots(window, p, n), max_rounds)


def _verify_tail(w, h, c_tilde, mu, pre_ok, p: DilithiumParams) -> torch.Tensor:
    """The verify epilogue: w' int32 [..., K, 256] canonical (however it was
    computed) -> w1' = UseHint(h, w') -> accept iff c_tilde ==
    SHAKE256(mu || pack(w1'), 32) and pre_ok."""
    w1 = rounding.use_hint(h, w, p)
    w1_packed = pack.pack_w1(w1, p).reshape(w1.shape[:-2] + (p.K * p.polyw1_packedbytes,))
    c_tilde2 = keccak.shake256(torch.cat([mu, w1_packed], dim=-1), SEEDBYTES)
    return pre_ok & (c_tilde == c_tilde2).all(dim=-1)


def _verify_core(a_hat, t1_hat, sig, mu, p: DilithiumParams) -> torch.Tensor:
    """Verify against NTT-domain key material broadcast to the batch:
    w' = INTT(A_hat . NTT(z) - NTT(c) . t1_hat). SampleInBall's ok is
    discarded, as in the JAX package."""
    c_tilde, z, h, h_ok = pack.unpack_sig(sig, p)
    z_ok = ~rounding.norm_exceeds(center(z), p.gamma1 - p.beta, dim=(-2, -1))
    c, _ = sampling.sample_in_ball(c_tilde.reshape(-1, SEEDBYTES), p)
    c_hat = ntt.ntt(c.reshape(c_tilde.shape[:-1] + (N,)))
    z_hat = ntt.ntt(z)
    az = ntt.matvec(a_hat, z_hat)  # carries R^-1
    ct1 = ntt.pointwise(c_hat.unsqueeze(-2), t1_hat)  # carries R^-1
    w = ntt.invntt(sub_mod(az, ct1), from_product=True)
    return _verify_tail(w, h, c_tilde, mu, z_ok & h_ok, p)


def verify(pk: torch.Tensor, sig: torch.Tensor, mu: torch.Tensor, p: DilithiumParams) -> torch.Tensor:
    """Dilithium verify with a key per lane: pk uint8 [..., pk_bytes], sig
    uint8 [..., sig_bytes], mu uint8 [..., 64] -> bool [...]. Expands A for
    every lane; a one-key service uses `expand_pk` + `verify_expanded` or
    `mxu.verify_mxu`. ExpandA's ok is not checked, as in the JAX package."""
    with trace.span("scheme.verify"):
        rho, t1 = pack.unpack_pk(pk, p)
        a_hat, _ = sampling.expand_a(rho, p)
        t1_hat = ntt.ntt(t1 << D)  # t1 * 2^13 <= q - 1 stays canonical
        return _verify_core(a_hat, t1_hat, sig, mu, p)


class ExpandedPk(NamedTuple):
    """NTT-domain public-key material, computed once a key."""
    a_hat: torch.Tensor  # int32 [..., K, L, 256]
    t1_hat: torch.Tensor  # int32 [..., K, 256] = NTT(t1 << d)
    tr: torch.Tensor  # uint8 [..., 32]


def expand_pk(pk: torch.Tensor, p: DilithiumParams) -> ExpandedPk:
    """Unpack pk uint8 [..., pk_bytes] and precompute its NTT-domain
    material. Raises when ExpandA's candidate budget runs out (the JAX
    package checks this only under DILITHIUM_DEBUG_CHECKS)."""
    rho, t1 = pack.unpack_pk(pk, p)
    a_hat, ok_a = sampling.expand_a(rho, p)
    if not bool(ok_a.all()):
        raise RuntimeError("ExpandA's candidate budget ran out for this key")
    return ExpandedPk(a_hat, ntt.ntt(t1 << D), keccak.shake256(pk, TRBYTES))


def verify_expanded(epk: ExpandedPk, sig: torch.Tensor, mu: torch.Tensor,
                    p: DilithiumParams) -> torch.Tensor:
    """Verify a batch sig uint8 [..., sig_bytes], mu uint8 [..., 64] under
    one unbatched ExpandedPk -> bool [...]. The key material is broadcast
    as a view, never copied per lane."""
    with trace.span("scheme.verify"):
        batch = mu.shape[:-1]
        a_hat = epk.a_hat.expand(batch + epk.a_hat.shape)
        t1_hat = epk.t1_hat.expand(batch + epk.t1_hat.shape)
        return _verify_core(a_hat, t1_hat, sig, mu, p)
