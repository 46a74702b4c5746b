"""PyTorch port, the verify path's codecs and rounding: `unpack_t1`,
`unpack_z`, `unpack_pk`, `unpack_hints`, `unpack_sig`, `highbits`,
`lowbits` and `use_hint`, equal to the JAX package's eager functions at
levels 2, 3 and 5 (their outputs recorded in `tests/jax_reference.py`), on
valid encodings and on malformed hint blocks.

Two tests, each looping over the levels inside its body."""

import numpy as np
import torch

from dilithium_tpu_torch import oracle, params
from dilithium_tpu_torch.ops import pack, rounding
from jax_reference import assert_matches_jax, jax_ref

Q = 8380417
RNG_SEED = 606


def _hint_blocks(p, rng):
    """uint8 [rows, omega + K] hint blocks: canonical ones, then one row for
    each way to break the encoding, then random bytes."""
    K, omega = p.K, p.omega
    rows = []
    for weight in (0, 1, omega // 2, omega):
        h = np.zeros((K, 256), dtype=np.uint8)
        h.reshape(-1)[rng.choice(K * 256, weight, replace=False)] = 1
        rows.append(pack.pack_hints(torch.from_numpy(h), p).numpy())
    # a canonical block with two hints in poly 0, two in poly 1, room left
    base = np.zeros(omega + K, dtype=np.uint8)
    base[:4] = [3, 200, 5, 17]
    base[omega:] = 4
    base[omega] = 2
    rows.append(base)
    bad = []
    b = base.copy(); b[omega] = 5; bad.append(b)  # count 0 > count 1: decreasing
    b = base.copy(); b[omega + K - 1] = omega + 1; bad.append(b)  # last count above omega
    b = base.copy(); b[omega:] = 255; bad.append(b)  # every count above omega
    b = base.copy(); b[1] = 3; bad.append(b)  # repeated position in poly 0
    b = base.copy(); b[:2] = [200, 3]; bad.append(b)  # decreasing position in poly 0
    b = base.copy(); b[3] = 5; bad.append(b)  # repeated position in poly 1
    b = base.copy(); b[omega - 1] = 255; bad.append(b)  # junk in the padding
    b = base.copy(); b[4] = 1; bad.append(b)  # junk right after the last hint
    b = base.copy(); b[1] = 3; b[omega - 1] = 9; b[omega] = 7; bad.append(b)  # several faults
    b = base.copy(); b[omega + 1] = 1; bad.append(b)  # count 1 below count 0
    rand = rng.integers(0, 256, (6, omega + K), dtype=np.uint8)  # junk counts and positions
    small = rng.integers(0, 256, (6, omega + K), dtype=np.uint8)
    small[:, omega:] = rng.integers(0, omega + 2, (6, K))  # unsorted counts near omega
    return np.concatenate([np.stack(rows), np.stack(bad), rand, small])


def _unpack_inputs(level):
    """Encodings to unpack: oracle-made public keys and signatures beside
    random bytes, the hint blocks of `_hint_blocks`, and signatures that
    carry them. -> {"pks", "t1b", "zb", "hints", "sigs"} uint8."""
    p = params.get_params(level)
    rng = np.random.default_rng(RNG_SEED + level)
    pk_o, sk_o = oracle.keygen(level, rng.integers(0, 256, (2, 32), dtype=np.uint8))
    mus = rng.integers(0, 256, (2, 64), dtype=np.uint8)
    sig_o, _ = oracle.sign(level, sk_o, mus)
    pks = np.concatenate([pk_o, rng.integers(0, 256, (2, p.pk_bytes), dtype=np.uint8)])
    zb = rng.integers(0, 256, (3, p.L, p.polyz_packedbytes), dtype=np.uint8)
    zb[0] = 0  # z = gamma1 everywhere, the top of the range
    hints = _hint_blocks(p, rng)
    sigs = np.repeat(sig_o[:1], len(hints), axis=0)
    sigs[:, -(p.omega + p.K):] = hints
    sigs = np.concatenate([sig_o, sigs, rng.integers(0, 256, (2, p.sig_bytes), dtype=np.uint8)])
    return {"pks": pks, "t1b": pks[:, 32:].reshape(-1, p.K, 320), "zb": zb, "hints": hints, "sigs": sigs}


def test_unpackers_match_jax():
    """unpack_t1/z/pk/hints/sig against eager JAX: oracle-made keys and
    signatures, random bytes, and malformed hint blocks; ok and bitmaps
    equal on every row."""
    ref = jax_ref("verify_codecs_unpackers")
    for level in (2, 3, 5):
        p = params.get_params(level)
        x = _unpack_inputs(level)

        assert_matches_jax(pack.unpack_t1(torch.from_numpy(x["t1b"])), ref[f"t1 {level}"], f"t1 level {level}")
        rho, t1 = pack.unpack_pk(torch.from_numpy(x["pks"]), p)
        assert_matches_jax(rho, ref[f"pk rho {level}"], f"pk rho level {level}")
        assert_matches_jax(t1, ref[f"pk t1 {level}"], f"pk t1 level {level}")
        assert t1.dtype == torch.int32

        z = pack.unpack_z(torch.from_numpy(x["zb"]), p)
        assert z.dtype == torch.int32 and int(z.min()) >= 0 and int(z.max()) < Q
        assert_matches_jax(z, ref[f"z {level}"], f"z level {level}")

        hints = x["hints"]
        h, ok = pack.unpack_hints(torch.from_numpy(hints), p)
        assert h.dtype == torch.uint8 and ok.dtype == torch.bool
        assert_matches_jax(ok, ref[f"hints ok {level}"], f"hints ok level {level}")
        assert_matches_jax(h, ref[f"hints bitmap {level}"], f"hints bitmap level {level}")
        assert bool(ok[:5].all()) and not bool(ok[5:15].any()), ok
        for row in hints[:4]:  # canonical blocks round-trip
            hh, _ = pack.unpack_hints(torch.from_numpy(row), p)
            np.testing.assert_array_equal(pack.pack_hints(hh, p).numpy(), row,
                                          err_msg=f"hint round trip level {level}")

        got = pack.unpack_sig(torch.from_numpy(x["sigs"]), p)
        for name, g in zip(("c_tilde", "z", "h", "ok"), got):
            assert_matches_jax(g, ref[f"sig {name} {level}"], f"sig {name} level {level}")
        assert bool(got[3][:2].all())


def _rounding_inputs(p, rng):
    """Canonical a: 0, q-1, (q-1)/2 and its neighbours, every multiple of
    2*gamma2 below q and its neighbours, and random values."""
    g2 = 2 * p.gamma2
    mult = np.arange(0, Q, g2, dtype=np.int64)
    edges = np.concatenate([[0, 1, Q - 2, Q - 1, (Q - 1) // 2, (Q + 1) // 2],
                            mult, mult + 1, mult - 1, mult + p.gamma2, mult + p.gamma2 + 1,
                            mult - p.gamma2])
    edges = edges[(edges >= 0) & (edges < Q)]
    return np.concatenate([edges, rng.integers(0, Q, 4000)]).astype(np.int32)


def _use_hint_inputs(level):
    """-> (a int32: `_rounding_inputs` twice, h uint8: all ones, then
    random bits)."""
    p = params.get_params(level)
    rng = np.random.default_rng(RNG_SEED + 10 + level)
    a = _rounding_inputs(p, rng)
    h = np.concatenate([np.ones(len(a), np.uint8), rng.integers(0, 2, len(a), dtype=np.uint8)])
    return np.concatenate([a, a]), h


def test_rounding_matches_jax():
    """highbits, lowbits and use_hint against eager JAX at levels 2, 3 and
    5, at the boundaries, with both of use_hint's wraps exercised."""
    ref = jax_ref("verify_codecs_rounding")
    for level in (2, 3, 5):
        p = params.get_params(level)
        a2, h = _use_hint_inputs(level)
        at = torch.from_numpy(a2)
        hi, lo = rounding.highbits(at, p), rounding.lowbits(at, p)
        assert_matches_jax(hi, ref[f"highbits {level}"], f"highbits level {level}")
        assert_matches_jax(lo, ref[f"lowbits {level}"], f"lowbits level {level}")
        w1 = rounding.use_hint(torch.from_numpy(h), at, p)
        assert_matches_jax(w1, ref[f"use_hint {level}"], f"use_hint level {level}")
        top = 15 if p.gamma2 == (Q - 1) // 32 else 43
        hit = h.astype(bool)
        up_wrap = hit & (hi.numpy() == top) & (lo.numpy() > 0)
        dn_wrap = hit & (hi.numpy() == 0) & (lo.numpy() <= 0)
        assert up_wrap.any() and dn_wrap.any(), f"level {level}: a wrap is not exercised"
        assert (w1.numpy()[up_wrap] == 0).all() and (w1.numpy()[dn_wrap] == top).all()
