"""PyTorch port, the verify path's codecs and rounding: `unpack_t1`,
`unpack_z`, `unpack_pk`, `unpack_hints`, `unpack_sig`, `highbits`,
`lowbits` and `use_hint`, equal to the JAX package's eager functions at
levels 2, 3 and 5, on valid encodings and on malformed hint blocks.

Two tests, each looping over the levels inside its body."""

import numpy as np
import jax.numpy as jnp
import torch

from dilithium_tpu import params as jparams
from dilithium_tpu.ops import pack as jpack
from dilithium_tpu.ops import rounding as jrounding
from dilithium_tpu_torch import oracle, params
from dilithium_tpu_torch.ops import pack, rounding

Q = 8380417
RNG_SEED = 606


def _eq(got: torch.Tensor, exp, what: str):
    np.testing.assert_array_equal(got.numpy().astype(np.int64), np.asarray(exp).astype(np.int64),
                                  err_msg=what)


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


def test_unpackers_match_jax():
    """unpack_t1/z/pk/hints/sig against eager JAX: oracle-made keys and
    signatures, random bytes, and malformed hint blocks; ok and bitmaps
    equal on every row."""
    for level in (2, 3, 5):
        p, jp = params.get_params(level), jparams.get_params(level)
        rng = np.random.default_rng(RNG_SEED + level)
        pk_o, sk_o = oracle.keygen(level, rng.integers(0, 256, (2, 32), dtype=np.uint8))
        mus = rng.integers(0, 256, (2, 64), dtype=np.uint8)
        sig_o, _ = oracle.sign(level, sk_o, mus)
        pks = np.concatenate([pk_o, rng.integers(0, 256, (2, p.pk_bytes), dtype=np.uint8)])

        t1b = pks[:, 32:].reshape(-1, p.K, 320)
        _eq(pack.unpack_t1(torch.from_numpy(t1b)), jpack.unpack_t1(jnp.asarray(t1b)), f"t1 level {level}")
        rho, t1 = pack.unpack_pk(torch.from_numpy(pks), p)
        rho_j, t1_j = jpack.unpack_pk(jnp.asarray(pks), jp)
        _eq(rho, rho_j, f"pk rho level {level}")
        _eq(t1, t1_j, f"pk t1 level {level}")
        assert t1.dtype == torch.int32

        zb = rng.integers(0, 256, (3, p.L, p.polyz_packedbytes), dtype=np.uint8)
        zb[0] = 0  # z = gamma1 everywhere, the top of the range
        z = pack.unpack_z(torch.from_numpy(zb), p)
        assert z.dtype == torch.int32 and int(z.min()) >= 0 and int(z.max()) < Q
        _eq(z, jpack.unpack_z(jnp.asarray(zb), jp), f"z level {level}")

        hints = _hint_blocks(p, rng)
        h, ok = pack.unpack_hints(torch.from_numpy(hints), p)
        h_j, ok_j = jpack.unpack_hints(jnp.asarray(hints), jp)
        assert h.dtype == torch.uint8 and ok.dtype == torch.bool
        _eq(ok, ok_j, f"hints ok level {level}")
        _eq(h, h_j, f"hints bitmap level {level}")
        assert bool(ok[:5].all()) and not bool(ok[5:15].any()), ok
        for row in hints[:4]:  # canonical blocks round-trip
            hh, _ = pack.unpack_hints(torch.from_numpy(row), p)
            _eq(pack.pack_hints(hh, p), row, f"hint round trip level {level}")

        sigs = np.repeat(sig_o[:1], len(hints), axis=0)
        sigs[:, -(p.omega + p.K):] = hints
        sigs = np.concatenate([sig_o, sigs, rng.integers(0, 256, (2, p.sig_bytes), dtype=np.uint8)])
        got = pack.unpack_sig(torch.from_numpy(sigs), p)
        exp = jpack.unpack_sig(jnp.asarray(sigs), jp)
        for name, g, e in zip(("c_tilde", "z", "h", "ok"), got, exp):
            _eq(g, e, f"sig {name} level {level}")
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


def test_rounding_matches_jax():
    """highbits, lowbits and use_hint against eager JAX at levels 2, 3 and
    5, at the boundaries, with both of use_hint's wraps exercised."""
    for level in (2, 3, 5):
        p, jp = params.get_params(level), jparams.get_params(level)
        rng = np.random.default_rng(RNG_SEED + 10 + level)
        a = _rounding_inputs(p, rng)
        a2 = np.concatenate([a, a])
        h = np.concatenate([np.ones(len(a), np.uint8), rng.integers(0, 2, len(a), dtype=np.uint8)])
        at, aj = torch.from_numpy(a2), jnp.asarray(a2.astype(np.uint32))
        hi, lo = rounding.highbits(at, p), rounding.lowbits(at, p)
        _eq(hi, jrounding.highbits(aj, jp), f"highbits level {level}")
        _eq(lo, jrounding.lowbits(aj, jp), f"lowbits level {level}")
        w1 = rounding.use_hint(torch.from_numpy(h), at, p)
        _eq(w1, jrounding.use_hint(jnp.asarray(h.astype(np.uint32)), aj, jp), f"use_hint level {level}")
        top = 15 if p.gamma2 == (Q - 1) // 32 else 43
        hit = h.astype(bool)
        up_wrap = hit & (hi.numpy() == top) & (lo.numpy() > 0)
        dn_wrap = hit & (hi.numpy() == 0) & (lo.numpy() <= 0)
        assert up_wrap.any() and dn_wrap.any(), f"level {level}: a wrap is not exercised"
        assert (w1.numpy()[up_wrap] == 0).all() and (w1.numpy()[dn_wrap] == top).all()
