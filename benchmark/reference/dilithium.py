"""CRYSTALS-Dilithium, round 3 (specification v3.1), in plain NumPy and
hashlib: key generation, deterministic signing and verification at
levels 2, 3 and 5.

The benchmark's own reference. It is written from the specification and
shares no code, table or library with the program under test: its NTT
uses plain (not Montgomery) twiddles, its rejection samplers read the
SHAKE streams from `hashlib` until they have what they need, and its
SampleInBall is the specification's loop. Work that is the same for
every row (the NTTs, products, rounding and norms) is vectorized over a
leading batch axis; hashing runs one row at a time.

Byte layouts (v3.1): pk = rho || t1 (10 bits a coefficient); sk = rho ||
key || tr || s1 || s2 || t0, tr = SHAKE256(pk, 32); mu = SHAKE256(tr ||
M, 64); rhoprime = SHAKE256(key || mu, 64); sig = c_tilde (32 bytes) ||
z || h (omega indices, then K counts).
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple, Sequence

import numpy as np

Q = 8380417
N = 256
D = 13
ROOT = 1753  # a primitive 512th root of unity mod q
SEEDBYTES = 32
CRHBYTES = 64
TRBYTES = 32
SHAKE128_RATE = 168
SHAKE256_RATE = 136


class Params(NamedTuple):
    level: int
    K: int
    L: int
    eta: int
    tau: int
    gamma1: int
    gamma2: int
    omega: int

    @property
    def beta(self) -> int:
        return self.tau * self.eta

    @property
    def z_bits(self) -> int:
        return 18 if self.gamma1 == 1 << 17 else 20

    @property
    def w1_bits(self) -> int:
        return 6 if self.gamma2 == (Q - 1) // 88 else 4

    @property
    def eta_bits(self) -> int:
        return 3 if self.eta == 2 else 4

    @property
    def pk_bytes(self) -> int:
        return SEEDBYTES + self.K * N * 10 // 8

    @property
    def sk_bytes(self) -> int:
        return 2 * SEEDBYTES + TRBYTES + (self.K + self.L) * N * self.eta_bits // 8 + self.K * N * D // 8

    @property
    def sig_bytes(self) -> int:
        return SEEDBYTES + self.L * N * self.z_bits // 8 + self.omega + self.K


PARAMS = {
    2: Params(2, K=4, L=4, eta=2, tau=39, gamma1=1 << 17, gamma2=(Q - 1) // 88, omega=80),
    3: Params(3, K=6, L=5, eta=4, tau=49, gamma1=1 << 19, gamma2=(Q - 1) // 32, omega=55),
    5: Params(5, K=8, L=7, eta=2, tau=60, gamma1=1 << 19, gamma2=(Q - 1) // 32, omega=75),
}


# ---------------------------------------------------------------------------
# Arithmetic in Z_q[X] / (X^256 + 1)
# ---------------------------------------------------------------------------

def _brv8(k: int) -> int:
    return int(f"{k:08b}"[::-1], 2)


ZETAS = np.array([pow(ROOT, _brv8(k), Q) for k in range(N)], dtype=np.int64)
N_INV = pow(N, Q - 2, Q)


def ntt(a: np.ndarray) -> np.ndarray:
    """Forward NTT of polynomials int [..., 256] -> int64 [..., 256] mod q,
    in the specification's (bit-reversed) order, the domain ExpandA
    samples A_hat in."""
    shape = a.shape
    a = np.asarray(a, dtype=np.int64) % Q
    k, length = 1, 128
    while length >= 1:
        blocks = N // (2 * length)
        v = a.reshape(shape[:-1] + (blocks, 2, length))
        t = ZETAS[k:k + blocks, None] * v[..., 1, :] % Q
        a = np.stack([v[..., 0, :] + t, v[..., 0, :] - t], axis=-2).reshape(shape) % Q
        k += blocks
        length //= 2
    return a


def invntt(a: np.ndarray) -> np.ndarray:
    """Inverse of `ntt`: int [..., 256] -> int64 [..., 256] in [0, q)."""
    shape = a.shape
    a = np.asarray(a, dtype=np.int64) % Q
    k, length = N, 1
    while length < N:
        blocks = N // (2 * length)
        zeta = (Q - ZETAS[k - blocks:k][::-1]) % Q
        v = a.reshape(shape[:-1] + (blocks, 2, length))
        lo, hi = v[..., 0, :], v[..., 1, :]
        a = np.stack([(lo + hi) % Q, zeta[:, None] * ((lo - hi) % Q) % Q], axis=-2).reshape(shape)
        k -= blocks
        length *= 2
    return a * N_INV % Q


def center(a: np.ndarray) -> np.ndarray:
    """Representatives in (-(q-1)/2, (q-1)/2]."""
    a = np.asarray(a, dtype=np.int64) % Q
    return np.where(a > (Q - 1) // 2, a - Q, a)


def norm_exceeds(a: np.ndarray, bound: int) -> np.ndarray:
    """Per row (all axes after the first): some |coefficient| >= bound."""
    return (np.abs(center(a)) >= bound).reshape(a.shape[0], -1).any(axis=1)


def power2round(r: np.ndarray):
    r1 = (r + (1 << (D - 1)) - 1) >> D
    return r1, r - (r1 << D)


def decompose(r: np.ndarray, p: Params):
    """r in [0, q) -> (r1, r0) with r = r1 * 2 gamma2 + r0, the
    specification's special case r - r0 = q - 1 included."""
    alpha = 2 * p.gamma2
    r0 = r % alpha
    r0 = np.where(r0 > alpha // 2, r0 - alpha, r0)
    special = (r - r0) == Q - 1
    return np.where(special, 0, (r - r0) // alpha), np.where(special, r0 - 1, r0)


def make_hint(a0: np.ndarray, a1: np.ndarray, p: Params) -> np.ndarray:
    return ((a0 > p.gamma2) | (a0 < -p.gamma2) | ((a0 == -p.gamma2) & (a1 != 0))).astype(np.int64)


def use_hint(h: np.ndarray, r: np.ndarray, p: Params) -> np.ndarray:
    m = (Q - 1) // (2 * p.gamma2)
    r1, r0 = decompose(r, p)
    return np.where(h == 0, r1, np.where(r0 > 0, (r1 + 1) % m, (r1 - 1) % m))


# ---------------------------------------------------------------------------
# Bit packing: every field is a little-endian bit string
# ---------------------------------------------------------------------------

def pack_bits(values: np.ndarray, bits: int) -> np.ndarray:
    """uint values [..., n] below 2^bits -> uint8 [..., n * bits / 8]."""
    v = np.asarray(values, dtype=np.int64)
    planes = ((v[..., None] >> np.arange(bits)) & 1).astype(np.uint8)
    return np.packbits(planes.reshape(v.shape[:-1] + (-1,)), axis=-1, bitorder="little")


def unpack_bits(data: np.ndarray, bits: int) -> np.ndarray:
    """uint8 [..., nbytes] -> int64 [..., nbytes * 8 / bits]."""
    planes = np.unpackbits(np.asarray(data, dtype=np.uint8), axis=-1, bitorder="little")
    planes = planes.reshape(planes.shape[:-1] + (-1, bits)).astype(np.int64)
    return (planes << np.arange(bits)).sum(axis=-1)


def pack_w1(w1: np.ndarray, p: Params) -> np.ndarray:
    """w1 [B, K, 256] -> uint8 [B, K * 256 * w1_bits / 8]."""
    return pack_bits(w1.reshape(w1.shape[0], -1), p.w1_bits)


# ---------------------------------------------------------------------------
# Hashing and sampling
# ---------------------------------------------------------------------------

def shake256(data: bytes, n: int) -> bytes:
    return hashlib.shake_256(data).digest(n)


def _nonce(n: int) -> bytes:
    return (n & 0xFFFF).to_bytes(2, "little")


def expand_a(rho: bytes, p: Params) -> np.ndarray:
    """A_hat int64 [K, L, 256]: entry (i, j) from SHAKE128(rho || j || i),
    23-bit candidates below q."""
    a = np.zeros((p.K, p.L, N), dtype=np.int64)
    for i in range(p.K):
        for j in range(p.L):
            n = 5 * SHAKE128_RATE
            while True:
                stream = np.frombuffer(hashlib.shake_128(rho + bytes([j, i])).digest(n), dtype=np.uint8)
                t = stream.reshape(-1, 3).astype(np.int64)
                cand = (t[:, 0] | (t[:, 1] << 8) | (t[:, 2] << 16)) & 0x7FFFFF
                cand = cand[cand < Q]
                if cand.size >= N:
                    a[i, j] = cand[:N]
                    break
                n += SHAKE128_RATE
    return a


def sample_eta(sigma: bytes, nonce: int, p: Params) -> np.ndarray:
    """One polynomial with coefficients in [-eta, eta] (int64 [256])."""
    n = SHAKE256_RATE
    while True:
        stream = np.frombuffer(shake256(sigma + _nonce(nonce), n), dtype=np.uint8).astype(np.int64)
        cand = np.stack([stream & 15, stream >> 4], axis=-1).reshape(-1)
        if p.eta == 2:
            cand = cand[cand < 15]
            coeffs = 2 - cand % 5
        else:
            cand = cand[cand < 9]
            coeffs = 4 - cand
        if coeffs.size >= N:
            return coeffs[:N]
        n += SHAKE256_RATE


def expand_mask(rhoprime: bytes, kappa: int, p: Params) -> np.ndarray:
    """y int64 [L, 256] in (-gamma1, gamma1] for nonce kappa."""
    nbytes = N * p.z_bits // 8
    y = np.zeros((p.L, N), dtype=np.int64)
    for i in range(p.L):
        buf = np.frombuffer(shake256(rhoprime + _nonce(p.L * kappa + i), nbytes), dtype=np.uint8)
        y[i] = p.gamma1 - unpack_bits(buf, p.z_bits)
    return y


def sample_in_ball(c_tilde: bytes, p: Params) -> np.ndarray:
    """c int64 [256]: tau entries +-1, the rest 0."""
    n = SHAKE256_RATE
    buf = shake256(c_tilde, n)
    signs = int.from_bytes(buf[:8], "little")
    c = [0] * N
    pos = 8
    for i in range(N - p.tau, N):
        while True:
            if pos >= n:
                n += SHAKE256_RATE
                buf = shake256(c_tilde, n)
            b = buf[pos]
            pos += 1
            if b <= i:
                break
        c[i] = c[b]
        c[b] = 1 - 2 * (signs & 1)
        signs >>= 1
    return np.array(c, dtype=np.int64)


def compute_mu(tr: bytes, message: bytes) -> bytes:
    return shake256(tr + message, CRHBYTES)


# ---------------------------------------------------------------------------
# The scheme
# ---------------------------------------------------------------------------

class SecretKey(NamedTuple):
    rho: bytes
    key: bytes
    tr: bytes
    a_hat: np.ndarray  # [K, L, 256]
    s1_hat: np.ndarray  # [L, 256]
    s2_hat: np.ndarray  # [K, 256]
    t0_hat: np.ndarray  # [K, 256]


def keygen(seed: bytes, p: Params):
    """32 seed bytes -> (pk bytes, sk bytes)."""
    seedbuf = shake256(seed, 2 * SEEDBYTES + CRHBYTES)
    rho, sigma, key = seedbuf[:32], seedbuf[32:96], seedbuf[96:]
    a_hat = expand_a(rho, p)
    s1 = np.stack([sample_eta(sigma, i, p) for i in range(p.L)])
    s2 = np.stack([sample_eta(sigma, p.L + i, p) for i in range(p.K)])
    t = (invntt((a_hat * ntt(s1)[None] % Q).sum(axis=1)) + s2) % Q
    t1, t0 = power2round(t)
    pk = rho + pack_bits(t1.reshape(1, -1), 10).tobytes()
    tr = shake256(pk, TRBYTES)
    sk = (rho + key + tr
          + pack_bits((p.eta - np.concatenate([s1, s2])).reshape(1, -1), p.eta_bits).tobytes()
          + pack_bits(((1 << (D - 1)) - t0).reshape(1, -1), D).tobytes())
    return pk, sk


def unpack_sk(sk: bytes, p: Params) -> SecretKey:
    """sk bytes -> its NTT-domain material, A_hat expanded from rho."""
    if len(sk) != p.sk_bytes:
        raise ValueError(f"sk has {len(sk)} bytes, expected {p.sk_bytes}")
    rho, key, tr = sk[:32], sk[32:64], sk[64:96]
    n_eta = (p.K + p.L) * N * p.eta_bits // 8
    s = p.eta - unpack_bits(np.frombuffer(sk[96:96 + n_eta], dtype=np.uint8), p.eta_bits).reshape(-1, N)
    t0 = (1 << (D - 1)) - unpack_bits(np.frombuffer(sk[96 + n_eta:], dtype=np.uint8), D).reshape(-1, N)
    return SecretKey(rho, key, tr, expand_a(rho, p), ntt(s[:p.L]), ntt(s[p.L:]), ntt(t0))


def _mul(c_hat: np.ndarray, v_hat: np.ndarray) -> np.ndarray:
    """c [B, 256] (NTT) times each polynomial of v [.., P, 256] (NTT) ->
    the centered products [B, P, 256]."""
    return center(invntt(c_hat[:, None, :] * v_hat % Q))


def _hints(h: np.ndarray, p: Params) -> bytes:
    """h [K, 256] of 0/1 -> the omega index bytes and the K counts."""
    out = np.zeros(p.omega + p.K, dtype=np.uint8)
    k = 0
    for i in range(p.K):
        idx = np.flatnonzero(h[i])
        out[k:k + idx.size] = idx
        k += idx.size
        out[p.omega + i] = k
    return out.tobytes()


def sign(sk: SecretKey, mus: Sequence[bytes], p: Params, max_attempts: int = 1000) -> list:
    """Deterministic signatures of 64-byte mu rows under one key, the
    rows' attempts run side by side -> list of signature bytes."""
    n = len(mus)
    rhoprimes = [shake256(sk.key + mu, CRHBYTES) for mu in mus]
    sigs: list = [None] * n
    active = list(range(n))
    kappa = 0
    while active:
        if kappa >= max_attempts:
            raise RuntimeError(f"{len(active)} rows not signed after {max_attempts} attempts")
        y = np.stack([expand_mask(rhoprimes[r], kappa, p) for r in active])  # [B, L, 256]
        w = invntt((sk.a_hat[None] * ntt(y)[:, None] % Q).sum(axis=2))  # [B, K, 256]
        w1, w0 = decompose(w, p)
        w1_packed = pack_w1(w1, p)
        c_tildes = [shake256(mus[r] + w1_packed[b].tobytes(), SEEDBYTES) for b, r in enumerate(active)]
        c_hat = ntt(np.stack([sample_in_ball(ct, p) for ct in c_tildes]))
        z = y + _mul(c_hat, sk.s1_hat)
        r0 = w0 - _mul(c_hat, sk.s2_hat)
        ct0 = _mul(c_hat, sk.t0_hat)
        h = make_hint(r0 + ct0, w1, p)
        reject = (norm_exceeds(z, p.gamma1 - p.beta) | norm_exceeds(r0, p.gamma2 - p.beta)
                  | norm_exceeds(ct0, p.gamma2) | (h.reshape(len(active), -1).sum(axis=1) > p.omega))
        left = []
        for b, r in enumerate(active):
            if reject[b]:
                left.append(r)
                continue
            sigs[r] = (c_tildes[b] + pack_bits((p.gamma1 - z[b]).reshape(1, -1), p.z_bits).tobytes()
                       + _hints(h[b], p))
        active = left
        kappa += 1
    return sigs


class PublicKey(NamedTuple):
    tr: bytes
    a_hat: np.ndarray  # [K, L, 256]
    t1_hat: np.ndarray  # [K, 256]: NTT(t1 * 2^d)


def unpack_pk(pk: bytes, p: Params) -> PublicKey:
    if len(pk) != p.pk_bytes:
        raise ValueError(f"pk has {len(pk)} bytes, expected {p.pk_bytes}")
    t1 = unpack_bits(np.frombuffer(pk[32:], dtype=np.uint8), 10).reshape(p.K, N)
    return PublicKey(shake256(pk, TRBYTES), expand_a(pk[:32], p), ntt(t1 << D))


def _decode_hints(b: bytes, p: Params):
    """The omega + K hint bytes -> h [K, 256], or None where they are
    malformed (a count that falls or passes omega, indices not rising
    within a polynomial, nonzero padding)."""
    h = np.zeros((p.K, N), dtype=np.int64)
    k = 0
    for i in range(p.K):
        end = b[p.omega + i]
        if end < k or end > p.omega:
            return None
        for j in range(k, end):
            if j > k and b[j] <= b[j - 1]:
                return None
            h[i, b[j]] = 1
        k = end
    if any(b[k:p.omega]):
        return None
    return h


def verify(pk: PublicKey, mus: Sequence[bytes], sigs: Sequence[bytes], p: Params) -> np.ndarray:
    """bool [n]: each signature valid for its 64-byte mu under pk."""
    n = len(sigs)
    ok = np.zeros(n, dtype=bool)
    rows, hs = [], []
    z_bytes = p.L * N * p.z_bits // 8
    for r, s in enumerate(sigs):
        if len(s) != p.sig_bytes:
            continue
        h = _decode_hints(s[SEEDBYTES + z_bytes:], p)
        if h is not None:
            rows.append(r)
            hs.append(h)
    if not rows:
        return ok
    z = p.gamma1 - np.stack([unpack_bits(np.frombuffer(sigs[r][SEEDBYTES:SEEDBYTES + z_bytes], dtype=np.uint8),
                                         p.z_bits).reshape(p.L, N) for r in rows])
    z_ok = ~norm_exceeds(z, p.gamma1 - p.beta)
    c_tildes = [sigs[r][:SEEDBYTES] for r in rows]
    c_hat = ntt(np.stack([sample_in_ball(ct, p) for ct in c_tildes]))
    az = (pk.a_hat[None] * ntt(z)[:, None] % Q).sum(axis=2)
    w = invntt(az - c_hat[:, None, :] * pk.t1_hat[None] % Q)
    w1 = use_hint(np.stack(hs), w, p)
    w1_packed = pack_w1(w1, p)
    for b, r in enumerate(rows):
        ok[r] = bool(z_ok[b]) and shake256(mus[r] + w1_packed[b].tobytes(), SEEDBYTES) == c_tildes[b]
    return ok
