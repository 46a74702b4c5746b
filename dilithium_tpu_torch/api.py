"""Bytes-in / bytes-out user API.

The port of `dilithium_tpu/api.py`: NumPy bytes in, bytes out, messages of
any length. mu = CRH(tr || M) is computed on the host (hashlib, or the C++
oracle's thread pool for a large ragged batch, `compute_mu_many`), or on
the device for a batch of equal-length messages (`compute_mu_batch`, K1).

  - `keygen`, `sign` (the lockstep `scheme.sign`; `randomized` draws
    rhoprime from `os.urandom`) and `verify` (`expand_pk` +
    `verify_expanded`) for one-off batches;
  - `Signer` (one key: the dense-operator `MxuSigner`, or the lockstep
    `sign_expanded` over an `ExpandedKey`), `MultiSigner` (many keys in
    one elastic window, `sign_stream_keys`) and `Verifier` (one public
    key: `MxuVerifier`, or `verify_expanded`) keep a key's expansion
    resident across calls; `Signer` and `Verifier` can persist it to an
    .npz file (`cache_path`).

Every entry point builds its tensors on `device`, the card unless the
caller passes device="cpu"; without a card, device="cuda" raises. The
"auto" mode of `Signer` and `Verifier` picks "mxu" on a CUDA device and
"batch" on the CPU.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import threading
import warnings
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dilithium_tpu_torch import convert, mxu, scheme, trace
from dilithium_tpu_torch.ops import keccak
from dilithium_tpu_torch.params import CRHBYTES, SEEDBYTES, TRBYTES, DilithiumParams, get_params

Bytes = Union[bytes, bytearray, memoryview]

_CRH_FALLBACK_WARNED = False


def _as_rows(rows: Sequence[Bytes], length: int, name: str) -> np.ndarray:
    out = np.zeros((len(rows), length), dtype=np.uint8)
    for i, r in enumerate(rows):
        b = bytes(r)
        if len(b) != length:
            raise ValueError(f"{name}[{i}] has {len(b)} bytes, expected {length}")
        out[i] = np.frombuffer(b, dtype=np.uint8)
    return out


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    with trace.span("api.h2d"):
        return torch.from_numpy(np.array(a)).to(device)  # a writable copy: a may view bytes


def _rows(t: torch.Tensor) -> list:
    """t's rows as bytes on the host."""
    with trace.span("api.d2h"):  # waits for the device, then the pageable copy
        a = t.cpu().numpy()
    with trace.span("api.rows"):
        return [bytes(r) for r in a]


def _bools(t: torch.Tensor) -> list:
    """t's elements as a list of bool on the host, in one step."""
    with trace.span("api.d2h"):
        a = t.cpu()
    with trace.span("api.rows"):
        return a.tolist()


def _tr_of_sk(sk_b: bytes) -> bytes:
    return sk_b[2 * SEEDBYTES: 2 * SEEDBYTES + TRBYTES]


def compute_mu(tr: Bytes, message: Bytes) -> bytes:
    """mu = CRH(tr || M): SHAKE256, 64 bytes."""
    h = hashlib.shake_256()
    h.update(bytes(tr))
    h.update(bytes(message))
    return h.digest(CRHBYTES)


def compute_mu_many(trs, messages: Sequence[Bytes]) -> np.ndarray:
    """mu rows for a ragged batch -> uint8 [n, 64]. trs: one 32-byte tr
    shared by every message, or a list of n. From 64 messages on, the C++
    oracle's thread pool hashes them (`oracle.crh_batch`); where that
    library cannot be built or lacks the symbol, hashlib does, with one
    warning a process."""
    with trace.span("api.mu"):
        return _mu_many(trs, messages)


def _mu_many(trs, messages: Sequence[Bytes]) -> np.ndarray:
    n = len(messages)
    if n == 0:
        return np.zeros((0, CRHBYTES), dtype=np.uint8)
    if isinstance(trs, (bytes, bytearray, memoryview)):
        tr_list = [bytes(trs)] * n
        trs_arr = np.frombuffer(tr_list[0], dtype=np.uint8)
    else:
        tr_list = [bytes(t) for t in trs]
        if len(tr_list) != n:
            raise ValueError(f"{len(tr_list)} trs for {n} messages")
        trs_arr = None
    if any(len(t) != TRBYTES for t in tr_list):
        raise ValueError(f"every tr must be {TRBYTES} bytes")
    if n >= 64:
        if trs_arr is None:
            trs_arr = np.stack([np.frombuffer(t, dtype=np.uint8) for t in tr_list])
        try:
            from dilithium_tpu_torch import oracle
            return oracle.crh_batch(trs_arr, messages)
        except (OSError, subprocess.CalledProcessError, AttributeError) as e:
            # only "unavailable" errors (no toolchain, a failed build, a
            # stale library without the symbol) fall back; others propagate
            global _CRH_FALLBACK_WARNED
            if not _CRH_FALLBACK_WARNED:
                _CRH_FALLBACK_WARNED = True
                warnings.warn(f"native crh_batch unavailable ({e!r}); falling back to "
                              "per-message hashlib", RuntimeWarning, stacklevel=3)
    return np.stack([np.frombuffer(compute_mu(t, m), dtype=np.uint8)
                     for t, m in zip(tr_list, messages)])


def compute_mu_batch(tr, messages, device="cuda") -> torch.Tensor:
    """mu = CRH(tr || M) on the device for equal-length messages: tr uint8
    [..., 32] (or [32], shared), messages uint8 [..., mlen], as arrays or
    tensors -> uint8 [..., 64] on `device` (K1 on a card)."""
    tr, messages = (x.to(device, torch.uint8) if isinstance(x, torch.Tensor)
                    else _tensor(np.asarray(x, dtype=np.uint8), device) for x in (tr, messages))
    batch = messages.shape[:-1]
    return keccak.shake256(torch.cat([tr.expand(batch + (TRBYTES,)), messages], dim=-1), CRHBYTES)


# ---------------------------------------------------------------------------
# Persisted key expansions: the scheme is stateless, so the one state worth
# keeping across processes is a key's expansion. A file is used only when its
# meta (kind, level, digest of the key bytes) matches; anything else is
# recomputed. The kinds carry a "torch." prefix, so a file the JAX package
# wrote (other layouts and dtypes) never loads here, nor one of these there.
# ---------------------------------------------------------------------------

def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _save_expansion(path: str, obj, meta: dict) -> None:
    arrs = {f: getattr(obj, f).cpu().numpy() for f in type(obj)._fields}
    meta_b = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez(_npz(path), __meta__=meta_b, **arrs)


# kind -> its fields as numpy (a dict) -> the container on a device, rebuilt
# through `convert`, which puts the operators back in the GEMM layout
_LOADERS = {
    "torch.KeyOperators": lambda z, d: convert.key_operators_from_numpy(
        z["wy_cat"], z["c_cat"], z["key"], z["tr"], device=d),
    "torch.ExpandedKey": lambda z, d: convert.expanded_key_from_numpy(
        *(z[f] for f in scheme.ExpandedKey._fields), device=d),
    "torch.VerifyOperators": lambda z, d: convert.verify_operators_from_numpy(
        np.split(z["wz_cat"], 3, axis=-1), np.split(z["t1_cat"], 3, axis=-1), z["tr"], device=d),
    "torch.ExpandedPk": lambda z, d: convert.expanded_pk_from_numpy(
        *(z[f] for f in scheme.ExpandedPk._fields), device=d),
}


def _load_expansion(path: str, meta: dict, device):
    """The expansion stored at path on a valid hit, else None."""
    try:
        with np.load(_npz(path)) as z:
            if json.loads(bytes(z["__meta__"]).decode()) != meta:
                return None
            return _LOADERS[meta["kind"]](z, device)
    except (OSError, KeyError, ValueError):
        return None


def _expansion_meta(kind: str, level: int, key_bytes: bytes) -> dict:
    return {"kind": kind, "level": level, "key_sha256": hashlib.sha256(key_bytes).hexdigest()}


def _cached(cache_path, meta: dict, device, build):
    """The expansion from cache_path on a hit; else build() it, and write
    it there when a path is given."""
    obj = _load_expansion(cache_path, meta, device) if cache_path else None
    if obj is None:
        obj = build()
        if cache_path:
            _save_expansion(cache_path, obj, meta)
    return obj


def _mode(mode: str, device, what: str) -> str:
    if mode == "auto":
        return "mxu" if torch.device(device).type == "cuda" else "batch"
    if mode not in ("mxu", "batch"):
        raise ValueError(f"unknown {what} mode {mode!r}")
    return mode


def keygen(level: int, seeds: Sequence[Bytes], device="cuda") -> Tuple[list, list]:
    """Batch keygen from 32-byte seeds -> (pks, sks) as lists of bytes."""
    p = get_params(level)
    kp = scheme.keygen(_tensor(_as_rows(seeds, SEEDBYTES, "seed"), device), p)
    if not bool(kp.ok.all()):
        raise RuntimeError("sampler block budget exceeded (p < 1e-50; re-seed)")
    return _rows(kp.pk), _rows(kp.sk)


def _fresh_rhoprime(n: int, device) -> torch.Tensor:
    """n uniformly random 64-byte rhoprime rows from the OS's CSPRNG."""
    return _tensor(np.frombuffer(os.urandom(n * CRHBYTES), dtype=np.uint8).reshape(n, CRHBYTES), device)


def _signatures(res: scheme.SignResult) -> list:
    with trace.span("api.d2h"):
        ok = bool(res.ok.all())
    if not ok:
        raise RuntimeError("sign did not converge within max_rounds")
    return _rows(res.sig)


def sign(level: int, sk: Bytes, messages: Sequence[Bytes], randomized: bool = False,
         device="cuda") -> list:
    """Sign a batch of messages under one secret key -> signatures.
    randomized=True draws rhoprime from os.urandom (the spec's randomized
    variant) in place of CRH(K || mu); the signatures verify the same."""
    p = get_params(level)
    sk_b = bytes(sk)
    if len(sk_b) != p.sk_bytes:
        raise ValueError(f"sk has {len(sk_b)} bytes, expected {p.sk_bytes}")
    if not messages:
        return []
    with trace.span("api.sign"):
        mus = _tensor(compute_mu_many(_tr_of_sk(sk_b), messages), device)
        rp = _fresh_rhoprime(len(messages), device) if randomized else None
        # one unbatched key: expanded once, broadcast over the messages
        sk_t = _tensor(np.frombuffer(sk_b, dtype=np.uint8), device)
        return _signatures(scheme.sign(sk_t, mus, p, rhoprime=rp))


def _sig_row(s: Bytes, sig_bytes: int):
    """s as sig_bytes bytes, its length counted in bytes whatever its item
    size: a byte view of s, or 0x01 bytes where the length is wrong."""
    v = memoryview(s)
    if v.nbytes != sig_bytes:
        return b"\x01" * sig_bytes  # a wrong length never verifies: junk bytes that fail
    return v.cast("B") if v.c_contiguous else v.tobytes()


def _fill_sigs(out: np.ndarray, sig_bytes: int, message_sig_pairs) -> None:
    """Write the pairs' signatures into the first rows of out (uint8,
    C-contiguous, sig_bytes a row), each once, straight from the caller's
    object."""
    sigs = [s for _, s in message_sig_pairs]
    # one pass over types and lengths, so that the usual call takes no branch a row
    if not (set(map(type, sigs)) <= {bytes, bytearray} and set(map(len, sigs)) == {sig_bytes}):
        sigs = [_sig_row(s, sig_bytes) for s in sigs]
    flat = memoryview(out).cast("B")
    for i, s in enumerate(sigs):
        flat[i * sig_bytes:(i + 1) * sig_bytes] = s


def _pk_bytes(p: DilithiumParams, pk: Bytes) -> bytes:
    pk_b = bytes(pk)
    if len(pk_b) != p.pk_bytes:
        raise ValueError(f"pk has {len(pk_b)} bytes, expected {p.pk_bytes}")
    return pk_b


def verify(level: int, pk: Bytes, message_sig_pairs: Sequence[Tuple[Bytes, Bytes]],
           device="cuda") -> list:
    """Verify (message, signature) pairs under one public key -> bools.
    Expands the key once (`expand_pk`); `Verifier` keeps it across calls."""
    p = get_params(level)
    pk_b = _pk_bytes(p, pk)
    if not message_sig_pairs:
        return []
    with trace.span("api.verify"):
        with trace.span("api.stage"):  # one call: a fresh buffer, not pinned
            sigs = np.empty((len(message_sig_pairs), p.sig_bytes), dtype=np.uint8)
            _fill_sigs(sigs, p.sig_bytes, message_sig_pairs)
        mus = compute_mu_many(hashlib.shake_256(pk_b).digest(TRBYTES), [m for m, _ in message_sig_pairs])
        epk = scheme.expand_pk(_tensor(np.frombuffer(pk_b, dtype=np.uint8), device), p)
        with trace.span("api.h2d"):
            sigs_t, mus_t = torch.from_numpy(sigs).to(device), torch.from_numpy(mus).to(device)
        return _bools(scheme.verify_expanded(epk, sigs_t, mus_t, p))


class Signer:
    """A signing service for one key, its expansion computed once.

    mode:
      "mxu"   - dense per-key int8 operators and the elastic stream loop
                (`mxu.MxuSigner`) over min(window, messages) attempt
                slots; window None is the level's default
                (`scheme.default_window(p)`);
      "batch" - the lockstep `scheme.sign_expanded` over the key's
                `ExpandedKey`;
      "auto"  - "mxu" on a CUDA device, "batch" on the CPU.

    cache_path: an .npz file that keeps the expansion across processes. On
    a valid hit (same key digest, level and mode) it is loaded in place of
    being computed; otherwise it is computed and written there.
    """

    def __init__(self, level: int, sk: Bytes, mode: str = "auto", window: Optional[int] = None,
                 cache_path: Optional[str] = None, device="cuda"):
        self.p = get_params(level)
        self.level = level
        sk_b = bytes(sk)
        if len(sk_b) != self.p.sk_bytes:
            raise ValueError(f"sk has {len(sk_b)} bytes, expected {self.p.sk_bytes}")
        self.device = torch.device(device)
        self.tr = _tr_of_sk(sk_b)
        self.mode = _mode(mode, self.device, "Signer")
        self.window = window
        sk_t = _tensor(np.frombuffer(sk_b, dtype=np.uint8), self.device)
        if self.mode == "mxu":
            ops = _cached(cache_path, _expansion_meta("torch.KeyOperators", level, sk_b), self.device,
                          lambda: mxu.build_operators(sk_t, self.p))
            self.signer = mxu.MxuSigner(ops, self.p, window=window)
        else:
            self.expanded = _cached(cache_path, _expansion_meta("torch.ExpandedKey", level, sk_b),
                                    self.device, lambda: scheme.expand_sk(sk_t, self.p))

    def sign(self, messages: Sequence[Bytes], randomized: bool = False) -> list:
        """Sign messages -> signatures; randomized as in `sign`."""
        if not messages:
            return []
        with trace.span("api.sign"):
            mus = _tensor(compute_mu_many(self.tr, messages), self.device)
            rp = _fresh_rhoprime(len(messages), self.device) if randomized else None
            if self.mode == "mxu":
                res = self.signer(mus, rp)
            else:
                res = scheme.sign_expanded(self.expanded, mus, self.p, rhoprime=rp)
            return _signatures(res)


class MultiSigner:
    """A signing service for many keys in one elastic window: the keys'
    expansions as one `ExpandedKey` on a key axis (one batched
    `expand_sk`), and every sign call a mixed-key queue through
    `scheme.sign_stream_keys`, whose slots gather their own key's rows,
    over min(window, pairs) attempt slots; window None is the level's
    default (`scheme.default_window(p)`)."""

    def __init__(self, level: int, sks: Sequence[Bytes], window: Optional[int] = None, device="cuda"):
        self.p = get_params(level)
        self.level = level
        arr = _as_rows(sks, self.p.sk_bytes, "sk")
        self.trs = [_tr_of_sk(bytes(r)) for r in arr]
        self.window = window
        self.device = torch.device(device)
        self.expanded = scheme.expand_sk(_tensor(arr, self.device), self.p)

    def sign(self, key_message_pairs: Sequence[Tuple[int, Bytes]], randomized: bool = False) -> list:
        """Sign [(key index, message), ...] -> signatures, in order;
        randomized as in `sign`."""
        if not key_message_pairs:
            return []
        with trace.span("api.sign"):
            with trace.span("api.keys"):
                idx = np.asarray([i for i, _ in key_message_pairs], dtype=np.int64)
                if idx.min() < 0 or idx.max() >= len(self.trs):
                    raise IndexError(f"key index out of range 0..{len(self.trs) - 1}")
                trs = [self.trs[i] for i in idx]
                if trace.recording():
                    trace.count("api.distinct_keys", np.count_nonzero(np.bincount(idx)))
            mus = compute_mu_many(trs, [m for _, m in key_message_pairs])
            rp = _fresh_rhoprime(len(idx), self.device) if randomized else None
            res = scheme.sign_stream_keys(self.expanded, _tensor(idx, self.device), _tensor(mus, self.device),
                                          self.p, window=self.window, rhoprime=rp)
            return _signatures(res)


class Verifier:
    """A verify service for one public key, its expansion computed once.

    mode:
      "mxu"   - dense z -> Az and c -> c t1 int8 operators
                (`mxu.MxuVerifier`);
      "batch" - `scheme.verify_expanded` over the key's `ExpandedPk`;
      "auto"  - "mxu" on a CUDA device, "batch" on the CPU.

    cache_path: an .npz file that keeps the expansion (see `Signer`).

    A call's signatures and mu rows reach the device through host buffers
    the verifier keeps (pinned on a CUDA device): allocated on the first
    call, grown only for a call of more pairs than they hold, never shrunk.
    Threads may share a verifier: its calls take turns, one whole call at
    a time, since each fills, copies and reads the same buffers.
    """

    def __init__(self, level: int, pk: Bytes, mode: str = "auto",
                 cache_path: Optional[str] = None, device="cuda"):
        self.p = get_params(level)
        self.level = level
        pk_b = _pk_bytes(self.p, pk)
        self.device = torch.device(device)
        self.tr = hashlib.shake_256(pk_b).digest(TRBYTES)
        self.mode = _mode(mode, self.device, "Verifier")
        pk_t = _tensor(np.frombuffer(pk_b, dtype=np.uint8), self.device)
        if self.mode == "mxu":
            vops = _cached(cache_path, _expansion_meta("torch.VerifyOperators", level, pk_b), self.device,
                           lambda: mxu.build_verify_operators(pk_t, self.p))
            self.verifier = mxu.MxuVerifier(vops, self.p)
        else:
            self.expanded = _cached(cache_path, _expansion_meta("torch.ExpandedPk", level, pk_b),
                                    self.device, lambda: scheme.expand_pk(pk_t, self.p))
        self._sigs = torch.empty((0, self.p.sig_bytes), dtype=torch.uint8)
        self._mus = torch.empty((0, CRHBYTES), dtype=torch.uint8)
        self._copied = torch.cuda.Event() if self.device.type == "cuda" else None
        self._lock = threading.Lock()

    def _stage(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The first n rows of the staging buffers, sigs and mus, once the
        last call's copies out of them are done."""
        if self._copied is not None:
            # A non_blocking copy from pinned memory returns before the
            # device has read the rows, and nothing else says the last
            # call's copies are done (it may have raised, or its verdicts
            # come from another stream): wait for them before a rewrite.
            self._copied.synchronize()
        if n > len(self._sigs):
            pin = self.device.type == "cuda"
            self._sigs = torch.empty((n, self.p.sig_bytes), dtype=torch.uint8, pin_memory=pin)
            self._mus = torch.empty((n, CRHBYTES), dtype=torch.uint8, pin_memory=pin)
            trace.count("api.stage_allocs")
        trace.count("api.staged_rows", n)
        return self._sigs[:n], self._mus[:n]

    def _to_device(self, rows: torch.Tensor) -> torch.Tensor:
        """A non_blocking copy of staged rows; the event marks its end."""
        with trace.span("api.h2d"):
            t = rows.to(self.device, non_blocking=True)
            if self._copied is not None:
                self._copied.record(torch.cuda.current_stream(self.device))
            return t

    def verify(self, message_sig_pairs: Sequence[Tuple[Bytes, Bytes]]) -> list:
        """Verify (message, signature) pairs -> bools."""
        if not message_sig_pairs:
            return []
        # held until the verdicts are on the host: on the CPU the device
        # tensors are the buffers themselves, and mu is hashed (without the
        # GIL) between the two copies
        with self._lock, trace.span("api.verify"):
            with trace.span("api.stage"):
                sigs, mus = self._stage(len(message_sig_pairs))
                _fill_sigs(sigs.numpy(), self.p.sig_bytes, message_sig_pairs)
            sigs_t = self._to_device(sigs)  # on its way while mu is hashed
            mus.numpy()[...] = compute_mu_many(self.tr, [m for m, _ in message_sig_pairs])
            mus_t = self._to_device(mus)
            if self.mode == "mxu":
                ok = self.verifier(sigs_t, mus_t)
            else:
                ok = scheme.verify_expanded(self.expanded, sigs_t, mus_t, self.p)
            return _bools(ok)
