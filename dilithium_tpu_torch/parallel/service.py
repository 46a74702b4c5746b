"""Data-parallel keygen, sign and verify services over `torch.distributed`.

The port of `dilithium_tpu/parallel/service.py`. Each factory takes a
`Mesh` and returns a callable over this rank's local shards (batch on
axis 0, on mesh.device): it runs the single-card scheme on the shard and
returns the local outputs with the global counters. The counters (signed,
attempts, verified) come from one `dist.all_reduce(SUM)` a call over an
int64 tensor on mesh.device, the counterpart of JAX's `psum`s. There is
no collective inside a round, so a rank whose shard finishes early waits
only at that all-reduce.

Key material is passed whole to every rank ("replicated"): each rank
builds or loads it on its own card. Signing is deterministic per message
(per-message kappa schedules), so the bytes do not depend on which rank
signs which message.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.distributed as dist

from dilithium_tpu_torch import mxu, scheme, trace
from dilithium_tpu_torch.params import DilithiumParams
from dilithium_tpu_torch.parallel.mesh import Mesh


class ShardedSignResult(NamedTuple):
    sig: torch.Tensor  # uint8 [B_local, sig_bytes]
    attempts: torch.Tensor  # int32 [B_local]
    ok: torch.Tensor  # bool [B_local]
    total_signed: torch.Tensor  # int64 scalar, global (all-reduced)
    total_attempts: torch.Tensor  # int64 scalar, global (all-reduced)


def _on_mesh(mesh: Mesh, *tensors: torch.Tensor) -> None:
    """The local shards must lie on the rank's device: a service never
    moves them, so a CPU shard under NCCL would run on the CPU."""
    for t in tensors:
        if t.device != mesh.device:
            raise ValueError(f"a local shard is on {t.device}, the mesh's device is {mesh.device}")


def _key_shape(key: torch.Tensor, replicate_key: bool, name: str) -> None:
    if (key.dim() == 1) != replicate_key:
        want = f"one key {name} [bytes]" if replicate_key else f"a key a lane, {name} [B_local, bytes]"
        raise ValueError(f"replicate_key={replicate_key} takes {want}; got shape {tuple(key.shape)}")


def _all_reduce(mesh: Mesh, *counts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Sum each local count over the ranks, in one all-reduce."""
    with trace.span("parallel.all_reduce"):
        totals = torch.stack([c.to(device=mesh.device, dtype=torch.int64) for c in counts])
        dist.all_reduce(totals, op=dist.ReduceOp.SUM, group=mesh.group)
        return tuple(totals.unbind())


def _signed(mesh: Mesh, res: scheme.SignResult) -> ShardedSignResult:
    signed, attempts = _all_reduce(mesh, res.ok.sum(), res.attempts.sum())
    return ShardedSignResult(res.sig, res.attempts, res.ok, signed, attempts)


def sharded_keygen(mesh: Mesh, p: DilithiumParams):
    """Keygen over the local shard: fn(seed uint8 [B_local, 32]) -> (pk,
    sk, ok). No collective."""

    def run(seed: torch.Tensor):
        _on_mesh(mesh, seed)
        kp = scheme.keygen(seed, p)
        return kp.pk, kp.sk, kp.ok

    return run


def sharded_sign(mesh: Mesh, p: DilithiumParams, attempts_per_round: int = 4,
                 max_rounds: int = 64, replicate_key: bool = False):
    """The lockstep signer over the local shard: fn(sk, mu uint8
    [B_local, 64]) -> ShardedSignResult. sk is uint8 [B_local, sk_bytes],
    a key a lane, or with replicate_key one key [sk_bytes], expanded once
    and broadcast over the lanes (the same bytes as JAX's broadcast of sk
    before the expansion)."""

    def run(sk: torch.Tensor, mu: torch.Tensor) -> ShardedSignResult:
        _on_mesh(mesh, sk, mu)
        _key_shape(sk, replicate_key, "sk")
        res = scheme.sign(sk, mu, p, attempts_per_round=attempts_per_round, max_rounds=max_rounds)
        return _signed(mesh, res)

    return run


def sharded_sign_stream(mesh: Mesh, p: DilithiumParams, window: int | None = None,
                        max_rounds: int = 8192, use_mxu: bool = True):
    """One-key signing service, the serving path: fn(key_material, mu
    uint8 [Q_local, 64]) -> ShardedSignResult. The key material is the
    key's `mxu.KeyOperators` (use_mxu: `mxu.sign_stream_mxu`) or its
    unbatched `scheme.ExpandedKey` (`scheme.sign_stream`). Each rank runs
    min(window, Q_local) attempt slots; window None is the level's
    default (`scheme.default_window`)."""

    def run(km, mu: torch.Tensor) -> ShardedSignResult:
        _on_mesh(mesh, mu)
        with trace.span("parallel.sign_stream"):
            if use_mxu:
                res = mxu.sign_stream_mxu(km, mu, p, window=window, max_rounds=max_rounds)
            else:
                res = scheme.sign_stream(km, mu, p, window=window, max_rounds=max_rounds)
            return _signed(mesh, res)

    return run


def sharded_sign_stream_keys(mesh: Mesh, p: DilithiumParams, window: int | None = None,
                             max_rounds: int = 8192):
    """Independent-keys signing service: fn(eks, key_idx int [Q_local],
    mu uint8 [Q_local, 64]) -> ShardedSignResult. eks is the batched
    `scheme.ExpandedKey` of every key (on every rank); key_idx and mu are
    this rank's shard of the queue. window as in `sharded_sign_stream`."""

    def run(eks: scheme.ExpandedKey, key_idx: torch.Tensor, mu: torch.Tensor) -> ShardedSignResult:
        _on_mesh(mesh, key_idx, mu)
        res = scheme.sign_stream_keys(eks, key_idx, mu, p, window=window, max_rounds=max_rounds)
        return _signed(mesh, res)

    return run


def sharded_verify(mesh: Mesh, p: DilithiumParams, replicate_key: bool = False):
    """Verify over the local shard: fn(pk, sig, mu) -> (ok bool [B_local],
    total int64 scalar, global). pk is uint8 [B_local, pk_bytes], a key a
    lane, or with replicate_key one key [pk_bytes], expanded once
    (`expand_pk` + `verify_expanded`)."""

    def run(pk: torch.Tensor, sig: torch.Tensor, mu: torch.Tensor):
        _on_mesh(mesh, pk, sig, mu)
        _key_shape(pk, replicate_key, "pk")
        if replicate_key:
            ok = scheme.verify_expanded(scheme.expand_pk(pk, p), sig, mu, p)
        else:
            ok = scheme.verify(pk, sig, mu, p)
        return ok, _all_reduce(mesh, ok.sum())[0]

    return run


def sharded_verify_stream(mesh: Mesh, p: DilithiumParams, use_mxu: bool = True):
    """One-key verify service: fn(key_material, sig, mu) -> (ok bool
    [B_local], total int64 scalar, global). The key material, built once
    by the caller, is the key's `mxu.VerifyOperators` (use_mxu:
    `mxu.verify_mxu`) or its `scheme.ExpandedPk` (`verify_expanded`)."""

    def run(km, sig: torch.Tensor, mu: torch.Tensor):
        _on_mesh(mesh, sig, mu)
        if use_mxu:
            ok = mxu.verify_mxu(km, sig, mu, p)
        else:
            ok = scheme.verify_expanded(km, sig, mu, p)
        return ok, _all_reduce(mesh, ok.sum())[0]

    return run


def throughput_counters(result: ShardedSignResult) -> dict:
    """Host-side summary of the global counters."""
    signed, attempts = int(result.total_signed), int(result.total_attempts)
    return {"signed": signed, "attempts": attempts, "mean_attempts": attempts / max(1, signed)}
