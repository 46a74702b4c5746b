"""Data-parallel scaling layer: process-group set-up, the per-rank mesh
and the sharded scheme services, on `torch.distributed` (NCCL on cards,
gloo on the CPU)."""

from dilithium_tpu_torch.parallel.mesh import Mesh, initialize, local_batch_to_global, make_mesh
from dilithium_tpu_torch.parallel.service import (
    ShardedSignResult, sharded_keygen, sharded_sign, sharded_sign_stream,
    sharded_sign_stream_keys, sharded_verify, sharded_verify_stream,
    throughput_counters,
)

__all__ = [
    "make_mesh", "local_batch_to_global",
    "sharded_keygen", "sharded_sign", "sharded_sign_stream",
    "sharded_sign_stream_keys", "sharded_verify",
    "sharded_verify_stream", "throughput_counters",
    "Mesh", "initialize", "ShardedSignResult",
]
