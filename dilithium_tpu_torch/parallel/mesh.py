"""Process-group set-up and the per-rank mesh of the data-parallel services.

The port of `dilithium_tpu/parallel/mesh.py`. Signing, keygen and verify
are independent per message, so the services scale by data parallelism:
the batch is split into equal contiguous shards, one per rank, every rank
runs the single-card scheme on its shard, and one all-reduce of the
counters is the only collective.

Layout: one rank (process) per card, PyTorch's own idiom (torchrun, DDP).
The signers read the device once a round (`scheme._stream_loop`'s
n_active, the lockstep signer's `done.all()`), so one host thread driving
several cards would run them one after another. NCCL carries the
collectives between cards, gloo between CPU ranks.

`jax.distributed.initialize` becomes `initialize`, JAX's device `Mesh`
becomes `Mesh` (the group, this rank and its device), and
`local_batch_to_global` keeps its name: in the port the global batch is
the set of equal local shards, and each rank holds only its own. XLA's
shardings (`batch_sharding`, `replicated`) have no counterpart: key
material is "replicated" by each rank building or loading it on its own
card.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

# the collective backend of each device type
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


class Mesh(NamedTuple):
    group: dist.ProcessGroup  # the default (world) group
    rank: int
    world_size: int
    device: torch.device  # this rank's card (NCCL) or the CPU (gloo)


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value is None else int(value)


def initialize(backend: Optional[str] = None, coordinator: Optional[str] = None,
               num_processes: Optional[int] = None, process_id: Optional[int] = None,
               device="cuda") -> torch.device:
    """Join the default process group, the counterpart of
    `jax.distributed.initialize`; returns this rank's device.

    coordinator: "host:port" (rank 0 listens there) or an init URL
    ("tcp://...", "file://..."). Arguments left None are read from
    torchrun's environment: MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK.
    device "cuda" means cuda:LOCAL_RANK (or cuda:process_id modulo the
    cards, without LOCAL_RANK) and NCCL; "cpu" means gloo. Raises when
    device is CUDA and there is no card: the services never fall back to
    the CPU."""
    if coordinator is None and "MASTER_ADDR" in os.environ:
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    num_processes = _env_int("WORLD_SIZE") if num_processes is None else num_processes
    process_id = _env_int("RANK") if process_id is None else process_id
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("initialize needs coordinator, num_processes and process_id, as arguments or "
                         "from torchrun's MASTER_ADDR/MASTER_PORT, WORLD_SIZE and RANK")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device cuda: no CUDA device is available (pass device='cpu' for gloo)")
        if dev.index is None:
            local = _env_int("LOCAL_RANK")
            dev = torch.device("cuda", process_id % torch.cuda.device_count() if local is None else local)
        torch.cuda.set_device(dev)
    backend = BACKENDS.get(dev.type) if backend is None else backend
    if backend != BACKENDS.get(dev.type):
        raise ValueError(f"backend {backend!r} does not serve device {dev}: use {BACKENDS}")
    init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id, device_id=dev if backend == "nccl" else None)
    return dev


def make_mesh(device=None) -> Mesh:
    """This rank's mesh over the initialised default process group. device
    defaults to the current card under NCCL and to the CPU under gloo; a
    device that the group's backend does not serve raises. Never starts a
    process group."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group: call initialize() first")
    group = dist.group.WORLD
    backend = dist.get_backend(group)
    device = torch.device(("cuda" if backend == "nccl" else "cpu") if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if backend != BACKENDS.get(device.type):
        raise ValueError(f"a {backend} process group does not serve device {device}: use {BACKENDS}")
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group), device)


def local_batch_to_global(mesh: Mesh, local) -> torch.Tensor:
    """This rank's contiguous shard of the global batch (numpy or a
    tensor, batch on axis 0), placed on mesh.device. Raises ValueError
    on every rank when the ranks' shards differ in size (one all-reduce),
    as `shard_map` does when the batch does not divide over the mesh."""
    t = torch.as_tensor(np.array(local) if isinstance(local, np.ndarray) else local).to(mesh.device)
    n = t.shape[0]
    extremes = torch.tensor([n, -n], dtype=torch.int64, device=mesh.device)
    dist.all_reduce(extremes, op=dist.ReduceOp.MAX, group=mesh.group)
    most, least = int(extremes[0]), -int(extremes[1])
    if most != least:
        raise ValueError(f"local shards differ in size across ranks ({least} to {most} rows; "
                         f"this rank has {n}): the global batch must divide evenly")
    return t
