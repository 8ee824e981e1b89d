"""Multi-host environment — the counterpart of
``paddle_tpu/distributed/env.py`` (reference capability: trainer/pserver
endpoint lists + gRPC, distribute_transpiler.py:136).

The JAX package starts ``jax.distributed`` over DCN, after which one
process addresses many devices. The port runs one process per device:
``init_distributed`` starts ``torch.distributed`` (NCCL for the card,
with gloo beside it for CPU tensors; gloo alone for ``device="cpu"``),
and a world it started is the multi-host form of the ParallelExecutor:
each process feeds its LOCAL shard of the global batch, and the global
batch is their concatenation on dim 0 in rank order
(``feeds_local_shards``). A world from the caller's launcher, or the
one-rank group ``fluid.parallel_executor.ensure_process_group`` starts,
feeds the same global batch on every rank instead.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

__all__ = ["init_distributed", "get_world_info", "global_mesh",
           "feeds_local_shards"]

# the default process group init_distributed started and its device
# type; both are process-wide, like the process group itself
_started = {"group": None, "device_type": None}


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
) -> Dict[str, int]:
    """Initialize the multi-host runtime. Arguments default to the standard
    env vars (COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID — the role
    the reference fills with PADDLE_INIT_PSERVERS / TRAINER_ID). Single
    process with no coordinator is a no-op (local run).

    ``coordinator_address`` is ``host:port`` of rank 0's TCP store.
    ``device``: ``None`` is the card (NCCL; raises without one), ``"cpu"``
    runs gloo. On the card a process drives ``cuda:<LOCAL_RANK>`` (or
    ``cuda:<process_id mod cards>``). After this, a ParallelExecutor over
    a mesh of every rank (``global_mesh``) runs one step of the whole
    cluster, each process feeding its local shard."""
    import torch

    from ..device import resolve_device

    dev = resolve_device(device)
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("PROCESS_ID", "0"))
    if coordinator_address and num_processes > 1:
        import torch.distributed as dist

        if dist.is_initialized():
            raise RuntimeError("init_distributed: a process group is "
                               "already initialized in this process")
        if dev.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", process_id))
            torch.cuda.set_device(local % torch.cuda.device_count())
            backend = "cpu:gloo,cuda:nccl"
        else:
            backend = "gloo"
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id)
        _started["group"] = dist.group.WORLD
        _started["device_type"] = dev.type
    return get_world_info()


def feeds_local_shards() -> bool:
    """True while the default process group is one ``init_distributed``
    started with more than one process: a ParallelExecutor then takes
    each process's feed as its local shard of the global batch."""
    import torch.distributed as dist

    return (_started["group"] is not None and dist.is_initialized()
            and dist.group.WORLD is _started["group"])


def get_world_info() -> Dict[str, int]:
    """The JAX package's keys, counted in the port's devices: one process
    drives one device, so ``local_device_count`` is 1 and
    ``global_device_count`` the world size."""
    import torch.distributed as dist

    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = 0, 1
    return {
        "process_id": rank,
        "num_processes": world,
        "local_device_count": 1,
        "global_device_count": world,
    }


def global_mesh(axes: Dict[str, int], devices=None):
    """Mesh over ALL processes' devices (axis sizes multiply to the world
    size). Put the data-parallel axis outermost so it maps across hosts.
    ``devices``: the device type; by default the one ``init_distributed``
    was given, else the card."""
    from ..parallel import make_mesh

    if devices is None:
        devices = _started["device_type"] if feeds_local_shards() else None
    return make_mesh(axes, devices=devices)
