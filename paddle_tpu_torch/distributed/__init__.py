"""paddle_tpu_torch.distributed — the counterpart of
``paddle_tpu.distributed``: multi-host initialization, the elastic data
service and its coordination, parameter-server training, and the RPC
transport under them (reference SURVEY.md §2.10: gRPC pserver ops, NCCL
handles, the Go master and pserver):

  - `init_distributed` — ``torch.distributed`` over TCP (NCCL for the
    card, gloo for the CPU); a world it starts is the ParallelExecutor's
    multi-host form, each process feeding its local shard of one global
    step; `get_world_info`, `global_mesh`,
  - `MasterService`/`MasterClient` — go/master-parity elastic task queue
    over recordio shards with lease timeouts, failure counts and snapshot
    recovery (wire form and snapshot format shared with the JAX package),
  - `ElectedMaster`/`FileLease`/`endpoint_resolver` — leader election with
    standby takeover from the shared snapshot and client endpoint
    re-resolution; `tcp_lease.LeaseServer`/`TcpLease` for storage without
    trustworthy POSIX locks,
  - `WorkerRegistry` — elastic worker membership by TTL slot leases,
  - `ElasticTrainer` — checkpoint-resume task loop (kill a trainer,
    restart it, training continues from the last intact checkpoint),
  - `param_server` — executable parameter servers the transpiler's
    send/recv ops train against; `rpc` — the framed RPC transport,
  - `faults` — deterministic fault injection (PADDLE_TPU_FAULTS) that
    the RPC layer and master consult.
"""
from . import faults  # noqa: F401
from .elastic import ElasticTrainer  # noqa: F401
from .election import (  # noqa: F401
    ElectedMaster,
    FileLease,
    endpoint_resolver,
)
from .env import get_world_info, global_mesh, init_distributed  # noqa: F401
from .master import MasterClient, MasterService  # noqa: F401
from .membership import WorkerRegistry  # noqa: F401
