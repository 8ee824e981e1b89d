"""Sharding plans over a named DeviceMesh — the counterpart of
``paddle_tpu/parallel/api.py``.

The JAX package maps var-name patterns to ``jax.sharding.PartitionSpec``s
over a named ``Mesh`` and lets XLA's SPMD partitioner insert the
collectives. Here the same plan places each var as a DTensor on a
``torch.distributed`` ``DeviceMesh`` with ``mesh_dim_names``: a spec entry
names the mesh axis a tensor dim is split over, which becomes ``Shard(d)``
on that mesh dimension (``Replicate()`` on every mesh dimension the spec
does not name). DTensors keep global shapes and insert the collectives,
as GSPMD does.
"""
from __future__ import annotations

import contextlib
import math
import re
import threading
from typing import Dict, Optional, Sequence, Tuple

__all__ = ["PartitionSpec", "P", "ShardingPlan", "current_mesh",
           "mesh_context", "make_mesh", "spec_to_placements",
           "plan_data_parallel", "plan_transformer_tp",
           "plan_moe_ep", "plan_fsdp", "plan_sequence_parallel"]


class PartitionSpec(tuple):
    """Per tensor dim: the mesh axis name it is split over, a tuple of
    names (split over several axes, major first) or ``None``
    (unsplit) — the port's own copy of ``jax.sharding.PartitionSpec``.
    Missing trailing dims are unsplit."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self):
        return "PartitionSpec(%s)" % ", ".join(repr(d) for d in self)


P = PartitionSpec


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(str(a) for a in entry)
    return (str(entry),)


def spec_to_placements(spec: Sequence, mesh_dim_names: Sequence[str]):
    """The DTensor placements (one per mesh dimension) of ``spec``: the
    mesh dimension an entry names shards that tensor dim, every other one
    replicates. An entry naming several axes must list them in the mesh's
    order (DTensor splits a dim over mesh dimensions major first). A name
    the mesh does not have raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_dim_names)
    placements = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {tuple(spec)} names axis {a!r}, "
                                 f"which mesh axes {tuple(names)} do not "
                                 "have")
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} lists mesh axes out of "
                             f"the mesh's order {tuple(names)}")
        for i in idx:
            placements[i] = Shard(dim)
    return tuple(placements)


_mesh_tls = threading.local()


def current_mesh():
    """The ``DeviceMesh`` a ParallelExecutor run is active on, if any. Op
    emitters that take an explicit path under a mesh (the kernels'
    ``local_map``, ``moe_ffn``'s placement points) read it here; ``None``
    means a single-device run."""
    return getattr(_mesh_tls, "mesh", None)


def current_seq_axis():
    """The sequence axis of the active run's plan when its mesh holds it
    (feeds split on ``[batch, seq]``), else None."""
    mesh = current_mesh()
    axis = getattr(_mesh_tls, "seq_axis", None)
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return None
    return axis


@contextlib.contextmanager
def mesh_context(mesh, seq_axis=None):
    prev = current_mesh(), getattr(_mesh_tls, "seq_axis", None)
    _mesh_tls.mesh, _mesh_tls.seq_axis = mesh, seq_axis
    try:
        yield mesh
    finally:
        _mesh_tls.mesh, _mesh_tls.seq_axis = prev


def make_mesh(axes: Dict[str, int], devices=None):
    """A named ``DeviceMesh``, e.g. ``make_mesh({'dp': 2, 'tp': 4})``, over
    the ranks of the initialized process group. ``devices`` is the device
    type (``"cuda"``, the default, or ``"cpu"``) or a ``torch.device``.
    The axis sizes must multiply to the world size (one rank a device)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    device_type = _device_type(devices)
    shape = tuple(int(s) for s in axes.values())
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if need != have:
        raise ValueError(f"mesh {dict(axes)} needs {need} devices, have "
                         f"{have} (the process group's world size; one "
                         "rank drives one device)")
    if not dist.is_initialized():
        from ..fluid.parallel_executor import ensure_process_group

        ensure_process_group(device_type, need)
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=tuple(str(a) for a in axes))


def _device_type(devices) -> str:
    if devices is None:
        return "cuda"
    if isinstance(devices, str):
        return devices.split(":")[0]
    t = getattr(devices, "type", None)
    if t is not None:
        return t
    raise TypeError(f"devices={devices!r}: pass a device type ('cuda', "
                    "'cpu') or a torch.device")


class ShardingPlan:
    """Maps var-name patterns (regex) -> PartitionSpec. First match wins;
    unmatched vars are replicated."""

    def __init__(self, rules: Sequence[Tuple[str, PartitionSpec]] = (),
                 batch_axis: Optional[str] = "dp",
                 seq_axis: Optional[str] = None,
                 best_effort: bool = False):
        self.rules = [(re.compile(pat), spec) for pat, spec in rules]
        self.batch_axis = batch_axis
        self.seq_axis = seq_axis
        # best_effort: an indivisible dim falls back to replication instead
        # of erroring (catch-all plans like plan_fsdp, where odd-width
        # biases simply stay replicated)
        self.best_effort = best_effort

    def add(self, pattern: str, spec: PartitionSpec) -> "ShardingPlan":
        self.rules.append((re.compile(pattern), spec))
        return self

    def spec_for(self, name: str, ndim: int) -> PartitionSpec:
        for pat, spec in self.rules:
            if pat.search(name):
                if len(spec) > ndim:
                    # rules intentionally also match optimizer accumulators
                    # derived from a param name; scalar accumulators
                    # (beta pows, lr) can't take the param's spec — replicate
                    return P()
                return spec
        return P()

    def feed_spec(self, ndim: int) -> PartitionSpec:
        if self.batch_axis is None or ndim == 0:
            return P()
        if self.seq_axis is not None and ndim >= 2:
            # sequence-parallel feeds: [batch, seq, ...] shard both leading dims
            return P(self.batch_axis, self.seq_axis, *([None] * (ndim - 2)))
        return P(self.batch_axis, *([None] * (ndim - 1)))


def plan_data_parallel() -> ShardingPlan:
    """Pure DP: feeds sharded on batch, all state replicated — what the
    reference ParallelExecutor's NCCL all-reduce graph computes."""
    return ShardingPlan(batch_axis="dp")


def plan_transformer_tp() -> ShardingPlan:
    """Megatron-style tensor parallel for models/transformer.py: attention
    q/k/v and ffn first matmul shard on the output (head) axis, attention
    out-proj and ffn second matmul shard on the input axis, embeddings shard
    on vocab; DTensor inserts the all-reduces at the row-parallel
    boundaries."""
    # the `(_\w+)?$` tails also catch optimizer accumulators derived from the
    # param name (e.g. "enc0.self.q.w_moment1_0"), keeping Adam moments
    # sharded alongside their params
    return ShardingPlan(
        rules=[
            (r"\.(q|k|v)\.w(_\w+)?$", P(None, "tp")),
            (r"\.ff1\.w(_\w+)?$", P(None, "tp")),
            (r"\.out\.w(_\w+)?$", P("tp", None)),
            (r"\.ff2\.w(_\w+)?$", P("tp", None)),
            (r"\.emb(_\w+)?$", P("tp", None)),
            (r"^proj\.w(_\w+)?$", P(None, "tp")),
        ],
        batch_axis="dp",
    )


def plan_moe_ep(batch_axis: str = "dp", ep_axis: str = "ep") -> ShardingPlan:
    """Expert parallelism: expert weight stacks ([E, ...], created by
    layers.moe as `<name>.experts.w{1,2}`) shard their expert axis over ep;
    router + everything else replicated; feeds on batch."""
    return ShardingPlan(
        rules=[(r"\.experts\.w[12](_\w+)?$", P(ep_axis))],
        batch_axis=batch_axis,
    )


def plan_fsdp(batch_axis: str = "dp", shard_axis: Optional[str] = None
              ) -> ShardingPlan:
    """ZeRO/FSDP-style fully sharded data parallel: every parameter AND its
    optimizer accumulators shard dim 0 over the data axis. DTensor then
    all-gathers a weight just before its use and reduce-scatters its
    gradient — per-device parameter+optimizer memory drops by the dp
    degree while the math stays exactly data parallel. Scalar state (lr,
    beta pows) is replicated by ShardingPlan's ndim guard."""
    axis = shard_axis or batch_axis
    # one catch-all rule: any named var (params and their `<p>_moment...`
    # accumulators alike) shards dim 0; spec_for's len(spec)>ndim guard
    # keeps scalars replicated, and best_effort keeps odd-width tensors
    # (a [10]-class bias on dp=8) replicated instead of erroring
    return ShardingPlan(rules=[(r".", P(axis))], batch_axis=batch_axis,
                        best_effort=True)


def plan_sequence_parallel(batch_axis: str = "dp",
                           seq_axis: str = "sp") -> ShardingPlan:
    """Context parallelism: feeds shard on [batch, seq]; params replicated.
    Attention itself must use a sequence-parallel op (``ring_attention``
    with ``impl`` ring or ulysses, ``parallel/sequence_parallel.py``);
    pointwise and fc layers run on the sequence shards under DTensor."""
    return ShardingPlan(batch_axis=batch_axis, seq_axis=seq_axis)
