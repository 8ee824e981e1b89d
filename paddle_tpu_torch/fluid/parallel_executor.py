"""ParallelExecutor — the Executor's step over a named DeviceMesh, on
DTensors: the counterpart of ``paddle_tpu/fluid/parallel_executor.py``
(reference ``paddle/fluid/framework/parallel_executor.cc:50``,
``python/paddle/fluid/parallel_executor.py:23``).

  - The JAX package jit-compiles the block with feeds sharded on the
    batch axis of a ``Mesh`` and state placed by a ``ShardingPlan``; XLA's
    SPMD partitioner inserts the collectives. Here each feed and each
    state var becomes a DTensor on a ``DeviceMesh`` (``Shard(d)`` /
    ``Replicate()`` per mesh dimension, from the plan's specs), and the
    port's op loop runs eagerly on them: DTensor keeps global shapes and
    inserts the collectives. A step therefore computes the single-device
    step over the global batch; losses, gradients and updated state
    match the plain ``Executor`` within float32 reduction reorder.
  - Multi-controller: PyTorch runs one process per device. Every rank
    runs the same script and calls ``run`` with the same GLOBAL feed (the
    JAX package's single-process API); a feed list of per-device dicts is
    concatenated on dim 0 first. With no process group initialized and a
    mesh of one device, the executor starts its own one-rank group on a
    ``FileStore`` in a temporary directory (NCCL on the card, gloo on the
    CPU); a larger mesh needs the caller's launcher (``torchrun``,
    ``torch.multiprocessing.spawn``). A mesh whose size differs from the
    world size raises.
  - Multi-host form: in a world that ``distributed.init_distributed``
    started with more than one process (the API the JAX package's
    multi-host form runs under), each process feeds only its LOCAL shard
    and the global batch is their concatenation on dim 0, in rank order
    (the JAX package's ``make_array_from_process_local_data``). The
    ranks' local batches must be equal and every feed must shard on its
    batch dim; otherwise ``run`` raises naming the fix.
  - State goes onto the mesh by ``distribute_tensor`` from rank 0, so
    ranks whose startups drew differently cannot diverge (the reference's
    ``BCastParamsToGPUs``); ``bcast_params`` does it again on demand.
    State a plan shards stays sharded in the scope; Adam moments follow
    their parameter through the rules' ``(_\\w+)?$`` tails. Fetches come
    back whole (``full_tensor()``), as numpy on every rank.
  - Emitter-made tensors (fills, masks, ``arange``, dropout masks from
    the step's seeded ``torch.Generator``, one-hots) are plain tensors of
    the global shape: the op loop runs under ``implicit_replication()``,
    so they are replicated values, and every plain op output is stored as
    a replicated DTensor. A dropout mask equals the single-device one.
  - Kernels: the ops that call a hand-written kernel (``layer_norm`` → K1,
    ``ring_attention`` → K2/K3a/K3b, ``conv2d_bn_relu`` → K5) reach it
    through ``local_map`` on local shards (``fluid/ops/mesh_ops.py``), the
    counterpart of the JAX op's ``shard_map`` around the Pallas kernel;
    the kernels see plain tensors and do not change.
  - An op whose DTensor form has no sharding rule is never gathered
    silently: ``REPLICATED_OPS`` lists the op types that run on
    replicated values and ``BATCH_LOCAL_OPS`` the per-sample ones that
    run on batch shards (the convolutions, the pools), each with its
    reason; any other op DTensor cannot propagate raises naming the op's
    type.

Counters (the JAX package's names): ``parallel_executor.step_ms``,
``.grad_allreduce_step_ms``, ``.jit_compiles`` and ``.jit_cache_hits``
(program-signature entries: first runs and repeats), ``mesh.*`` through
``paddle_tpu_torch.mesh.observe``. The JAX package counts collectives in
the compiled HLO; the port counts what ``CommDebugMode`` records on the
first step of each program signature. ``collect_cost=True`` fills
``last_cost_analysis['flops']`` from ``autotune.CostProbe`` (the one
cost counter of the port) on that step and ``bytes_accessed`` with -1
("not available", the JAX package's value).

``device``: ``None`` means the card (a raise without one);
``use_cuda=False`` with no ``device`` means the CPU (the reference's
CPUPlace).
"""
from __future__ import annotations

import contextlib
import math
import os
import tempfile
import time as _time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..observability import metrics as _metrics, tracing as _tracing
from .enforce import throw_on
from . import core
from .executor import (DIST_OP_TYPES, Executor, _as_feed, _as_name, _fetched_numpy,
                       _matmul_precision, _next_seed, _run_io_host_ops,
                       global_scope)
from .framework import Program, default_main_program
from .registry import EmitCtx, OpInfo, exec_op_descs

__all__ = ["ParallelExecutor", "ensure_process_group", "REPLICATED_OPS",
           "BATCH_LOCAL_OPS"]

_m_pe_step_ms = _metrics.histogram("parallel_executor.step_ms")
_m_pe_allreduce_ms = _metrics.histogram(
    "parallel_executor.grad_allreduce_step_ms")
_m_pe_compiles = _metrics.counter("parallel_executor.jit_compiles")
_m_pe_cache_hits = _metrics.counter("parallel_executor.jit_cache_hits")

# op types that run on replicated values under a mesh: their DTensor
# inputs are redistributed to Replicate, the emitter runs on the local
# (whole) tensors, and the outputs are replicated DTensors. A key
# "<type>_grad" names the op's own grad emitter. Each entry says why
# DTensor cannot run the op as it stands.
REPLICATED_OPS: Dict[str, str] = {
    "lookup_table_grad": "the dense gradient accumulates the rows into "
                         "zeros_like(W) with an in-place index_put_, which "
                         "DTensor has no rule for on a sharded W",
}


# op types that are independent per sample and run on the batch shards of
# their batch slots (the slot named first fixes which mesh dims are the
# batch's; the op's other inputs are replicated): forward and grad
# emitters see local tensors, a replicated input's gradient comes back
# as a partial sum over the batch shards. Each entry names its batch
# slots and why DTensor cannot run the op as it stands.
_CONV = ("aten.convolution's DTensor handler is the tensor-parallel conv "
         "(a width-sharded input); a batch- or channel-sharded input "
         "breaks it")
BATCH_LOCAL_OPS: Dict[str, Any] = {
    "conv2d": (("Input", "Output"), _CONV),
    "depthwise_conv2d": (("Input", "Output"), _CONV),
    "conv3d": (("Input", "Output"), _CONV),
    "conv2d_transpose": (("Input", "Output"), _CONV),
    "conv3d_transpose": (("Input", "Output"), _CONV),
    "pool2d": (("X", "Out"), "a padded max pool on a batch-split DTensor "
                             "runs collectives of mismatched sizes on the "
                             "ranks (gloo aborts, torch 2.13)"),
    "pool3d": (("X", "Out"), "as pool2d"),
}


def ensure_process_group(device_type: str, size: int):
    """The process group a mesh of ``size`` devices runs on. None
    initialized and ``size == 1``: start a one-rank group on a
    ``FileStore`` in a fresh temporary directory (NCCL for the card and
    gloo for the CPU, or gloo alone for a CPU mesh). A larger mesh needs
    the caller's launcher; a world of another size raises naming both."""
    import torch.distributed as dist

    if dist.is_initialized():
        world = dist.get_world_size()
        if world != size:
            raise ValueError(f"the mesh has {size} devices but the process "
                             f"group's world size is {world}: one rank "
                             "drives one device")
        return
    if size != 1:
        raise RuntimeError(
            f"a mesh of {size} devices needs {size} processes: start them "
            "with a launcher (torchrun, torch.multiprocessing.spawn) and "
            "call torch.distributed.init_process_group in each before "
            "building the ParallelExecutor")
    path = os.path.join(tempfile.mkdtemp(prefix="pe_store_"), "store")
    store = dist.FileStore(path, 1)
    # on the card the group also carries gloo, so a CPU mesh of the same
    # process (a CPU reference run beside the card's) shares it
    dist.init_process_group(
        "cpu:gloo,cuda:nccl" if device_type == "cuda" else "gloo",
        store=store, rank=0, world_size=1)


def _rank_device(device: torch.device) -> torch.device:
    """The device this rank drives: on the card, ``cuda:<local rank>``."""
    if device.type != "cuda":
        return device
    import torch.distributed as dist

    if dist.is_initialized() and dist.get_world_size() > 1:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        return torch.device("cuda", local % torch.cuda.device_count())
    return device


def _is_dtensor(v) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(v, DTensor)


class _MeshEnv(dict):
    """The op loop's env under a mesh: a plain tensor an emitter returns
    is stored as a replicated DTensor of the global shape."""

    def __init__(self, mesh):
        super().__init__()
        self._mesh = mesh

    def __setitem__(self, name, value):
        if isinstance(value, torch.Tensor) and not _is_dtensor(value):
            from torch.distributed.tensor import DTensor, Replicate

            value = DTensor.from_local(
                value, self._mesh, [Replicate()] * self._mesh.ndim,
                run_check=False)
        super().__setitem__(name, value)


def _replicated_call(mesh, fn):
    """``fn(ctx, *slot_dicts, attrs)`` — an emitter (``ins``) or a grad
    emitter (``ins``, ``outs``, ``out_grads``) — on replicated values:
    DTensor inputs are redistributed to Replicate and unwrapped
    (differentiably), the outputs wrapped back as replicated DTensors."""
    from torch.distributed.tensor import DTensor, Replicate

    from .registry import normalize_outs

    rep = [Replicate()] * mesh.ndim

    def local(x):
        if _is_dtensor(x):
            return x.redistribute(mesh, rep).to_local()
        return x

    def wrap(v):
        if isinstance(v, torch.Tensor) and not _is_dtensor(v):
            return DTensor.from_local(v, mesh, rep, run_check=False)
        return v

    def call(ctx, *args):
        *slots, attrs = args
        outs = normalize_outs(fn(ctx, *[
            {s: [local(x) for x in lst] for s, lst in d.items()}
            for d in slots], attrs))
        return {s: [wrap(v) for v in lst] for s, lst in outs.items()}

    return call


def _batch_dims(x):
    """The mesh dims over which ``x`` is split on dim 0."""
    from torch.distributed.tensor import Shard

    if not _is_dtensor(x):
        return ()
    return tuple(i for i, p in enumerate(x.placements)
                 if isinstance(p, Shard) and p.dim == 0)


def _batch_local(mesh, fn, batch_slots, grad):
    """``fn`` (an emitter, or with ``grad`` a grad emitter) on the batch
    shards: slots in ``batch_slots`` (and ``GRAD@`` / ``Out@`` of them)
    keep their dim-0 split, every other input is replicated; the outputs
    of batch slots come back split as the batch, a replicated input's
    gradient as a partial sum over the batch dims."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from .registry import normalize_outs

    def base(slot):
        for pre in ("GRAD@", "Out@"):
            if slot.startswith(pre):
                return slot[len(pre):]
        return slot

    def call(ctx, *args):
        *slots, attrs = args
        first = next((x for d in slots for s, lst in d.items()
                      if base(s) in batch_slots for x in lst
                      if _is_dtensor(x)), None)
        bdims = _batch_dims(first) if first is not None else ()
        if first is not None and first.shape[0] % math.prod(
                int(mesh.shape[i]) for i in bdims):
            bdims = ()
        pl_b = [Shard(0) if i in bdims else Replicate()
                for i in range(mesh.ndim)]
        pl_r = [Replicate()] * mesh.ndim
        pl_p = [Partial() if i in bdims else Replicate()
                for i in range(mesh.ndim)]

        def local(slot, x):
            if not _is_dtensor(x):
                return x
            if base(slot) in batch_slots:
                return x.redistribute(mesh, pl_b).to_local(
                    grad_placements=pl_b)
            return x.redistribute(mesh, pl_r).to_local(
                grad_placements=pl_p)

        outs = normalize_outs(fn(ctx, *[
            {s: [local(s, x) for x in lst] for s, lst in d.items()}
            for d in slots], attrs))

        def wrap(slot, v):
            if not isinstance(v, torch.Tensor) or _is_dtensor(v):
                return v
            if base(slot) in batch_slots:
                pl = pl_b
            else:
                pl = pl_p if grad else pl_r
            return DTensor.from_local(v, mesh, pl, run_check=False)

        return {s: [wrap(s, v) for v in lst] for s, lst in outs.items()}

    return call


class _MeshCtx(EmitCtx):
    """A run's emitter context under a mesh: the REPLICATED_OPS run
    through ``_replicated_call``, and an op DTensor cannot propagate
    raises naming its type."""

    def __init__(self, mesh, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.mesh = mesh
        self._infos: Dict[str, Any] = {}

    def op_info(self, op_type):
        info = self._infos.get(op_type)
        if info is None:
            base = super().op_info(op_type)
            fwd, grad = base.forward, base.grad
            if op_type in REPLICATED_OPS:
                fwd = _replicated_call(self.mesh, fwd)
            if grad is not None and f"{op_type}_grad" in REPLICATED_OPS:
                grad = _replicated_call(self.mesh, grad)
            if op_type in BATCH_LOCAL_OPS:
                slots = BATCH_LOCAL_OPS[op_type][0]
                fwd = _batch_local(self.mesh, fwd, slots, False)
                if grad is not None:
                    grad = _batch_local(self.mesh, grad, slots, True)
            info = self._infos[op_type] = OpInfo(
                base.type, self._named(op_type, fwd),
                needs_rng=base.needs_rng,
                grad=self._named(op_type, grad) if grad else None,
                no_grad=base.no_grad, ref=base.ref)
        return info

    def _named(self, op_type, fn):
        mesh = self.mesh

        def call(*args):
            try:
                return fn(*args)
            except NotImplementedError as e:
                if str(e).startswith(f"op '{op_type}'"):
                    raise
                raise NotImplementedError(
                    f"op '{op_type}' has no DTensor form under the mesh "
                    f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}: {e} — "
                    "give it a sharding rule or an entry in "
                    "fluid.parallel_executor.REPLICATED_OPS") from e

        return call


def _collective_kind(op) -> Optional[str]:
    name = str(op)
    for kind in ("all_reduce", "all_gather", "reduce_scatter",
                 "all_to_all"):
        if kind in name:
            return kind
    return None


class ParallelExecutor:
    def __init__(
        self,
        use_cuda: Optional[bool] = None,
        loss_name: Optional[str] = None,
        main_program: Optional[Program] = None,
        num_threads: Optional[int] = None,
        allow_op_delay: bool = False,
        share_vars_from: Optional["ParallelExecutor"] = None,
        devices: Optional[Sequence[Any]] = None,
        use_tpu: Optional[bool] = None,
        mesh=None,
        sharding_plan=None,
        collect_cost: bool = False,
        device=None,
    ):
        """``mesh``: a ``DeviceMesh`` with dim names, a ``MeshSpec``, an
        axes dict or a ``"dp=2,tp=4"`` string; ``None`` takes
        ``FLAGS['mesh_axes']`` when set, else ``{"dp": world size}``
        (``len(devices)`` when ``devices`` is given). ``device``: ``None``
        is the card; ``use_cuda=False`` without a device is the CPU."""
        from ..mesh import MeshSpec, note_mesh
        from ..parallel import ShardingPlan

        if device is None and use_cuda is False:
            device = "cpu"
        self.device = resolve_device(device)
        self._program = main_program or default_main_program()
        dist_ops = sorted({op.desc.type for op in
                           self._program.global_block().ops
                           if op.desc.type in DIST_OP_TYPES})
        if dist_ops:
            raise NotImplementedError(
                f"ParallelExecutor: op types {dist_ops} (parameter-server "
                "transport) run under the plain Executor only — the JAX "
                "package has no pserver training under a mesh either")
        self._loss_name = loss_name
        dtype = self.device.type
        if mesh is None:
            from ..flags import FLAGS

            if FLAGS["mesh_axes"]:
                spec = MeshSpec.parse(FLAGS["mesh_axes"])
            else:
                import torch.distributed as dist

                n = (len(devices) if devices is not None
                     else dist.get_world_size() if dist.is_initialized()
                     else 1)
                spec = MeshSpec({"dp": n})
            mesh = spec.build(dtype)
        elif not hasattr(mesh, "mesh_dim_names"):
            mesh = MeshSpec.coerce(mesh).build(dtype)
        else:
            ensure_process_group(dtype, mesh.size())
        if mesh.mesh_dim_names is None:
            raise ValueError("the DeviceMesh needs mesh_dim_names: the "
                             "plan's specs name its axes")
        if mesh.device_type != dtype:
            raise ValueError(f"the mesh is on {mesh.device_type!r}, the "
                             f"executor's device is {self.device}")
        self._mesh = mesh
        self._axes = dict(zip(mesh.mesh_dim_names,
                              (int(s) for s in mesh.shape)))
        self._plan = sharding_plan or ShardingPlan(
            batch_axis=mesh.mesh_dim_names[0])
        self._rank_device = _rank_device(self.device)
        from ..distributed.env import feeds_local_shards

        self._local_shards = feeds_local_shards()
        note_mesh(mesh, label="parallel_executor")
        self._scope = (share_vars_from._scope if share_vars_from is not None
                       else global_scope())
        self._exe = Executor(self._rank_device)
        self._seen: Dict[Any, Dict[str, Any]] = {}
        self._collect_cost = bool(collect_cost)
        self.last_cost_analysis: Optional[Dict[str, float]] = None

    @property
    def device_count(self) -> int:
        return int(self._mesh.size())

    @property
    def mesh(self):
        return self._mesh

    # -- placement ---------------------------------------------------------
    def _divisible(self, shape, spec) -> bool:
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            axes = entry if isinstance(entry, (tuple, list)) else (entry,)
            size = math.prod(self._axes.get(a, 1) for a in axes)
            if dim >= len(shape) or shape[dim] % size != 0:
                return False
        return True

    def _resolve_spec(self, name, shape):
        """The plan's spec for a state var. Size-1 arrays (scalar optimizer
        accumulators whose names match a param rule, the learning rate)
        replicate, on any mesh; a
        genuinely indivisible var is a misconfigured plan and fails loudly
        — except under a best_effort plan."""
        from ..parallel import P

        if math.prod(shape) <= 1:
            return P()
        spec = self._plan.spec_for(name, len(shape))
        if self._divisible(shape, spec):
            return spec
        if getattr(self._plan, "best_effort", False):
            return P()
        throw_on(
            "sharding plan maps var '%s' (shape %s) to %s, but a "
            "dimension does not divide the mesh axis size %s — fix the "
            "plan rules or the model dims",
            name, tuple(shape), spec, self._axes,
            context="ParallelExecutor")

    def _placements(self, spec):
        from ..parallel import spec_to_placements

        return spec_to_placements(spec, self._mesh.mesh_dim_names)

    def _place_state(self, name, value):
        """A scope value as a DTensor of the plan's placement: a plain
        tensor goes onto the mesh from rank 0; a DTensor is redistributed
        when its placement differs."""
        from torch.distributed.tensor import distribute_tensor

        if not isinstance(value, torch.Tensor):
            raise TypeError(f"state var '{name}' holds a "
                            f"{type(value).__name__}; a ParallelExecutor "
                            "places tensors only")
        target = self._placements(self._resolve_spec(name,
                                                     tuple(value.shape)))
        if _is_dtensor(value):
            if value.device_mesh == self._mesh and \
                    tuple(value.placements) == target:
                return value
            return value.redistribute(self._mesh, target)
        return distribute_tensor(value.detach().to(self._rank_device),
                                 self._mesh, target, src_data_rank=0)

    def _place_feed(self, name, value):
        from ..parallel import P
        from torch.distributed.tensor import distribute_tensor

        t = _as_feed(value, self._rank_device)
        if not isinstance(t, torch.Tensor):
            raise TypeError("a ParallelExecutor feeds dense tensors only")
        spec = self._plan.feed_spec(t.ndim)
        if self._local_shards:
            return self._local_feed(name, t, spec)
        if not (t.ndim and self._plan.batch_axis
                and self._divisible(tuple(t.shape), spec)):
            # indivisible feeds stay replicated (reference PE pads/splits)
            spec = P()
        # every rank holds the same global feed: each keeps its own
        # shard, no communication
        return distribute_tensor(t, self._mesh, self._placements(spec),
                                 src_data_rank=None)

    def _local_feed(self, name, t, spec):
        """The multi-host form: ``t`` is this process's shard of the
        global batch, split on dim 0 over the mesh dims the plan's feed
        spec names; the global batch is the shards in rank order."""
        import torch.distributed as dist
        from torch.distributed.tensor import DTensor, Shard

        placements = self._placements(spec) if t.ndim else ()
        split = [i for i, p in enumerate(placements)
                 if isinstance(p, Shard) and p.dim == 0]
        if not (self._plan.batch_axis and split):
            throw_on(
                "feed '%s' (local shape %s) does not shard on its batch dim "
                "over the multi-host mesh %s: each process feeds its local "
                "shard of the global batch, so a feed needs a batch dim and "
                "the plan a batch axis — feed it from one process group "
                "started by a launcher instead",
                name, tuple(t.shape), self._axes, context="ParallelExecutor")
        rows = torch.tensor([t.shape[0], -t.shape[0]], dtype=torch.int64)
        dist.all_reduce(rows, op=dist.ReduceOp.MAX)
        most, least = int(rows[0]), -int(rows[1])
        if most != least:
            throw_on(
                "feed '%s': the processes feed local batches of %d to %d "
                "rows, which do not divide into equal shards of the global "
                "batch over the multi-host mesh %s — pad the local batch or "
                "use drop_last so every process feeds an equal shard",
                name, least, most, self._axes, context="ParallelExecutor")
        shape = (t.shape[0] * math.prod(int(self._mesh.shape[i])
                                        for i in split),) + tuple(t.shape[1:])
        stride = tuple(math.prod(shape[d + 1:]) for d in range(len(shape)))
        return DTensor.from_local(t.contiguous(), self._mesh, placements,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=stride)

    # -- run -----------------------------------------------------------------
    def run(self, fetch_list, feed=None, feed_dict=None,
            return_numpy: bool = True):
        feed = feed if feed is not None else feed_dict
        feed = feed or {}
        if isinstance(feed, (list, tuple)):
            # reference accepts per-device feed dicts; concat on batch dim
            merged: Dict[str, Any] = {}
            for d in feed:
                for k, v in d.items():
                    merged.setdefault(k, []).append(np.asarray(v))
            feed = {k: np.concatenate(v, axis=0) for k, v in merged.items()}
        program = self._program
        t0 = _time.perf_counter()
        with _tracing.span("parallel_executor.step",
                           devices=self.device_count,
                           program_version=program._version) as span, \
                _matmul_precision(), core.F32_BF16_REDUCTION.held():
            out, collectives = self._run_body(program, feed, fetch_list,
                                              return_numpy)
            if collectives:
                span.set_arg("collectives", int(sum(collectives.values())))
        step_ms = (_time.perf_counter() - t0) * 1e3
        _m_pe_step_ms.observe(step_ms)
        if self._loss_name:  # a training step: includes the grad all-reduce
            _m_pe_allreduce_ms.observe(step_ms)
        return out

    def _run_body(self, program, feed, fetch_list, return_numpy):
        from torch.distributed.tensor.experimental import implicit_replication

        from ..mesh import note_sharded_compile, sharded_step_counter
        from ..parallel import mesh_context

        scope = self._scope
        feeds = {k: self._place_feed(k, v) for k, v in feed.items()}
        fetch_names = tuple(_as_name(v) for v in fetch_list)
        state_in, state_out, segments = self._exe._entry(
            program, list(feeds), True)
        missing = [n for n in state_in if not scope.has_var(n)]
        if missing:
            raise RuntimeError(
                f"vars {missing} not initialized — run the startup program "
                "with a plain Executor first")
        sig = (id(program), program._version,
               tuple(sorted((k, tuple(v.shape), str(v.dtype))
                            for k, v in feeds.items())), fetch_names)
        entry = self._seen.get(sig)
        first = entry is None
        if first:
            _m_pe_compiles.inc()
            entry = self._seen[sig] = {"collectives": None, "cost": None}
        else:
            _m_pe_cache_hits.inc()
        env = _MeshEnv(self._mesh)
        for n in state_in:
            v = self._place_state(n, scope.find_var(n))
            scope.set_var(n, v)
            env[n] = v
        for k, v in feeds.items():
            env[k] = v
        ctx = _MeshCtx(self._mesh, device=self._rank_device,
                       root_seed=_next_seed(program), program=program)
        keep = frozenset(fetch_names)
        probes = []
        if first:
            from torch.distributed.tensor.debug import CommDebugMode

            probes.append(CommDebugMode())
            if self._collect_cost:
                from ..autotune.measure import CostProbe

                probes.append(CostProbe(count_bytes=False))
        with contextlib.ExitStack() as stack:
            for p in probes:
                stack.enter_context(p)
            stack.enter_context(mesh_context(
                self._mesh, getattr(self._plan, "seq_axis", None)))
            stack.enter_context(implicit_replication())
            for io, seg, plan in segments:
                if io:
                    _run_io_host_ops(seg, scope, self._rank_device, env)
                else:
                    exec_op_descs(ctx, seg, env, keep=keep, plan=plan)
            for n in state_out:
                if n in env:
                    scope.set_var(n, self._place_state(n, env[n].detach()))
            fetches = [self._fetch(n, env) for n in fetch_names]
        if first:
            counts: Dict[str, int] = {}
            for op, n in probes[0].get_comm_counts().items():
                kind = _collective_kind(op)
                if kind is not None:
                    counts[kind] = counts.get(kind, 0) + int(n)
            entry["collectives"] = note_sharded_compile(counts)
            if self._collect_cost:
                entry["cost"] = {"flops": probes[1].flops,
                                 "bytes_accessed": -1.0}
        self.last_cost_analysis = entry["cost"]
        sharded_step_counter().inc()
        if return_numpy:
            fetches = [_fetched_numpy(f) for f in fetches]
        return fetches, entry["collectives"]

    def _fetch(self, name, env):
        if name not in env:
            raise ValueError(
                f"fetch target '{name}' was not produced by the block")
        v = env[name]
        if _is_dtensor(v):
            v = v.full_tensor()
        return v.detach()

    def bcast_params(self):
        """Parity with reference bcast_params (parallel_executor.py:149):
        every scope var goes onto the mesh replicated, from rank 0."""
        from torch.distributed.tensor import Replicate, distribute_tensor

        rep = [Replicate()] * self._mesh.ndim
        with _tracing.span("parallel_executor.bcast_params",
                           devices=self.device_count):
            for name in list(self._scope.var_names()):
                v = self._scope.find_var(name)
                if not isinstance(v, torch.Tensor):
                    continue
                if _is_dtensor(v):
                    v = v.redistribute(self._mesh, rep)
                else:
                    v = distribute_tensor(v.detach().to(self._rank_device),
                                          self._mesh, rep, src_data_rank=0)
                self._scope.set_var(name, v)
