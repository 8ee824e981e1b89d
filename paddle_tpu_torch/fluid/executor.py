"""Executor: runs a Program block op by op, eagerly, on one device — the
counterpart of ``paddle_tpu/fluid/executor.py`` with the same ``run``
contract (reference python/paddle/fluid/executor.py:181).

  - The JAX package traces the block into one jitted XLA computation; here
    each op's PyTorch emitter runs in program order on the executor's
    device (the card unless the caller names the CPU), so the reference's
    per-op dispatch loop (executor.cc:344) is what runs.
  - Scope (reference scope.h:39) maps var name -> torch tensor. The block's
    state splits as in the JAX package's ``_block_io`` / ``_lower``: state
    read (read-only or read-write, from the scope), persistable state
    written (back to the scope after the run), and fetches that must be
    produced.
  - Gradients: each forward op that a later ``<type>_grad`` op
    differentiates runs once with autograd on, and the grad op consumes
    that record (registry.exec_op_descs); every other op — the startup
    program, the optimizer ops — runs under ``torch.no_grad()``.
  - Feed/fetch: numpy in, numpy out (``return_numpy=False`` returns the
    tensors, detached). numpy has no bfloat16 type here, so a bfloat16
    fetch comes back as its exact float32 widening (the JAX executor
    returns the bfloat16 array; ``return_numpy=False`` returns the
    bfloat16 tensor). A SelectedRows value (a sparse ``lookup_table``'s
    gradient) flows through the env as itself and is fetched as a
    SelectedRows, as the JAX executor returns it: with numpy ``rows``
    and ``value`` under ``return_numpy=True`` (its ``to_dense()`` is
    then numpy too), with detached tensors otherwise. A SelectedRows
    feed goes to the device as one.
  - Precision: a run honours ``FLAGS['matmul_precision']`` as the JAX
    executor does (executor.py:654); under the default 'highest' no
    cuBLAS or cuDNN product of the run takes TF32, whatever the caller's
    torch settings, which are restored after the run. Every run also
    holds cuBLAS's bfloat16 products to float32 reductions
    (``core.F32_BF16_REDUCTION``; they run under FLAGS['amp']), as XLA
    accumulates a bfloat16 dot, and restores the caller's setting.
  - Host io ops ``save``, ``save_combine``, ``load``, ``load_combine``
    (reference operators/save_op.cc, load_combine_op.cc) run on the host
    in program order, in the JAX package's file formats (``.npy`` per
    var, ``.npz`` combined; ``_run_io_host_ops``). Each run of adjacent
    io ops is checked whole before any file is written. The JAX executor
    lowers a block to one XLA computation and so refuses an io op
    sandwiched between device ops; the eager loop here has no such
    restriction — an io op sees exactly the values the ops before it
    produced. A load puts each tensor on the executor's device once.

  - Reader ops (reference operators/reader/) run as the JAX package's
    host pre-pass (``_run_reader_host_ops``): creation ops (re)build the
    host reader stack of ``readers.py`` into the scope, ``read`` pops one
    batch into the step's feeds (a ``(padded, lengths)`` pair into
    ``name`` and ``name@LEN``) and raises ``core.EOFException`` at the
    end of the data. A batch that a double buffer copied to the card on
    its own stream carries an event: the executor's stream waits on it
    before the step's first op runs.

  - State a ParallelExecutor left in the scope as DTensors is read
    whole (``full_tensor()``, a collective every rank of the mesh runs),
    as the JAX executor reads sharded arrays; the run writes plain
    tensors back. ``fetch_var`` reads such a var whole too.

  - Parameter-server transport ops (reference send_op.cc, recv_op.cc,
    prefetch_op.cc, send_barrier_op.cc), as the JAX executor runs them
    around its jitted step: ``recv`` pulls parameters into the scope
    before the step (``executor.recv``), ``prefetch`` pulls the batch's
    unique rows of a distributed table into a sub-table feed
    (``executor.prefetch``), and after the step ``send`` / ``send_vars``
    push the gradients, ``send_barrier`` waits for the sync round, and a
    send's ``get_vars`` pull the updated parameters (``executor.send``).
    The gradients are read out of the env after the op loop (the
    trainer's program has no optimizer ops: they run on the pservers),
    each by one device-to-host copy, and so one host sync. A program of
    transport ops alone sends the values of its feeds and scope, as the
    JAX executor's host-only branch does. ``ParallelExecutor``
    (``parallel_executor.py``), which runs a block on a DTensor mesh,
    refuses these ops, as the JAX package has no pserver training under
    a mesh.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time as _time
import weakref
import zlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..flags import FLAGS
from ..observability import metrics as _metrics, tracing as _tracing
from . import core
from .framework import Program, Variable, default_main_program
from .readers import READER_CREATE_OP_TYPES, DeviceBatch, create_host_reader
from .registry import EmitCtx, exec_op_descs, fold_seed, plan_grad_records
from .selected_rows import SelectedRows, is_selected_rows

_m_step_ms = _metrics.histogram("executor.step_ms")

_SKIP_OP_TYPES = frozenset({"feed", "fetch"})
# parameter-server transport: host ops around the op loop, never in it
# (send_vars is the reference's async-send variant, send_vars_op.cc —
# the same transport, no barrier follows it)
_SEND_OP_TYPES = frozenset({"send", "send_vars", "send_barrier"})
DIST_OP_TYPES = _SEND_OP_TYPES | {"recv", "prefetch"}
# reader ops: the host pre-pass runs them, the op loop never does
_READER_OP_TYPES = READER_CREATE_OP_TYPES | {"read"}
# ops the op loop never runs
_HOST_OP_TYPES = _SKIP_OP_TYPES | _READER_OP_TYPES | DIST_OP_TYPES
_IO_OP_TYPES = frozenset({"save", "save_combine", "load", "load_combine"})


class Scope:
    """name -> tensor map (reference framework/scope.h:39)."""

    def __init__(self, parent: Optional["Scope"] = None):
        self._vars: Dict[str, Any] = {}
        self.parent = parent

    def find_var(self, name: str):
        s: Optional[Scope] = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s.parent
        return None

    def has_var(self, name: str) -> bool:
        return self.find_var(name) is not None

    def set_var(self, name: str, value):
        self._vars[name] = value

    def var_names(self):
        return list(self._vars)

    def new_scope(self) -> "Scope":
        return Scope(parent=self)


_global_scope = Scope()

# per-thread guard stack, as in the JAX package: a thread with no guards
# of its own sees the process root scope
_scope_tls = threading.local()


def global_scope() -> Scope:
    stack = getattr(_scope_tls, "stack", None)
    return stack[-1] if stack else _global_scope


@contextlib.contextmanager
def scope_guard(scope: Scope):
    stack = getattr(_scope_tls, "stack", None)
    if stack is None:
        stack = _scope_tls.stack = []
    stack.append(scope)
    try:
        yield
    finally:
        # pop OUR frame by identity, unwinding frames the body left above
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is scope:
                del stack[i:]
                break


def whole(v):
    """A scope value as a plain tensor: a DTensor (state a
    ParallelExecutor sharded) gathered whole — a collective that every
    rank of its mesh must run — any other value as itself."""
    if type(v) is not torch.Tensor and isinstance(v, torch.Tensor) and \
            hasattr(v, "full_tensor") and hasattr(v, "device_mesh"):
        return v.full_tensor()
    return v


def is_writer() -> bool:
    """Whether this process writes files a save produces: rank 0 of an
    initialized process group (every rank gathers the values; one
    writes), or a process with none."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def writers_done():
    """Every rank waits here until rank 0 has written (a barrier in a
    world of more than one rank)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size() > 1:
        dist.barrier()


def _to_numpy(v):
    v = whole(v)
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _fetched_numpy(v):
    """A fetched value as numpy: a bfloat16 tensor as its exact float32
    widening (numpy has no bfloat16 type without ml_dtypes), a
    SelectedRows as one with numpy rows and value, any other as
    itself."""
    if is_selected_rows(v):
        return SelectedRows(_fetched_numpy(v.rows), _fetched_numpy(v.value),
                            v.height)
    if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16:
        v = v.float()
    return _to_numpy(v)


def _as_feed(v, device):
    """A feed value as a tensor (or a SelectedRows) on ``device``."""
    if is_selected_rows(v):
        return SelectedRows(_as_feed(v.rows, device), _as_feed(v.value,
                                                               device),
                            v.height)
    if not isinstance(v, torch.Tensor):
        v = np.asarray(v)
        if v.dtype.name == "bfloat16":
            # numpy's bfloat16 (ml_dtypes) has no torch counterpart to
            # convert from: reinterpret its 16-bit payload
            v = torch.from_numpy(np.asarray(v, order="C").view(np.uint16)) \
                .view(torch.bfloat16)
        else:
            v = torch.as_tensor(v)
    return v.to(device)


def fetch_var(name: str, scope: Optional[Scope] = None,
              return_numpy: bool = True):
    """The scope's value of ``name``: numpy (a bfloat16 value as its
    exact float32 widening, a SelectedRows with numpy fields), or the
    tensor with ``return_numpy=False``."""
    scope = scope or global_scope()
    v = scope.find_var(name)
    if v is None:
        raise ValueError(f"var '{name}' not found in scope")
    v = whole(v)
    return _fetched_numpy(v) if return_numpy else v


def _io_path(op_type: str, path: str) -> str:
    """The actual on-disk path: numpy appends .npy/.npz when missing, so
    normalize once here — save's overwrite check, load's lookup, and the
    write all agree for any attr spelling."""
    if op_type in ("save", "load"):
        return path if path.endswith(".npy") else path + ".npy"
    return path if path.endswith(".npz") else path + ".npz"


def _run_io_host_ops(ops, scope: Scope, device=None,
                     env: Optional[Dict[str, Any]] = None):
    """Execute save/load host ops (reference operators/save_op.cc,
    load_combine_op.cc) — the JAX package's ``_run_io_host_ops``. Formats
    match io.py: .npy per var, .npz combined. Every failure condition
    (missing var, overwrite conflict) is checked BEFORE any file is
    written, so an abort can't leave a partial checkpoint on disk. A save
    reads ``env`` (this run's values) before ``scope``, DTensors whole;
    in a process group every rank gathers and rank 0 writes, and every
    rank waits for the files before the next load or the return; a load sets the
    scope (and ``env``) to a tensor on ``device``, moved there once.
    Loads need a device; saves do not."""
    env = {} if env is None else env

    def lookup(n):
        return env[n] if n in env else scope.find_var(n)

    will_load = set()  # vars produced by earlier load ops in this group
    for op in ops:
        t = op.type
        if t in ("load", "load_combine"):
            if device is None:
                raise ValueError(
                    f"{t} op: a load needs the device its tensors go to — "
                    "run it through an Executor")
            will_load.update(op.outputs.get("Out", []))
            continue
        for n in op.inputs.get("X", []):
            if lookup(n) is None and n not in will_load:
                raise RuntimeError(
                    f"save op: var '{n}' not found in scope — nothing "
                    "was written")
        path = _io_path(t, str(op.attrs["file_path"]))
        if not op.attrs.get("overwrite", True) and os.path.exists(path):
            raise RuntimeError(f"save op: '{path}' exists and "
                               "overwrite=False — nothing was written")
    saved = False
    for op in ops:
        t = op.type
        path = _io_path(t, str(op.attrs["file_path"]))
        if t in ("save", "save_combine"):
            names = op.inputs.get("X", [])
            arrays = {n: _to_numpy(lookup(n)) for n in names}
            saved = True
            if not is_writer():
                continue
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            if t == "save":
                np.save(path, arrays[names[0]])
            else:
                np.savez(path, **arrays)
            continue
        if saved:
            writers_done()
            saved = False
        names = op.outputs.get("Out", [])
        if t == "load":
            loaded = {names[0]: np.load(path)}
        else:
            with np.load(path) as payload:
                loaded = {n: payload[n] for n in names}
        for n, arr in loaded.items():
            v = torch.from_numpy(np.array(arr, copy=True)).to(device)
            env[n] = v
            scope.set_var(n, v)
    if saved:
        writers_done()


def _segments(ops):
    """Split an op list into maximal runs of host io ops and of the
    others, in order: [(is_io, [op, ...]), ...]."""
    out: List[Any] = []
    for od in ops:
        io = od.type in _IO_OP_TYPES
        if out and out[-1][0] == io:
            out[-1][1].append(od)
        else:
            out.append((io, [od]))
    return out


def _as_name(v) -> str:
    return v.name if isinstance(v, Variable) else str(v)


def _conform_slot(block, name: str, slot):
    """Reshape/cast a popped host batch to the declared out-var desc (the
    role DataFeeder's converters play on the feed path): record files
    store flat samples (e.g. mnist's 784-vector), the graph declares
    [-1, 1, 28, 28]. A tensor from a double buffer was conformed in its
    decode thread already."""
    if isinstance(slot, torch.Tensor):
        return slot
    var = block._var_recursive(name)
    if var is None or var.shape is None:
        return slot
    shape = list(var.shape)
    if shape.count(-1) <= 1 and tuple(shape) != tuple(slot.shape):
        slot = slot.reshape(shape)
    want = np.dtype(core.convert_dtype(var.dtype)
                    if var.dtype != "bfloat16" else "float32")
    if slot.dtype != want:
        slot = slot.astype(want)
    return slot


def _run_reader_host_ops(block, reader_ops, scope: Scope, device):
    """Host pre-pass over a block's reader ops (the JAX package's
    ``_run_reader_host_ops``; reference executor.cc runs reader ops as
    ordinary OperatorBase). Creation ops (re)build the host reader stack
    into scope — so re-running the startup program resets the pipeline,
    like the reference's ReInit — with ``device`` as the double buffer's
    target. `read` ops pop one minibatch each. Returns (feeds, the
    popped batches that carry a copy event). Raises core.EOFException at
    end of data."""
    feeds: Dict[str, Any] = {}
    copied: List[DeviceBatch] = []
    for op in reader_ops:
        t = op.desc.type
        if t in READER_CREATE_OP_TYPES:
            out_name = op.desc.outputs["Out"][0]
            inner_names = op.desc.inputs.get("UnderlyingReader") or []
            inner = scope.find_var(inner_names[0]) if inner_names else None
            old = scope.find_var(out_name)
            if old is not None and hasattr(old, "close"):
                old.close()  # free prefetch threads / file handles
            out_var = block._var_recursive(out_name)
            slots = out_var.desc.reader_slots if out_var is not None else None
            scope.set_var(out_name, create_host_reader(
                t, op.desc.attrs, inner, slots=slots, device=device))
            continue
        reader_name = op.desc.inputs["Reader"][0]
        reader = scope.find_var(reader_name)
        if reader is None or not hasattr(reader, "read_next"):
            raise RuntimeError(
                f"reader var '{reader_name}' has no host reader in scope — "
                "run the startup program first")
        try:
            sample = reader.read_next()
        except StopIteration:
            raise core.EOFException(
                f"reader '{reader_name}' is exhausted") from None
        out_names = op.desc.outputs["Out"]
        if len(sample) != len(out_names):
            raise ValueError(
                f"reader '{reader_name}' produced {len(sample)} slots, the "
                f"read op declares {len(out_names)}")
        if getattr(sample, "ready", None) is not None:
            copied.append(sample)
        for name, slot in zip(out_names, sample):
            if isinstance(slot, tuple):  # (padded, lengths) ragged pair
                feeds[name], feeds[name + "@LEN"] = slot
            else:
                feeds[name] = _conform_slot(block, name, slot)
    return feeds, copied


def _block_io(block, feed_names: set):
    """Classify vars of a block: state read (from scope) and state written
    (persistable -> survives the run). Reader and transport ops are host
    ops: they neither read nor write the device state."""
    produced = set(feed_names)
    state_in: List[str] = []
    state_out: List[str] = []
    persistable = {
        name for name, var in block.vars.items() if var.persistable
    }
    for op in block.ops:
        if op.desc.type in _HOST_OP_TYPES:
            continue
        for n in op.desc.input_names():
            if n and n not in produced and n not in state_in:
                state_in.append(n)
        for n in op.desc.output_names():
            if n:
                produced.add(n)
                if n in persistable and n not in state_out:
                    state_out.append(n)
    return state_in, state_out


def _dist_host_ops(block):
    """(send ops, recv ops, prefetch ops) of a block, cached per program
    version (the JAX executor's ``_dist_host_ops``)."""
    program = block.program
    cached = getattr(program, "_dist_ops_cache", None)
    if cached is None or cached[0] != program._version:
        sends = [op for op in block.ops if op.desc.type in _SEND_OP_TYPES]
        recvs = [op for op in block.ops if op.desc.type == "recv"]
        prefetches = [op for op in block.ops if op.desc.type == "prefetch"]
        program._dist_ops_cache = cached = (
            program._version, sends, recvs, prefetches)
    return cached[1], cached[2], cached[3]


def _pulled(arr, device):
    """A pulled parameter (a read-only view over its RPC frame) as a
    tensor on ``device``: one host-to-device copy."""
    return torch.tensor(arr, device=device)


def _run_recv_ops(recv_ops, scope: Scope, device):
    """Pull current param values from their pservers into scope BEFORE the
    step (reference recv_op.cc + concat on the trainer)."""
    from ..distributed.param_server import get_client

    for op in recv_ops:
        eps = op.desc.attrs.get("endpoints", {})
        for name in op.desc.outputs.get("Out", []):
            ep = eps.get(name)
            if ep is None:
                raise ValueError(f"recv op has no endpoint for '{name}'")
            scope.set_var(name, _pulled(get_client(ep).call(
                "get_param", name, copy_result=False), device))


def _run_prefetch_ops(prefetch_ops, feeds: Dict[str, Any], scope: Scope,
                      device):
    """Row-granular embedding prefetch (reference prefetch_op.cc): pull
    ONLY the batch's unique rows from the pserver into a sub-table fed to
    the step, plus locally-remapped ids. The sub-table is padded to the
    flat id count, so its shape depends only on the batch's. The
    unique-id map is stashed in scope for the send op to translate the
    SelectedRows grad rows back to global before the push. Ids fed as a
    card tensor come to the host by one copy."""
    from ..distributed.param_server import get_client
    from ..distributed.rpc import _host

    for op in prefetch_ops:
        attrs = op.desc.attrs
        ids_name = op.desc.inputs["Ids"][0]
        sub_name = op.desc.outputs["Out"][0]
        remap_name = op.desc.outputs["Remap"][0]
        ids = feeds.get(ids_name)
        if ids is None:
            raise RuntimeError(
                f"prefetch op needs '{ids_name}' in the feed (ids must be "
                "host-visible to pull their rows)")
        ids = _host(ids)
        flat = ids.reshape(-1).astype(np.int64)
        uniq, inverse = np.unique(flat, return_inverse=True)
        cap = max(1, flat.size)
        pad_fill = uniq[0] if uniq.size else 0
        uniq_padded = np.full((cap,), pad_fill, dtype=np.int64)
        uniq_padded[:uniq.size] = uniq
        sub = _pulled(get_client(attrs["endpoint"]).call(
            "get_rows", attrs["param"], uniq_padded, copy_result=False),
            device)
        padding_idx = int(attrs.get("padding_idx", -1))
        if padding_idx != -1:
            # the op-level padding zeroing was disabled at transpile time;
            # zero the padding id's row here instead (each unique id owns
            # exactly one row, so this is equivalent)
            pos = np.searchsorted(uniq, padding_idx)
            if pos < uniq.size and uniq[pos] == padding_idx:
                sub[int(pos)] = 0
        feeds[sub_name] = sub
        feeds[remap_name] = inverse.reshape(ids.shape).astype(np.int64)
        scope.set_var(f"{attrs['param']}@PREFETCH_IDS", uniq_padded)


def _sent_values(names, env: Dict[str, Any], scope: Scope):
    """The values the send ops push: this run's (a gradient the op loop
    computed, or a feed), else the scope's."""
    vals = {}
    for n in names:
        v = env.get(n)
        if v is None:
            v = scope.find_var(n)
        if v is None:
            raise RuntimeError(
                f"send op: var '{n}' has no value (no op of the program "
                "produces it, and it is neither fed nor in the scope)")
        vals[n] = v
    return vals


def _run_send_ops(send_ops, values: Dict[str, Any], scope: Scope, device):
    """Push computed gradients to their pservers AFTER the step (reference
    send_op.cc AsyncSendVariable; send_barrier_op for sync rounds). Each
    gradient comes to the host by one device-to-host copy (a
    SelectedRows' rows and value, one each). The barrier waits on the
    round number the pushes were assigned to, over a DEDICATED
    connection — on the shared channel a blocking barrier would starve
    other trainer threads' pushes to the same endpoint."""
    from ..distributed.param_server import get_client, note_barrier_reply
    from ..distributed.rpc import _host

    push_round: Dict[str, int] = {}  # endpoint -> round of this step's sends
    for op in send_ops:
        attrs = op.desc.attrs
        if op.desc.type == "send_barrier":
            tid = int(attrs.get("trainer_id", 0))
            for ep in attrs.get("endpoints", []):
                # trainer_id rides along so the pserver's failure detector
                # refreshes THIS trainer's heartbeat lease while it waits —
                # a parked trainer must never be evicted as dead, or its
                # pending pushes would be withdrawn from the round
                resp = get_client(ep, channel=f"barrier.{tid}").call(
                    "barrier", push_round.get(ep), tid)
                note_barrier_reply(ep, tid, resp)
            continue
        eps = attrs.get("endpoints", {})
        params = attrs.get("params", {})
        sparse_remap = attrs.get("sparse_remap", {})
        trainer_id = int(attrs.get("trainer_id", 0))
        for gname in op.desc.inputs.get("X", []):
            v = values[gname]
            if is_selected_rows(v):
                v = SelectedRows(_host(v.rows), _host(v.value), v.height)
            else:
                v = _host(v)
            if gname in sparse_remap and is_selected_rows(v):
                # prefetched table: grad rows are LOCAL sub-table indices;
                # translate back to global ids (and drop padding-id rows —
                # the reference zeroes their grad) before the push
                info = sparse_remap[gname]
                idmap = scope.find_var(f"{info['param']}@PREFETCH_IDS")
                if idmap is None:
                    raise RuntimeError(
                        f"send op: no prefetch id map for '{info['param']}' "
                        "— did the prefetch op run this step?")
                rows = idmap[v.rows.astype(np.int64)]
                vals = v.value
                pad = int(info.get("padding_idx", -1))
                if pad != -1:
                    keep = rows != pad
                    rows, vals = rows[keep], vals[keep]
                v = SelectedRows(rows.astype(np.int64), vals,
                                 int(info["vocab"]))
            elif gname in sparse_remap:
                # a remapped grad that arrives dense is [batch-ids, dim]
                # sub-table shaped — pushing it against the [vocab, dim]
                # pserver param would fail (or mis-apply) far from the
                # cause; fail HERE with the cause named
                info = sparse_remap[gname]
                raise RuntimeError(
                    f"send op: grad '{gname}' for prefetched table "
                    f"'{info['param']}' arrived dense (shape "
                    f"{v.shape}) but must be SelectedRows over local "
                    "sub-table rows — the lookup_table grad emitter fell "
                    "back to a dense gradient")
            resp = get_client(eps[gname]).call(
                "push_grad", params.get(gname, gname), v, trainer_id)
            ep = eps[gname]
            if ep not in push_round and isinstance(resp, dict):
                push_round[ep] = resp.get("round")
        # the reference send op's get_vars: pull AFTER this op's pushes —
        # and after the round they joined has APPLIED (a sync server only
        # merges once every trainer pushed; barrier is a no-op on async)
        recv_eps = attrs.get("recv_endpoints", {})
        out_names = op.desc.outputs.get("Out", [])
        if out_names:
            for ep in {recv_eps[n] for n in out_names}:
                if ep in push_round:
                    get_client(ep, channel=f"barrier.{trainer_id}").call(
                        "barrier", push_round[ep], trainer_id)
            for name in out_names:
                scope.set_var(name, _pulled(get_client(recv_eps[name]).call(
                    "get_param", name, copy_result=False), device))


def _check_nan_inf(named):
    """Raise FloatingPointError naming the first floating var (a
    SelectedRows by its value) holding a NaN or an Inf: one
    ``isfinite().all()`` a var, read on the host."""
    for name, v in named:
        t = v.value if is_selected_rows(v) else v
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"var '{name}' contains NaN/Inf")


_MATMUL_PRECISIONS = ("highest", "high", "default")


def _matmul_precision():
    """The run's float32 product precision, as the JAX executor runs its
    block under ``jax.default_matmul_precision(FLAGS['matmul_precision'])``:
    'highest' holds TF32 off in cuBLAS and cuDNN for the run and then
    restores the caller's settings; 'high' and 'default' leave them."""
    from ..flags import FLAGS

    value = FLAGS["matmul_precision"]
    if value not in _MATMUL_PRECISIONS:
        raise ValueError(f"FLAGS['matmul_precision'] = {value!r}; known: "
                         f"{list(_MATMUL_PRECISIONS)}")
    if value == "highest":
        return core.FULL_FLOAT32.held()
    return contextlib.nullcontext()


class _StepCounter:
    def __init__(self):
        self._n = 0

    def next(self) -> int:
        self._n += 1
        return self._n


_step_counter = _StepCounter()


def _next_seed(program: Program) -> int:
    """The run's root seed. A seeded program is deterministic (its own run
    counter, salted with a content hash of the program so that startup and
    main programs sharing one random_seed draw independent streams); seed
    0 draws from a process-global counter (fresh randomness each run)."""
    if program.random_seed:
        if getattr(program, "_rng_salt_version", None) != program._version:
            program._rng_salt = zlib.crc32(program.to_bytes())
            program._rng_salt_version = program._version
        program._rng_tick += 1
        return fold_seed(fold_seed(program.random_seed, program._rng_salt),
                         program._rng_tick)
    return fold_seed(_step_counter.next(), 0)


class Executor:
    """Reference python/paddle/fluid/executor.py:181 — same run() contract.
    ``place``: ``CPUPlace()``, ``CUDAPlace(i)``, a ``torch.device`` or a
    device string; ``None`` means the card, and raises without one."""

    def __init__(self, place=None):
        self.place = place if place is not None else core.default_place()
        self.device = core.as_device(self.place)
        # per program (weakly keyed): (version, feed names) -> the block's
        # ops, state split and grad-record plan
        self._cache: "weakref.WeakKeyDictionary[Program, Dict[Any, Any]]" = (
            weakref.WeakKeyDictionary()
        )

    def run(
        self,
        program: Optional[Program] = None,
        feed: Optional[Dict[str, Any]] = None,
        fetch_list: Optional[Sequence[Any]] = None,
        scope: Optional[Scope] = None,
        return_numpy: bool = True,
        use_program_cache: bool = True,
    ):
        program = program or default_main_program()
        t0 = _time.perf_counter()
        with _tracing.span("executor.step", program_version=program._version), \
                _matmul_precision(), core.F32_BF16_REDUCTION.held():
            out = self._run_body(program, feed or {}, fetch_list or [],
                                 scope or global_scope(), return_numpy,
                                 use_program_cache)
        step_ms = (_time.perf_counter() - t0) * 1000.0
        _m_step_ms.observe(step_ms)
        if FLAGS["autotune"] and return_numpy and \
                not getattr(self, "_last_run_built", True):
            # feed the tuning cache's per-shape step log so a repeat
            # session can skip re-measuring this (program, feed-shape)
            # pair. Runs that built the program's plan are excluded, and
            # so are return_numpy=False runs: only the fetch to numpy
            # waits for the card, so without it the wall clock measures
            # the launches, not the step
            from ..autotune.measure import note_step_timing

            try:
                note_step_timing("executor.step", program, feed or {},
                                 step_ms)
            except Exception:  # the log is evidence, the run is not
                pass
        return out

    def _entry(self, program, feed_names, fetch_names, use_program_cache):
        key = (program._version, tuple(sorted(feed_names)))
        prog_cache = self._cache.setdefault(program, {})
        entry = prog_cache.get(key) if use_program_cache else None
        self._last_run_built = entry is None
        if entry is None:
            if FLAGS["verify_programs"]:
                # refuse a malformed program here, with op-indexed
                # diagnostics, instead of deep inside an emitter.
                # Structural checks only: one O(ops) walk per miss
                from ..analysis.verify import assert_valid

                assert_valid(
                    program, check_shapes=False,
                    fetch_targets=list(fetch_names),
                    header="program failed verification before lowering "
                           "(FLAGS['verify_programs'] is on)")
            block = program.global_block()
            ops = [op.desc for op in block.ops
                   if op.desc.type not in _HOST_OP_TYPES]
            state_in, state_out = _block_io(block, set(feed_names))
            # runs of io ops and of device ops, in order; each device
            # run plans its own grad records
            segments = [(io, seg, None if io else plan_grad_records(seg))
                        for io, seg in _segments(ops)]
            entry = (state_in, state_out, segments)
            if use_program_cache:
                prog_cache[key] = entry
        return entry

    def _run_body(self, program, feed, fetch_list, scope, return_numpy,
                  use_program_cache):
        dev = self.device
        block = program.global_block()
        # the block's reader ops, per program version: a reader-less
        # program pays one dict lookup a step
        prog_cache = self._cache.setdefault(program, {})
        reader_ops = prog_cache.get(("readers", program._version))
        if reader_ops is None:
            reader_ops = [op for op in block.ops
                          if op.desc.type in _READER_OP_TYPES]
            prog_cache[("readers", program._version)] = reader_ops
        with _tracing.span("executor.reader"):
            reader_feeds, copied = _run_reader_host_ops(
                block, reader_ops, scope, dev)
        host_feeds = {**feed, **reader_feeds}
        send_ops, recv_ops, prefetch_ops = _dist_host_ops(block)
        if recv_ops:
            with _tracing.span("executor.recv"):
                _run_recv_ops(recv_ops, scope, dev)
        if prefetch_ops:
            with _tracing.span("executor.prefetch"):
                _run_prefetch_ops(prefetch_ops, host_feeds, scope, dev)
        feeds = {k: _as_feed(v, dev) for k, v in host_feeds.items()}
        if copied:
            # the batches were copied on the double buffer's stream: this
            # stream waits for the copies before its first op, and the
            # allocator learns that this stream uses the tensors
            stream = torch.cuda.current_stream(dev)
            for batch in copied:
                stream.wait_event(batch.ready)
                for t in batch.tensors():
                    t.record_stream(stream)
        fetch_names = [_as_name(v) for v in fetch_list]
        state_in, state_out, segments = self._entry(
            program, list(feeds), fetch_names, use_program_cache)
        missing = [n for n in state_in if not scope.has_var(n)]
        if missing:
            raise RuntimeError(
                f"vars {missing} are read by the program but not "
                "initialized in scope — run the startup program first or "
                "feed them")
        env: Dict[str, Any] = {n: whole(scope.find_var(n))
                               for n in state_in}
        env.update(feeds)
        ctx = EmitCtx(device=dev, root_seed=_next_seed(program),
                      program=program)
        sent = [n for op in send_ops for n in op.desc.inputs.get("X", [])
                if n]
        keep = frozenset(fetch_names) | frozenset(sent)
        t0 = _time.perf_counter() if FLAGS["benchmark"] else 0.0
        for io, seg, plan in segments:
            if io:
                _run_io_host_ops(seg, scope, dev, env)
            else:
                exec_op_descs(ctx, seg, env, keep=keep, plan=plan)
        if FLAGS["benchmark"]:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            print(f"[benchmark] run took "
                  f"{(_time.perf_counter() - t0) * 1000:.3f} ms")
        for n in state_out:
            if n in env:
                scope.set_var(n, env[n].detach())
        if send_ops:
            with _tracing.span("executor.send"):
                _run_send_ops(send_ops, _sent_values(sent, env, scope),
                              scope, dev)
        # a program of host ops alone (none, or readers and io) fetches
        # from the scope, as the JAX executor's host-only path does
        host_only = all(io for io, _, _ in segments)
        fetches = []
        for n in fetch_names:
            if n not in env and host_only and scope.has_var(n):
                env[n] = whole(scope.find_var(n))
            if n not in env:
                raise ValueError(
                    f"fetch target '{n}' was not produced by the block")
            v = env[n].detach()
            fetches.append(_fetched_numpy(v) if return_numpy else v)
        if FLAGS["check_nan_inf"] and not host_only:
            # reference FLAGS_check_nan_inf sweep (executor.cc:352-360)
            # over the new state, then the fetches, in the JAX
            # executor's order (its new-state dict comes back from jit
            # in name order)
            _check_nan_inf([(n, env[n]) for n in sorted(state_out)
                            if n in env]
                           + [(n, env[n]) for n in fetch_names])
        return fetches

    def close(self):
        self._cache.clear()
