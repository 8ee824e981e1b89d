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

Not ported yet: the send/recv transport; a program holding such an op
raises. ``ParallelExecutor`` (``parallel_executor.py``) runs a block on a
DTensor mesh.
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

from ..observability import metrics as _metrics, tracing as _tracing
from . import core
from .framework import Program, Variable, default_main_program
from .readers import READER_CREATE_OP_TYPES, DeviceBatch, create_host_reader
from .registry import EmitCtx, exec_op_descs, fold_seed, plan_grad_records
from .selected_rows import SelectedRows, is_selected_rows

_m_step_ms = _metrics.histogram("executor.step_ms")

_SKIP_OP_TYPES = frozenset({"feed", "fetch"})
# host-side op types of the JAX executor not ported yet (pserver
# transport)
_NOT_PORTED_OP_TYPES = frozenset({
    "send", "recv", "send_barrier", "send_vars", "prefetch",
})
# reader ops: the host pre-pass runs them, the op loop never does
_READER_OP_TYPES = READER_CREATE_OP_TYPES | {"read"}
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
        v = torch.as_tensor(np.asarray(v))
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
    (persistable -> survives the run). Reader ops are the host pre-pass's:
    they neither read nor write the device state."""
    produced = set(feed_names)
    state_in: List[str] = []
    state_out: List[str] = []
    persistable = {
        name for name, var in block.vars.items() if var.persistable
    }
    for op in block.ops:
        if op.desc.type in _SKIP_OP_TYPES or \
                op.desc.type in _READER_OP_TYPES:
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
        _m_step_ms.observe((_time.perf_counter() - t0) * 1000.0)
        return out

    def _entry(self, program, feed_names, use_program_cache):
        key = (program._version, tuple(sorted(feed_names)))
        prog_cache = self._cache.setdefault(program, {})
        entry = prog_cache.get(key) if use_program_cache else None
        if entry is None:
            block = program.global_block()
            bad = sorted({op.desc.type for op in block.ops
                          if op.desc.type in _NOT_PORTED_OP_TYPES})
            if bad:
                raise NotImplementedError(
                    f"op types {bad} (pserver transport) are not yet "
                    "ported to paddle_tpu_torch's Executor")
            ops = [op.desc for op in block.ops
                   if op.desc.type not in _SKIP_OP_TYPES
                   and op.desc.type not in _READER_OP_TYPES]
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
        feeds = {k: _as_feed(v, dev)
                 for k, v in {**feed, **reader_feeds}.items()}
        if copied:
            # the batches were copied on the double buffer's stream: this
            # stream waits for the copies before its first op, and the
            # allocator learns that this stream uses the tensors
            stream = torch.cuda.current_stream(dev)
            for batch in copied:
                stream.wait_event(batch.ready)
                for t in batch.tensors():
                    t.record_stream(stream)
        state_in, state_out, segments = self._entry(
            program, list(feeds), use_program_cache)
        missing = [n for n in state_in if not scope.has_var(n)]
        if missing:
            raise RuntimeError(
                f"vars {missing} are read by the program but not "
                "initialized in scope — run the startup program first or "
                "feed them")
        fetch_names = [_as_name(v) for v in fetch_list]
        env: Dict[str, Any] = {n: whole(scope.find_var(n))
                               for n in state_in}
        env.update(feeds)
        ctx = EmitCtx(device=dev, root_seed=_next_seed(program),
                      program=program)
        keep = frozenset(fetch_names)
        for io, seg, plan in segments:
            if io:
                _run_io_host_ops(seg, scope, dev, env)
            else:
                exec_op_descs(ctx, seg, env, keep=keep, plan=plan)
        for n in state_out:
            if n in env:
                scope.set_var(n, env[n].detach())
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
        return fetches

    def close(self):
        self._cache.clear()
