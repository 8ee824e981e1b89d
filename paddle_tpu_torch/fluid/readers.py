"""Host-side reader objects backing in-graph reader VARIABLES — the
counterpart of ``paddle_tpu/fluid/readers.py``.

Reference design (operators/reader/): a reader is a Variable of
VarType::READER holding a ReaderHolder; `create_*_reader` ops build a
decorator stack (file reader -> shuffle -> batch -> double_buffer) and
`read_op` pops one minibatch from it into LoD tensors
(operators/reader/create_double_buffer_reader_op.cc, open_files_op.cc,
read_op.cc; Python layers/io.py:281-490).

As in the JAX package, the Executor runs reader ops as a HOST PRE-PASS
each step: creation ops (re)build the host reader stack into the scope,
`read` pops a batch from it into the step's feeds. The double-buffer
decorator is where the overlap lives: a decode thread conforms batch N+1
on the host while a transfer thread copies it to the card — from
page-locked memory, on a CUDA stream of its own, recording an event the
executor's stream waits on — while the card still runs batch N.

Protocol: read_next() returns a tuple with one entry per declared slot —
a dense array, or a (padded, lengths) pair for lod_level>0 slots — and
raises StopIteration at end of data; reset() rewinds; close() frees
threads/files.
"""
from __future__ import annotations

import pickle
import queue
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..native.recordio import RecordIOReader, multi_file_reader
from ..observability import metrics as _metrics, tracing as _tracing


# process-wide totals are exact and shared; the RATE is tracked
# PER PIPELINE (per _Throughput instance) — a train reader and an eval
# reader interleaving must not measure each other's inter-batch gaps
_m_reader_gauge = _metrics.gauge("reader.records_per_sec")
_m_reader_batches = _metrics.counter("reader.batches")
_m_reader_records = _metrics.counter("reader.records")


class _Throughput:
    """Pipeline throughput -> `reader.records_per_sec` gauge (+ exact
    batch/record counters). One instance per BatchReader — the
    batch-assembly boundary, where every record of the pipeline passes
    exactly once whatever decorators wrap it. EWMA over instantaneous
    batch-to-batch rates so one slow disk seek doesn't zero the gauge;
    the shared gauge reports the most recently active pipeline's rate."""

    def __init__(self):
        self._mu = threading.Lock()
        self._last: Optional[float] = None
        self._rate = 0.0

    def batch(self, n: int):
        now = time.perf_counter()
        _m_reader_batches.inc()
        _m_reader_records.inc(n)
        with self._mu:
            if self._last is not None and now > self._last:
                inst = n / (now - self._last)
                self._rate = inst if self._rate == 0.0 else (
                    0.8 * self._rate + 0.2 * inst)
                _m_reader_gauge.set(self._rate)
            self._last = now


__all__ = [
    "HostReader", "RecordIOFileReader", "MultiFileReader", "ShuffleReader",
    "BatchReader", "MultiPassReader", "DoubleBufferReader", "DeviceBatch",
    "create_host_reader", "READER_CREATE_OP_TYPES",
]


class HostReader:
    """Base: an exhaustible, resettable stream of slot tuples."""

    def read_next(self) -> Tuple[Any, ...]:
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError

    def close(self):
        pass


class _FileBacked(HostReader):
    """Shared logic for recordio-backed readers: records are pickled slot
    tuples (see recordio_writer.convert_reader_to_recordio_file)."""

    def _next_record(self) -> Optional[bytes]:
        raise NotImplementedError

    def read_next(self):
        rec = self._next_record()
        if rec is None:
            raise StopIteration
        sample = pickle.loads(rec)
        if not isinstance(sample, tuple):
            sample = (sample,)
        return sample


class RecordIOFileReader(_FileBacked):
    """One recordio file (reference create_recordio_file_reader_op.cc)."""

    def __init__(self, filename: str):
        self._filename = filename
        self._r = RecordIOReader(filename)

    def _next_record(self):
        return self._r.read()

    def reset(self):
        self._r.close()
        self._r = RecordIOReader(self._filename)

    def close(self):
        self._r.close()


class MultiFileReader(_FileBacked):
    """Multiple shards, one after the other (reference open_files_op.cc;
    the JAX package's native path interleaves them across threads)."""

    def __init__(self, filenames: Sequence[str]):
        self._filenames = list(filenames)
        self._it = multi_file_reader(self._filenames)

    def _next_record(self):
        return next(self._it, None)

    def reset(self):
        self._it = multi_file_reader(self._filenames)


class _Decorated(HostReader):
    def __init__(self, inner: HostReader):
        self.inner = inner

    def reset(self):
        self.inner.reset()

    def close(self):
        self.inner.close()


class ShuffleReader(_Decorated):
    """Buffered shuffle (reference create_shuffle_reader_op.cc)."""

    def __init__(self, inner: HostReader, buffer_size: int, seed: int = 0):
        super().__init__(inner)
        self._buffer_size = buffer_size
        self._rng = random.Random(seed or None)
        self._buf: List[Tuple] = []
        self._eof = False

    def read_next(self):
        if not self._buf and not self._eof:
            try:
                while len(self._buf) < self._buffer_size:
                    self._buf.append(self.inner.read_next())
            except StopIteration:
                self._eof = True
            self._rng.shuffle(self._buf)
        if not self._buf:
            raise StopIteration
        return self._buf.pop()

    def reset(self):
        self._buf, self._eof = [], False
        self.inner.reset()


class BatchReader(_Decorated):
    """Stack `batch_size` samples along a new leading axis (reference
    create_batch_reader_op.cc). Slots declared with lod_level>0 hold
    variable-length samples: those are padded to the batch max and emitted
    as a (padded, lengths) pair — the padded+@LEN ragged representation
    (layers/sequence.py) the read op feeds downstream."""

    def __init__(self, inner: HostReader, batch_size: int,
                 drop_last: bool = False,
                 slots: Optional[List[Dict[str, Any]]] = None):
        super().__init__(inner)
        self._batch_size = batch_size
        self._drop_last = drop_last
        self._lod = [int(s.get("lod_level", 0)) for s in (slots or [])]
        self._throughput = _Throughput()

    def read_next(self):
        samples = []
        with _tracing.span("reader.batch"):
            try:
                while len(samples) < self._batch_size:
                    samples.append(self.inner.read_next())
            except StopIteration:
                if not samples or (self._drop_last
                                   and len(samples) < self._batch_size):
                    raise StopIteration from None
            self._throughput.batch(len(samples))
        slots = []
        for i, vals in enumerate(zip(*samples)):
            arrs = [np.asarray(v) for v in vals]
            if i < len(self._lod) and self._lod[i] > 0:
                maxlen = max(a.shape[0] for a in arrs)
                padded = np.zeros(
                    (len(arrs), maxlen) + arrs[0].shape[1:],
                    dtype=arrs[0].dtype,
                )
                for j, a in enumerate(arrs):
                    padded[j, : a.shape[0]] = a
                lengths = np.asarray([a.shape[0] for a in arrs],
                                     dtype=np.int32)
                slots.append((padded, lengths))
            else:
                slots.append(np.stack(arrs))
        return tuple(slots)


class MultiPassReader(_Decorated):
    """Replay the underlying reader N times (reference
    create_multi_pass_reader_op.cc)."""

    def __init__(self, inner: HostReader, pass_num: int):
        super().__init__(inner)
        self._pass_num = pass_num
        self._pass = 0

    def read_next(self):
        try:
            return self.inner.read_next()
        except StopIteration:
            self._pass += 1
            if self._pass >= self._pass_num:
                raise
            self.inner.reset()
            return self.inner.read_next()

    def reset(self):
        self._pass = 0
        self.inner.reset()


class _EndOfData:
    pass


class DeviceBatch(tuple):
    """A batch the double buffer copied to the card: its slots' tensors,
    and ``ready``, the event recorded on the copy's stream after the
    copies. A consumer's stream waits on ``ready`` before it reads them
    (the executor does); ``ready`` is None for a batch on the CPU."""

    def __new__(cls, slots, ready=None):
        self = super().__new__(cls, slots)
        self.ready = ready
        return self

    def tensors(self):
        for slot in self:
            yield from (slot if isinstance(slot, tuple) else (slot,))


class DoubleBufferReader(_Decorated):
    """THE async input pipeline (reference
    create_double_buffer_reader_op.cc), as a TWO-stage daemon pipeline:
    a decode thread pulls batches from the underlying reader and conforms
    them (reshape/cast) on the host, and a transfer thread turns them
    into tensors on ``device``. On the card the transfer stage copies
    each batch into page-locked memory, issues the host-to-device copies
    with ``non_blocking=True`` on a CUDA stream of its own and records an
    event after them (``DeviceBatch.ready``); the copy of batch N+1 so
    overlaps the card's compute on batch N, and the decode of batch N+1
    overlaps the transfer of batch N. On the CPU it hands over plain
    tensors. read_next() costs a queue pop. Up to `capacity` batches sit
    in each stage's queue. A transfer failure is raised by read_next(),
    and nothing falls back to the CPU."""

    def __init__(self, inner: HostReader, capacity: int = 2,
                 slots: Optional[List[Dict[str, Any]]] = None,
                 device: Optional[torch.device] = None):
        super().__init__(inner)
        self._capacity = max(1, capacity)
        self._slots = slots  # declared {shape,dtype,...} per slot, if known
        self._device = resolve_device(device)
        # the copies' own stream (the card only)
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device.type == "cuda" else None)
        self._q: "queue.Queue" = queue.Queue(maxsize=self._capacity)
        self._hq: "queue.Queue" = queue.Queue(maxsize=self._capacity)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._xfer_thread: Optional[threading.Thread] = None
        self._start()

    def _conform(self, i: int, slot):
        """Reshape/cast to the declared slot spec IN THE WORKER THREAD —
        e.g. a uint8-stored image batch becomes float32 here, off the
        training thread, before its device transfer starts."""
        if self._slots is None or i >= len(self._slots):
            return slot
        spec = self._slots[i]
        shape = list(spec.get("shape") or [])
        if shape and shape.count(-1) <= 1 and tuple(shape) != slot.shape:
            slot = slot.reshape(shape)
        dtype = spec.get("dtype")
        if dtype and dtype != "bfloat16" and str(slot.dtype) != dtype:
            slot = slot.astype(dtype)
        return slot

    def _conform_sample(self, sample):
        return tuple(
            slot if isinstance(slot, tuple) else self._conform(i, slot)
            for i, slot in enumerate(sample))

    def _to_device(self, sample):
        if self._stream is None:
            return DeviceBatch(
                tuple(torch.from_numpy(np.ascontiguousarray(s))
                      for s in slot)  # (padded, lengths) pair
                if isinstance(slot, tuple)
                else torch.from_numpy(np.ascontiguousarray(slot))
                for slot in sample)

        def copy(a):
            host = torch.from_numpy(np.ascontiguousarray(a)).pin_memory()
            # the caching host allocator keeps `host` until the copy ends
            return host.to(self._device, non_blocking=True)

        with torch.cuda.stream(self._stream):
            slots = tuple(tuple(copy(s) for s in slot)
                          if isinstance(slot, tuple) else copy(slot)
                          for slot in sample)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return DeviceBatch(slots, ready)

    def _decode_worker(self):
        """Stage 1: read + conform on the host; never touches the device."""
        try:
            while not self._stop.is_set():
                try:
                    sample = self.inner.read_next()
                except StopIteration:
                    self._put(self._hq, _EndOfData)
                    return
                self._put(self._hq, self._conform_sample(sample))
        except Exception as e:  # surface decode errors at read_next()
            self._put(self._hq, e)

    def _xfer_worker(self):
        """Stage 2: host->device transfer, overlapping stage 1's decode of
        the NEXT batch (and the device's compute on the previous one)."""
        while not self._stop.is_set():
            try:
                item = self._hq.get(timeout=0.1)
            except queue.Empty:
                continue
            if item is _EndOfData or isinstance(item, Exception):
                self._put(self._q, item)
                return
            try:
                self._put(self._q, self._to_device(item))
            except Exception as e:  # device transfer failure
                self._put(self._q, e)
                # stop the DECODE stage too: with this stage dead nobody
                # drains _hq, and the decoder would fill it then spin in
                # _put until reset()/close(). The error item is already
                # enqueued; read_next() still receives it, and reset()
                # clears the flag via _start().
                self._stop.set()
                return

    def _put(self, q, item):
        """Queue put that gives up when reset/close asks the thread to stop
        (a plain blocking put would deadlock a full queue on teardown)."""
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _start(self):
        self._stop.clear()
        self._eof = False
        self._error: Optional[Exception] = None
        self._thread = threading.Thread(target=self._decode_worker,
                                        daemon=True)
        self._thread.start()
        self._xfer_thread = threading.Thread(target=self._xfer_worker,
                                             daemon=True)
        self._xfer_thread.start()

    def _shutdown(self):
        self._stop.set()
        for attr, q in (("_xfer_thread", self._q), ("_thread", self._hq)):
            t = getattr(self, attr)
            if t is not None:
                while t.is_alive():
                    try:  # drain so a blocked put can observe the stop flag
                        q.get_nowait()
                    except queue.Empty:
                        pass
                    t.join(timeout=0.05)
                setattr(self, attr, None)
        for q in (self._q, self._hq):
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break

    def read_next(self):
        if self._eof:
            raise StopIteration
        if self._error is not None:
            # the worker died on this error; a blocking q.get() would hang
            # forever (no producer) — keep re-raising until reset()
            raise self._error
        item = self._q.get()
        if item is _EndOfData:
            self._eof = True
            raise StopIteration
        if isinstance(item, Exception):
            self._error = item
            raise item
        return item

    def reset(self):
        self._shutdown()
        self.inner.reset()
        self._start()

    def close(self):
        self._shutdown()
        self.inner.close()


# --- create-op registry (executor host pre-pass) -----------------------

def _mk_recordio(attrs, inner):
    return RecordIOFileReader(str(attrs["filename"]))


def _mk_open_files(attrs, inner):
    # thread_num and buffer_size size the JAX package's native prefetch
    return MultiFileReader([str(f) for f in attrs["filenames"]])


def _mk_shuffle(attrs, inner):
    return ShuffleReader(inner, int(attrs["buffer_size"]),
                         seed=int(attrs.get("seed", 0)))


def _mk_batch(attrs, inner, slots=None):
    return BatchReader(inner, int(attrs["batch_size"]),
                       drop_last=bool(attrs.get("drop_last", False)),
                       slots=slots)


def _mk_multi_pass(attrs, inner):
    return MultiPassReader(inner, int(attrs["pass_num"]))


_CREATORS: Dict[str, Callable] = {
    "create_recordio_file_reader": _mk_recordio,
    "open_files": _mk_open_files,
    "create_shuffle_reader": _mk_shuffle,
    "create_batch_reader": _mk_batch,
    "create_multi_pass_reader": _mk_multi_pass,
}

READER_CREATE_OP_TYPES = frozenset(_CREATORS) | {
    "create_double_buffer_reader"
}


def create_host_reader(op_type: str, attrs: Dict[str, Any],
                       inner: Optional[HostReader],
                       slots: Optional[List[Dict[str, Any]]] = None,
                       device: Optional[torch.device] = None,
                       ) -> HostReader:
    """The host reader a creation op builds. ``device`` (the executor's)
    is where a double buffer puts its batches."""
    if op_type == "create_double_buffer_reader":
        # the double buffer conforms slots in its worker thread, so decode-
        # adjacent work (reshape, uint8->f32 cast) overlaps device compute
        return DoubleBufferReader(
            inner, capacity=int(attrs.get("capacity", 2)), slots=slots,
            device=device,
        )
    if op_type == "create_batch_reader":
        return _mk_batch(attrs, inner, slots=slots)
    if op_type not in _CREATORS:
        raise KeyError(f"unknown reader create op '{op_type}'")
    return _CREATORS[op_type](attrs, inner)
