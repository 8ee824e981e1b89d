"""Thread-safe trace recorder: named host spans into a bounded ring
buffer, exported as chrome://tracing JSON (the role the reference's
device_tracer.cc + tools/timeline.py played), now with
CROSS-PROCESS trace context: every span carries a trace_id /
span_id / parent_id, a remote peer can adopt a context received on the
wire (distributed/rpc.py stamps a `__trace__` header into every frame),
and chrome FLOW events ("ph": "s"/"f") link a client RPC span to its
server handler span so Perfetto draws the client→server arrow across
process boundaries.

Design constraints:
  - Near-zero cost when disabled: `span()` checks one module-level bool
    and returns a shared no-op context manager; no allocation, no clock
    read, no lock, no id minting.
  - Thread-safe when enabled: each completed span appends ONE tuple to a
    `collections.deque(maxlen=...)` — an atomic operation under the GIL,
    so concurrent executor / RPC handler / reader worker threads never
    contend on a lock in the hot path. Overflow drops the OLDEST spans
    (ring-buffer semantics) and counts the drops (also exported as the
    `tracing.dropped_spans` gauge so span loss is visible in /metrics).
  - Complete events ("ph": "X"): one record per finished span carrying
    ts + dur. Chrome/Perfetto reconstruct nesting per (pid, tid) from
    the intervals, so cross-thread nesting needs no begin/end pairing.
  - Trace context rides a per-thread stack: a span's parent is the
    innermost open span on its thread, or — for the outermost span of an
    RPC handler — the remote context adopted from the frame header.

Cross-process clock alignment: `ts` is process-local (perf_counter from
a per-process epoch), so shards from different processes are not
directly comparable. Each export records `wall_epoch_us` (the wall-clock
time of the process's trace epoch) plus `rpc_clock_offset_us` (an
NTP-style offset estimate the RPC layer feeds from request/response
timestamps — note_clock_offset). `timeline merge` uses both to place
every shard on one axis.

Control surface: FLAGS["trace"] / FLAGS["trace_buffer"] (env
PADDLE_TPU_TRACE / PADDLE_TPU_TRACE_BUFFER) seed the initial state;
`trace_enable()` / `trace_disable()` toggle at runtime (fluid.profiler
drives these so the legacy profiler() API records traces too). With
PADDLE_TPU_TRACE_DIR set, an atexit hook exports this process's shard
to `<dir>/trace-<pid>.json` — how multi-process jobs (and
tools/chaos_soak.py --trace-dir) collect per-process shards without
any code in the trainer.
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

__all__ = [
    "span", "trace_enable", "trace_disable", "trace_enabled",
    "trace_reset", "trace_export", "trace_events", "dropped_spans",
    "resize_buffer", "buffer_capacity",
    "current_span", "wire_context", "adopt", "flow_start", "flow_end",
    "new_flow_id",
    "set_process_label", "process_label", "note_clock_offset",
    "clock_offset_us", "wall_epoch_us", "shard_path",
]

# epoch for ts fields: chrome trace wants monotonically comparable
# microseconds; perf_counter is monotonic and high-resolution.
# _WALL_EPOCH_US anchors that epoch to the wall clock (captured at the
# same instant) so `timeline merge` can align shards from different
# processes on one axis.
_EPOCH = time.perf_counter()
_WALL_EPOCH_US = time.time() * 1e6

_enabled = False
# _mu guards the ring's REBINDS and clears (enable/resize/reset); the
# append/snapshot path is deliberately lock-free — deque ops are
# GIL-atomic — and carries per-site allow-unguarded vets
_buf: "collections.deque" = collections.deque(maxlen=65536)  # guarded-by: _mu
_dropped = 0
_mu = threading.Lock()

# trace identity: ids are "<proc>-<n>" — unique across processes (the
# proc component is a per-process uuid) and cheap to mint (one counter
# increment, GIL-atomic via itertools.count)
_PROC = uuid.uuid4().hex[:12]
_ids = itertools.count(1)

# per-thread context: .span = innermost open Span, .remote = adopted
# (trace_id, parent_span_id) from a wire header (RPC handler threads)
_tls = threading.local()

# process label for the merged timeline ("pserver:7001", "trainer:0");
# param_server/master/elastic set it when they start serving
_process_label: Optional[str] = None

# EWMA of this process's clock offset relative to the RPC peers it
# calls (peer_wall - local_wall, µs) — fed by note_clock_offset from
# the client's request/response timestamp handshake
_clock_offset = None  # type: Optional[float]

# span loss exported as a gauge: registered EAGERLY
# so /metrics always shows the line — a scrape must distinguish "zero
# drops" from "nobody measured". metrics has no import back-edge to
# tracing, so this is cycle-free.
from . import metrics as _metrics  # noqa: E402

_g_dropped = _metrics.gauge("tracing.dropped_spans")


def _env_flag(name: str, default: str = "0") -> bool:
    return os.environ.get(name, default).lower() in ("1", "true", "yes", "on")


def _configure_from_env():
    global _enabled, _buf
    cap = int(os.environ.get("PADDLE_TPU_TRACE_BUFFER", "65536") or 65536)
    _buf = collections.deque(maxlen=max(16, cap))
    _enabled = _env_flag("PADDLE_TPU_TRACE")
    if os.environ.get("PADDLE_TPU_TRACE_DIR"):
        import atexit

        atexit.register(_export_shard_at_exit)
        # atexit never fires on SIGTERM — and SIGTERM is how real jobs
        # stop a pserver, which would silently lose exactly the shard an
        # operator set PADDLE_TPU_TRACE_DIR to collect. The env flag is
        # an explicit opt-in, so chaining a TERM handler here is the
        # operator's intent, not a library land-grab; any pre-installed
        # handler still runs after the export.
        _install_sigterm_export()


def _install_sigterm_export():
    import signal

    try:
        prev = signal.getsignal(signal.SIGTERM)

        def _on_term(signum, frame):
            _export_shard_at_exit()
            if callable(prev):
                prev(signum, frame)
            elif prev is signal.SIG_IGN:
                return  # the process chose to survive TERM: keep that
            else:  # SIG_DFL (or an unknown non-Python handler): die as
                # the process would have without us
                signal.signal(signum, signal.SIG_DFL)
                os.kill(os.getpid(), signum)

        signal.signal(signal.SIGTERM, _on_term)
    except ValueError:
        pass  # not the main thread (embedded import): atexit still covers
        # normal exits; SIGTERM loss is unavoidable there


def _export_shard_at_exit():  # lint: allow-unguarded(_buf) — atexit read;
    # a non-empty check on a GIL-atomic deque needs no lock
    d = os.environ.get("PADDLE_TPU_TRACE_DIR")
    if d and _buf:
        try:
            trace_export(shard_path(d))
        except OSError:
            pass  # a dying process must not mask its real exit cause


def shard_path(trace_dir: str) -> str:
    """The per-process shard file `timeline merge` expects."""
    return os.path.join(trace_dir, f"trace-{os.getpid()}.json")


_configure_from_env()


def _new_id() -> str:
    return f"{_PROC}-{next(_ids)}"


def _note_drop():
    """Count a ring-buffer overflow and mirror it into the
    tracing.dropped_spans gauge (span loss must be visible in
    /metrics, not only in the export's otherData)."""
    global _dropped
    _dropped += 1
    _g_dropped.set(_dropped)


class _NullSpan:
    """Shared no-op context for the disabled path: __enter__/__exit__ do
    nothing, `set_arg` swallows; one instance serves every call site."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_arg(self, key, value):
        pass


_NULL_SPAN = _NullSpan()


class Span:
    """RAII host span. Records a complete event at __exit__ — begin time,
    duration, thread id, trace context, and optional args — into the ring
    buffer. While open it is its thread's current span: child spans (and
    wire_context()) read their parent from it."""

    __slots__ = ("name", "args", "_t0", "_prev",
                 "trace_id", "span_id", "parent_id")

    def __init__(self, name: str, args: Optional[Dict[str, Any]] = None):
        self.name = name
        self.args = args
        self._t0 = 0.0
        self._prev = None
        self.trace_id = self.span_id = self.parent_id = None

    def __enter__(self):
        parent = getattr(_tls, "span", None)
        self._prev = parent
        if parent is not None:
            self.trace_id, self.parent_id = parent.trace_id, parent.span_id
        else:
            remote = getattr(_tls, "remote", None)
            if remote is not None:
                self.trace_id, self.parent_id = remote
            else:
                self.trace_id = _new_id()  # root span starts a new trace
        self.span_id = _new_id()
        _tls.span = self
        self._t0 = time.perf_counter()
        return self

    # lint: allow-unguarded(_buf) — THE hot append path: one deque.append
    # per finished span, GIL-atomic by design (see module docstring); _mu
    # here would serialize every instrumented thread on every span
    def __exit__(self, *exc):
        t1 = time.perf_counter()
        _tls.span = self._prev
        if len(_buf) == _buf.maxlen:
            _note_drop()
        _buf.append((
            self.name,
            (self._t0 - _EPOCH) * 1e6,      # ts, µs
            (t1 - self._t0) * 1e6,          # dur, µs
            threading.get_ident(),
            self.args,
            (self.trace_id, self.span_id, self.parent_id),
        ))
        return False

    def set_arg(self, key, value):
        if self.args is None:
            self.args = {}
        self.args[key] = value


def span(name: str, **args):
    """`with span("executor.step", step=3): ...` — the one tracing entry
    point every instrumented layer uses. Disabled: one bool check, a
    shared no-op object, and (unavoidably) the kwargs dict the caller
    built; hot paths that can't afford even that should guard with
    `if trace_enabled():`."""
    if not _enabled:
        return _NULL_SPAN
    return Span(name, args or None)


def current_span() -> Optional[Span]:
    """The innermost open span on this thread, or None."""
    return getattr(_tls, "span", None)


def new_flow_id() -> str:
    """A flow-event id unique ACROSS processes (proc-uuid prefixed) —
    callers without a natural per-call token (the RPC layer reuses its
    idempotency token) mint one here."""
    return _new_id()


def wire_context(flow_id: Optional[str] = None) -> Optional[dict]:
    """The `__trace__` header an RPC client stamps into a frame: the
    current span's trace_id ("t") and span_id ("s" — the server span's
    remote parent), plus the flow-event id ("f") linking the two sides.
    None when tracing is off or no span is open (frames stay clean)."""
    if not _enabled:
        return None
    sp = getattr(_tls, "span", None)
    if sp is None:
        return None
    ctx = {"t": sp.trace_id, "s": sp.span_id}
    if flow_id is not None:
        ctx["f"] = str(flow_id)
    return ctx


class _Adopt:
    """Context manager installing a remote (trace_id, parent_span_id) as
    this thread's root context: the next span opened with NO local parent
    inherits it — how an RPC handler's span joins the client's trace."""

    __slots__ = ("_ctx", "_prev")

    def __init__(self, ctx):
        self._ctx = ctx
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_tls, "remote", None)
        _tls.remote = self._ctx
        return self

    def __exit__(self, *exc):
        _tls.remote = self._prev
        return False


_NULL_ADOPT = _Adopt(None)


def adopt(wire: Optional[dict]):
    """`with adopt(req.pop("__trace__", None)), span("rpc.server.x"): ...`
    — server-side half of context propagation. A None/foreign header (or
    tracing disabled) is a no-op."""
    if not _enabled or not isinstance(wire, dict) or "t" not in wire:
        return _NULL_ADOPT
    return _Adopt((wire.get("t"), wire.get("s")))


def flow_start(flow_id):  # lint: allow-unguarded(_buf) — lock-free append
    # path, same GIL-atomicity vet as Span.__exit__
    """Record a chrome flow-START event at now; chrome binds it to the
    enclosing slice on this (pid, tid) — call inside the client span."""
    if not _enabled or flow_id is None:
        return
    if len(_buf) == _buf.maxlen:
        _note_drop()
    _buf.append(("s", (time.perf_counter() - _EPOCH) * 1e6,
                 threading.get_ident(), str(flow_id)))


def flow_end(flow_id):  # lint: allow-unguarded(_buf) — lock-free append
    # path, same GIL-atomicity vet as Span.__exit__
    """The matching flow-FINISH — call inside the server handler span."""
    if not _enabled or flow_id is None:
        return
    if len(_buf) == _buf.maxlen:
        _note_drop()
    _buf.append(("f", (time.perf_counter() - _EPOCH) * 1e6,
                 threading.get_ident(), str(flow_id)))


def set_process_label(label: str):
    """Name this process in merged timelines ("pserver:7001"); emitted as
    a process_name metadata event on export. Last writer wins."""
    global _process_label
    _process_label = str(label)


def process_label() -> Optional[str]:
    return _process_label


def note_clock_offset(offset_us: float):
    """Feed one NTP-style offset sample (server_wall - client_wall
    midpoint, µs) from an RPC handshake; an EWMA smooths jitter. The
    export records the estimate for `timeline merge` clock alignment."""
    global _clock_offset
    offset_us = float(offset_us)
    _clock_offset = (offset_us if _clock_offset is None
                     else 0.8 * _clock_offset + 0.2 * offset_us)


def clock_offset_us() -> Optional[float]:
    return _clock_offset


def wall_epoch_us() -> float:
    """Wall-clock µs of this process's trace epoch (ts=0)."""
    return _WALL_EPOCH_US


def trace_enabled() -> bool:
    return _enabled


def trace_enable(buffer_size: Optional[int] = None):
    global _enabled
    with _mu:
        if buffer_size is not None:
            _resize_locked(buffer_size)
        _enabled = True


def trace_disable():
    global _enabled
    with _mu:
        _enabled = False


def _resize_locked(capacity: int):
    global _buf
    if capacity != _buf.maxlen:
        _buf = collections.deque(_buf, maxlen=max(16, int(capacity)))


def resize_buffer(capacity: int):
    """Change ring capacity, keeping buffered spans (newest win) and the
    current enable state."""
    with _mu:
        _resize_locked(capacity)


def buffer_capacity() -> int:  # lint: allow-unguarded(_buf) — one atomic
    # attribute read of an immutable deque property
    return _buf.maxlen or 0


def trace_reset():
    global _dropped
    with _mu:
        _buf.clear()
        _dropped = 0
        if _g_dropped is not None:
            _g_dropped.set(0)


def dropped_spans() -> int:
    return _dropped


def trace_events() -> List[Dict[str, Any]]:  # lint: allow-unguarded(_buf)
    # — list(deque) is one GIL-atomic snapshot; concurrent appends land
    # before or after it, never mid-copy
    """The buffered records as chrome trace event dicts (oldest first):
    complete ("X") span events — trace context in args — plus flow
    start/finish ("s"/"f") events."""
    pid = os.getpid()
    out = []
    for rec in list(_buf):
        if len(rec) == 4:  # flow record — spans are 6-tuples (a span
            # literally NAMED "s"/"f" must not take this branch)
            ph, ts, tid, fid = rec
            ev = {"name": "rpc", "cat": "rpc", "ph": ph, "id": fid,
                  "ts": ts, "pid": pid, "tid": tid}
            if ph == "f":
                ev["bp"] = "e"  # bind to the ENCLOSING slice, not the next
            out.append(ev)
            continue
        name, ts, dur, tid, args, trace = rec
        ev = {"name": name, "ph": "X", "ts": ts, "dur": dur,
              "pid": pid, "tid": tid, "cat": "host"}
        ev_args = dict(args) if args else {}
        if trace is not None and trace[0] is not None:
            ev_args["trace_id"] = trace[0]
            ev_args["span_id"] = trace[1]
            if trace[2] is not None:
                ev_args["parent_span_id"] = trace[2]
        if ev_args:
            ev["args"] = ev_args
        out.append(ev)
    return out


def trace_export(path: str) -> str:
    """Write the buffer as a chrome://tracing / Perfetto-loadable JSON
    object. `path` may be a directory (the legacy profiler profile_path
    contract allowed one); then the file is <path>/trace.json. Returns
    the path actually written.

    otherData carries what `timeline merge` needs to align this shard
    with shards from other processes: pid, process_label, wall_epoch_us
    (wall time of ts=0) and rpc_clock_offset_us (EWMA skew vs RPC
    peers). A process_name metadata event names the track in Perfetto.
    """
    if os.path.isdir(path):
        path = os.path.join(path, "trace.json")
    pid = os.getpid()
    label = _process_label or f"python:{pid}"
    events = [{"name": "process_name", "ph": "M", "pid": pid,
               "args": {"name": label}}]
    events += trace_events()
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "dropped_spans": _dropped,
            "pid": pid,
            "process_label": label,
            "wall_epoch_us": _WALL_EPOCH_US,
            "rpc_clock_offset_us": _clock_offset or 0.0,
        },
    }
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path
