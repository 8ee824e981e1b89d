"""Elastic master data service: fault-tolerant task queue over dataset
shards — the counterpart of ``paddle_tpu/distributed/master.py``.

Capability parity with the reference's Go master (go/master/service.go:
Service:89 todo/pending/done/failed queues, partition:106, GetTask:368
leased with timeout, checkTimeoutFunc:341, TaskFinished:411,
TaskFailed:455 re-queue with failureMax drop, snapshot:207/recover:166 via
etcd). Redesign: the queue state snapshots to a local file (crc32 +
atomic rename — the same integrity trick as the Go pserver checkpoints,
go/pserver/service.go:53); service runs in-process or over TCP
(length-prefixed JSON frames) for multi-trainer jobs. Tasks are recordio
shard path groups, exactly like the reference partitions chunks.

The port speaks the JAX package's wire form (length-prefixed JSON frames,
Task type-tagged) and writes its snapshot format (v2: magic, term, two
crc32s, pickled state), so either package's client, master and standby
work with the other's. Two differences:

  - A snapshot's payload pickles ``Task`` objects, so its bytes name the
    class path of the package that wrote it. The port reads snapshots
    with an unpickler that maps the JAX package's ``Task`` path to its
    own and refuses every other class outside a few builtin types, so
    recovering a JAX snapshot imports nothing of the JAX package (and a
    crafted snapshot cannot name a callable).
  - Both ends of a master connection set TCP_NODELAY (``rpc._no_delay``):
    a frame is small and follows another write, and Nagle's algorithm
    held each such call for the peer's delayed ACK. Same bytes, timing
    only.
"""
from __future__ import annotations

import io
import json
import os
import pickle
import socket
import socketserver
import struct
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from . import faults as _faults
from .rpc import _no_delay, read_frame, write_frame
from ..observability import tracing as _tracing
from ..observability.log import get_logger

_log = get_logger("master")

# v2 snapshot magic (see _snapshot_locked for the layout); files without
# it are the legacy crc|payload format (term 0)
_SNAP_MAGIC = b"PTSNAP2\x00"


class MasterDeposed(Exception):
    """This master no longer holds the leadership lease: mutating RPCs and
    snapshot writes must not proceed (fencing)."""


# the classes a snapshot payload may name: the port's Task under either
# package's path, and the builtin containers and scalars
_TASK_PATHS = frozenset({("paddle_tpu.distributed.master", "Task"),
                         (__name__, "Task")})
_SAFE_BUILTINS = frozenset({"dict", "list", "tuple", "set", "frozenset",
                            "int", "float", "bool", "str", "bytes"})


@dataclass
class Task:
    id: int
    paths: List[str]
    num_failures: int = 0
    epoch: int = 0  # lease generation; stale finish/fail calls are rejected


def _to_wire(v):
    """RPC result -> JSON-safe value (Task gets a type tag)."""
    if isinstance(v, Task):
        return {"__task__": {"id": v.id, "paths": list(v.paths),
                             "num_failures": v.num_failures,
                             "epoch": v.epoch}}
    return v


def _from_wire(v):
    if isinstance(v, dict) and "__task__" in v:
        t = v["__task__"]
        return Task(id=t["id"], paths=list(t["paths"]),
                    num_failures=t["num_failures"], epoch=t["epoch"])
    return v


class _SnapshotUnpickler(pickle.Unpickler):
    """Resolves ``Task`` (of either package) to the port's class and
    refuses any other class but the builtin containers and scalars."""

    def find_class(self, module, name):
        if (module, name) in _TASK_PATHS:
            return Task
        if module == "builtins" and name in _SAFE_BUILTINS:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"master snapshot names {module}.{name}: only Task and builtin "
            "containers may appear in a snapshot")


def _load_snapshot_payload(payload: bytes) -> dict:
    return _SnapshotUnpickler(io.BytesIO(payload)).load()


@dataclass
class _Pending:
    task: Task
    epoch: int
    deadline: float


class MasterService:
    """Task queue with leases. Thread-safe; optionally snapshot-backed."""

    def __init__(self, chunks_per_task: int = 1, lease_timeout: float = 60.0,
                 failure_max: int = 3, snapshot_path: Optional[str] = None,
                 snapshot_fence=None, snapshot_term: int = 0):
        self._chunks_per_task = chunks_per_task
        self._timeout = lease_timeout
        self._failure_max = failure_max
        self._snapshot_path = snapshot_path
        # fence(commit): run `commit` only while leadership is still held,
        # else raise MasterDeposed — prevents a stale leader overwriting
        # the new leader's snapshot (election.FileLease.fenced)
        self._snapshot_fence = snapshot_fence
        # monotonic fencing term stamped into every snapshot this service
        # writes (the lease term under which it was elected). The commit
        # refuses to replace a snapshot carrying a HIGHER term, so a
        # deposed leader that slipped past a check-then-commit fence
        # (tcp_lease.TcpLease cannot hold the server mutex across the
        # client-side rename the way FileLease holds flock) still cannot
        # roll the new leader's state back. 0 = unelected/standalone use.
        self._snapshot_term = int(snapshot_term)
        self._mu = threading.Lock()
        self._todo: List[Task] = []
        self._pending: Dict[int, _Pending] = {}
        self._done: List[Task] = []
        self._failed_dropped: List[Task] = []
        self._epoch = 0
        self._next_id = 0
        self._dataset_paths: Optional[List[str]] = None
        self._cur_pass = 0
        self._sweep_stop: Optional[threading.Event] = None
        if snapshot_path and os.path.exists(snapshot_path):
            self._recover()

    # -- lease sweeper -----------------------------------------------------
    def start_timeout_sweeper(self, interval: Optional[float] = None):
        """Expire leases on a TIMER, not only piggybacked on other calls:
        _check_timeouts_locked used to fire solely inside get_task/
        all_done/new_pass, so with no client polling (every trainer dead
        or wedged) a lapsed lease stayed pending forever. Off by default
        for in-process use; serve() turns it on. Idempotent; stopped by
        shutdown()/stop_timeout_sweeper()."""
        if self._sweep_stop is not None:
            return
        stop = self._sweep_stop = threading.Event()
        interval = interval if interval is not None else \
            max(0.05, self._timeout / 3.0)

        def _sweep():
            while not stop.wait(interval):
                try:
                    with self._mu:
                        self._check_timeouts_locked()
                except MasterDeposed:
                    # a deposed leader must stop mutating state — and
                    # must not leave the stale stop-event wedging a
                    # future start_timeout_sweeper after re-election
                    if self._sweep_stop is stop:
                        self._sweep_stop = None
                    return
                except Exception as e:  # never die silently mid-job
                    _log.error("lease sweeper: %s: %s",
                               type(e).__name__, e)

        t = threading.Thread(target=_sweep, daemon=True,
                             name="master-lease-sweeper")
        t.start()

    def stop_timeout_sweeper(self):
        if self._sweep_stop is not None:
            self._sweep_stop.set()
            self._sweep_stop = None

    # -- dataset ----------------------------------------------------------
    def set_dataset(self, shard_paths: Sequence[str]):
        """Partition shards into tasks (reference partition:106).
        IDEMPOTENT for an unchanged shard list: a second worker joining
        the fleet must drain the EXISTING queues, not reset them (a reset
        would invalidate in-flight leases and re-serve finished tasks)."""
        with self._mu:
            if list(shard_paths) == self._dataset_paths:
                return
            self._dataset_paths = list(shard_paths)
            self._todo = []
            self._pending.clear()
            self._done = []
            self._failed_dropped = []
            cur: List[str] = []
            for p in shard_paths:
                cur.append(p)
                if len(cur) >= self._chunks_per_task:
                    self._todo.append(Task(self._next_id, cur))
                    self._next_id += 1
                    cur = []
            if cur:
                self._todo.append(Task(self._next_id, cur))
                self._next_id += 1
            self._snapshot_locked()

    # -- task protocol ----------------------------------------------------
    def get_task(self) -> Optional[Task]:
        """Lease a task; None when nothing is available right now (reference
        GetTask:368). Re-queues timed-out leases first."""
        with self._mu:
            self._check_timeouts_locked()
            if not self._todo:
                return None
            task = self._todo.pop(0)
            self._epoch += 1
            task.epoch = self._epoch
            self._pending[task.id] = _Pending(
                task, self._epoch, time.monotonic() + self._timeout
            )
            self._snapshot_locked()
            # hand out a copy: in-process clients must not alias the queue's
            # mutable task (its epoch advances on re-lease)
            import dataclasses as _dc

            return _dc.replace(task, paths=list(task.paths))

    def _pop_pending(self, task_id: int, epoch: Optional[int]):
        """A stale lease holder (its lease timed out and the task was
        re-leased) must not affect the new holder's lease — the epoch check
        (reference go/master keeps per-lease epochs for exactly this)."""
        p = self._pending.get(task_id)
        if p is None or (epoch is not None and p.epoch != epoch):
            return None
        return self._pending.pop(task_id)

    def task_finished(self, task_id: int, epoch: Optional[int] = None) -> bool:
        """reference TaskFinished:411."""
        with self._mu:
            p = self._pop_pending(task_id, epoch)
            if p is None:
                return False
            self._done.append(p.task)
            self._snapshot_locked()
            return True

    def task_failed(self, task_id: int, epoch: Optional[int] = None) -> bool:
        """Requeue; drop after failure_max (reference TaskFailed:455,
        :313-339)."""
        with self._mu:
            p = self._pop_pending(task_id, epoch)
            if p is None:
                return False
            self._fail_locked(p.task)
            self._snapshot_locked()
            return True

    def task_released(self, task_id: int, epoch: Optional[int] = None) -> bool:
        """Voluntary lease release (client abandons a pass mid-task):
        requeue IMMEDIATELY and WITHOUT a failure mark — unlike
        task_failed, releasing is not evidence the task is bad, so it must
        not count toward failure_max's drop threshold."""
        with self._mu:
            p = self._pop_pending(task_id, epoch)
            if p is None:
                return False
            self._todo.append(p.task)
            self._snapshot_locked()
            return True

    def all_done(self) -> bool:
        with self._mu:
            self._check_timeouts_locked()
            return not self._todo and not self._pending

    def new_pass(self) -> bool:
        """Start the next pass when the current one is exhausted: done
        (and dropped) tasks re-queue as todo (reference TaskFinished's
        rollover, service.go:435-445 — made EXPLICIT here because this
        service's clients detect pass end via all_done(), which an
        automatic rollover would never let become true). Returns False
        while tasks are still outstanding."""
        with self._mu:
            self._check_timeouts_locked()
            if self._todo or self._pending:
                return False
            if not self._done and not self._failed_dropped:
                return False
            self._cur_pass += 1
            self._todo = self._done + self._failed_dropped
            self._done = []
            self._failed_dropped = []
            for t in self._todo:
                t.num_failures = 0
            self._snapshot_locked()
            return True

    def stats(self) -> Dict[str, int]:
        with self._mu:
            return {
                "todo": len(self._todo), "pending": len(self._pending),
                "done": len(self._done),
                "dropped": len(self._failed_dropped),
                "pass": self._cur_pass,
            }

    def _fail_locked(self, task: Task):
        task.num_failures += 1
        if task.num_failures >= self._failure_max:
            self._failed_dropped.append(task)
        else:
            self._todo.append(task)

    def _check_timeouts_locked(self):
        now = time.monotonic()
        expired = [tid for tid, p in self._pending.items()
                   if p.deadline <= now]
        for tid in expired:
            p = self._pending.pop(tid)
            self._fail_locked(p.task)
        if expired:
            self._snapshot_locked()

    # -- snapshot / recover (reference snapshot:207, recover:166) ---------
    def _snapshot_locked(self):
        if not self._snapshot_path:
            return
        state = {
            "todo": self._todo,
            # pending leases survive as todo on recovery (the lease holder
            # may be the one that died)
            "pending": [p.task for p in self._pending.values()],
            "done": self._done,
            "dropped": self._failed_dropped,
            "next_id": self._next_id,
            # epoch must survive recovery or pre-crash stale leases could
            # collide with fresh ones and defeat the epoch guard
            "epoch": self._epoch,
            # the set_dataset idempotency guard keys on these: without them
            # a recovered master treats the first (unchanged) set_dataset as
            # new, resets the queues, and re-serves finished tasks
            "dataset_paths": self._dataset_paths,
            "pass": self._cur_pass,
        }
        payload = pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
        # v2 format: magic | term u64 | crc32(term) | crc32(payload) |
        # payload. The term lives in a fixed-size, separately-checksummed
        # header so the monotonic-write guard reads the 24-byte header — not the
        # whole queue state — per commit, and a torn header can't fake a
        # high term and wedge commits. Legacy (magic-less crc|payload)
        # snapshots still recover, with term 0.
        term8 = struct.pack("<Q", self._snapshot_term)
        blob = (_SNAP_MAGIC + term8
                + struct.pack("<II", zlib.crc32(term8), zlib.crc32(payload))
                + payload)
        # per-process unique tmp: on shared storage a deposed leader writing
        # a FIXED tmp path could corrupt the new leader's in-flight commit
        # (the fence only guards the rename)
        tmp = f"{self._snapshot_path}.tmp.{os.getpid()}.{id(self):x}"
        with open(tmp, "wb") as f:
            f.write(blob)

        def _commit():
            # chaos hook: a crash HERE (tmp written, rename not yet done)
            # is the classic torn-checkpoint window — recovery must see
            # the intact previous snapshot, never the tmp
            _faults.fire("master.snapshot")
            # Monotonic-term guard: never replace a snapshot written under
            # a NEWER leadership term. FileLease.fenced holds flock across
            # this rename, closing the race completely; TcpLease.fenced is
            # check-then-commit (the lease server cannot extend its mutex
            # over a client-side rename), so a leader that stalls between
            # check and commit could otherwise clobber its successor's
            # state. With the term check, the stale rename is refused the
            # moment the successor (higher term) has committed once — the
            # residual window shrinks from the stall length to the
            # read-compare-rename microseconds, and a write that does slip
            # through is corrected by the successor's next snapshot (task
            # leases it re-serves simply time out and requeue: the
            # at-least-once semantics the queue already guarantees).
            cur = self._read_snapshot_term()
            if cur is not None and cur > self._snapshot_term:
                raise MasterDeposed(
                    f"snapshot already at term {cur} > ours "
                    f"{self._snapshot_term}: refusing stale write")
            os.replace(tmp, self._snapshot_path)

        try:
            if self._snapshot_fence is not None:
                self._snapshot_fence(_commit)  # raises MasterDeposed if stale
            else:
                _commit()
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise

    def _read_snapshot_term(self) -> Optional[int]:
        """Term of the current on-disk snapshot (24-byte header read, not
        the whole state), or None if there is no readable/intact header.
        Only an INTEGRITY-CHECKED term counts: a torn header must not be
        able to fake a high term and wedge commits forever. Legacy
        (pre-term) snapshots read as term 0."""
        try:
            with open(self._snapshot_path, "rb") as f:
                head = f.read(len(_SNAP_MAGIC) + 16)
        except OSError:
            return None
        if not head.startswith(_SNAP_MAGIC):
            return 0  # legacy crc|payload format carried no term
        m = len(_SNAP_MAGIC)
        if len(head) < m + 16:
            return None
        term8 = head[m:m + 8]
        (crc_t, _crc_p) = struct.unpack("<II", head[m + 8:m + 16])
        if zlib.crc32(term8) != crc_t:
            return None
        return struct.unpack("<Q", term8)[0]

    def _recover(self):
        with open(self._snapshot_path, "rb") as f:
            blob = f.read()
        if blob.startswith(_SNAP_MAGIC):
            m = len(_SNAP_MAGIC)
            term8 = blob[m:m + 8]
            (crc_t, crc_p) = struct.unpack("<II", blob[m + 8:m + 16])
            payload = blob[m + 16:]
            if zlib.crc32(term8) != crc_t or zlib.crc32(payload) != crc_p:
                raise IOError(f"{self._snapshot_path}: snapshot corrupt")
            recovered_term = struct.unpack("<Q", term8)[0]
        else:
            # legacy format: crc32(payload) | payload, no term
            (crc,) = struct.unpack("<I", blob[:4])
            payload = blob[4:]
            if zlib.crc32(payload) != crc:
                raise IOError(f"{self._snapshot_path}: snapshot corrupt")
            recovered_term = 0
        # Adopt the recovered term when it is higher than ours: a
        # standalone service (term 0) or a leader elected from a
        # RESTARTED lease server (terms reset to 1) must be able to keep
        # committing over a higher-term snapshot rather than raising
        # MasterDeposed on every mutation forever. The cost is that
        # fencing between two post-restart leaders degrades to the
        # check-fence until lease terms catch up — persistence on the
        # LeaseServer side (state_path) avoids the reset entirely.
        self._snapshot_term = max(self._snapshot_term, recovered_term)
        state = _load_snapshot_payload(payload)
        self._todo = state["todo"] + state["pending"]
        self._done = state["done"]
        self._failed_dropped = state["dropped"]
        self._next_id = state["next_id"]
        self._epoch = state.get("epoch", 0)
        if state.get("dataset_paths") is not None:
            self._dataset_paths = state["dataset_paths"]
        self._cur_pass = state.get("pass", 0)

    # -- TCP server (role of the reference's net/rpc endpoint) ------------
    # RPC surface exposed over TCP — everything else is unreachable
    _RPC_METHODS = frozenset({
        "set_dataset", "get_task", "task_finished", "task_failed",
        "task_released", "all_done", "new_pass", "stats",
    })

    # frames larger than this are a protocol violation (a real set_dataset
    # of ~100k shard paths is well under 8 MiB); caps the per-connection
    # allocation a hostile peer can force
    _MAX_FRAME = 8 << 20

    def serve(self, host: str = "127.0.0.1", port: int = 0) -> Tuple[str, int]:
        """Start serving in a daemon thread; returns (host, port).

        Frames are length-prefixed JSON (size-capped) — every RPC
        argument/result is paths/ints/bools/Task, so nothing needs pickle,
        and a hostile peer can at worst get a parse error or a dropped
        connection (the reference's in-cluster RPC is protobuf for the same
        reason)."""
        service = self
        self._conns = set()
        self._conns_mu = threading.Lock()

        class Handler(socketserver.StreamRequestHandler):
            def setup(self):
                super().setup()
                _no_delay(self.connection)

            def handle(self):
                with service._conns_mu:
                    service._conns.add(self.connection)
                try:
                    while True:
                        try:
                            req = read_frame(
                                self.rfile,
                                max_frame=MasterService._MAX_FRAME)
                        except json.JSONDecodeError as e:
                            # malformed but well-framed: report + keep serving
                            write_frame(self.wfile,
                                        {"ok": False,
                                         "error": f"bad frame: {e}"})
                            continue
                        except IOError:
                            return  # protocol violation: drop the peer
                        if req is None:
                            return
                        # trace-context propagation: same
                        # adopt-and-answer protocol as distributed/rpc.py
                        # — the master's frames are plain JSON, so the
                        # header rides as a request key
                        wire_tr = req.pop("__trace__", None) \
                            if isinstance(req, dict) else None
                        try:
                            method = req["method"]
                            if method not in MasterService._RPC_METHODS:
                                raise ValueError(
                                    f"unknown RPC method {method!r}")
                            with _tracing.adopt(wire_tr), \
                                    _tracing.span(f"master.{method}",
                                                  method=method):
                                if wire_tr:
                                    _tracing.flow_end(wire_tr.get("f"))
                                result = getattr(service, method)(
                                    *req["args"])
                            resp = {"ok": True, "result": _to_wire(result)}
                        except MasterDeposed:
                            # this master lost its lease mid-call: sever the
                            # connection so the client re-resolves to the
                            # new leader instead of getting app errors
                            return
                        except Exception as e:  # report, keep serving
                            resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                        write_frame(self.wfile, resp)
                except (ConnectionError, EOFError):
                    return
                finally:
                    with service._conns_mu:
                        service._conns.discard(self.connection)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()
        # a SERVED master owns lease expiry itself: remote clients may all
        # be dead, and dead clients are exactly when expiry matters
        self.start_timeout_sweeper()
        addr = self._server.server_address
        if _tracing.process_label() is None:
            _tracing.set_process_label(f"master:{addr[1]}")
        # live introspection: PADDLE_TPU_DEBUG_PORT attaches the
        # process-shared debug HTTP server and registers this service's
        # queue state under /statusz
        from ..observability import debug_server as _dbg

        self._debug_key = f"master:{addr[1]}"
        if _dbg.maybe_serve_from_env() is not None:
            _dbg.add_status(self._debug_key, self._debug_status)
        return addr

    def _debug_status(self):
        """Queue-state view for /statusz (never blocks long: stats()
        takes the service lock briefly)."""
        return {
            "stats": self.stats(),
            "lease_timeout_s": self._timeout,
            "failure_max": self._failure_max,
            "snapshot_path": self._snapshot_path,
            "snapshot_term": self._snapshot_term,
            "sweeper_running": self._sweep_stop is not None,
        }

    def shutdown(self):
        """Stop the listener AND sever established connections — a deposed
        leader must not keep serving clients that still hold open sockets
        (they would never re-resolve to the new leader: split-brain)."""
        from ..observability import debug_server as _dbg

        _dbg.remove_status(getattr(self, "_debug_key", None))
        self.stop_timeout_sweeper()
        srv = getattr(self, "_server", None)
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        with getattr(self, "_conns_mu", threading.Lock()):
            for conn in list(getattr(self, "_conns", ())):
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    conn.close()
                except OSError:
                    pass
            if hasattr(self, "_conns"):
                self._conns.clear()


class MasterClient:
    """Trainer-side client (reference go/master/client.go + the ctypes
    python/paddle/v2/master/client.py). Also usable in-process by passing
    the service itself."""

    def __init__(self, addr=None, service: Optional[MasterService] = None,
                 addr_resolver=None, reconnect_retries: int = 8,
                 reconnect_backoff: float = 0.2,
                 timeout: Optional[float] = None):
        """`addr_resolver`: zero-arg callable returning (host, port) of the
        CURRENT master (see election.endpoint_resolver) — consulted on every
        (re)connect, so a standby takeover is followed automatically.
        Retries with backoff span the election gap after a master crash.
        `timeout`: dial + per-RPC deadline in seconds (None = block forever)
        — the role of the reference ctypes client's timeout_sec."""
        self._service = service
        self._timeout = timeout
        if isinstance(addr, str):  # "host:port" accepted everywhere
            host, _, port = addr.rpartition(":")
            addr = (host or "127.0.0.1", int(port))
        self._addr = addr
        self._resolver = addr_resolver
        self._retries = int(reconnect_retries)
        self._backoff = float(reconnect_backoff)
        self._sock = None  # guarded-by: _lock
        self._rfile = None  # guarded-by: _lock
        self._wfile = None  # guarded-by: _lock
        self._lock = threading.Lock()

    def _call(self, method: str, *args):
        if self._service is not None:
            return getattr(self._service, method)(*args)
        last_err: Optional[Exception] = None
        for attempt in range(self._retries + 1):
            try:
                return self._call_once(method, *args)
            except (ConnectionError, OSError) as e:
                # master died or a standby is taking over: back off, then
                # re-resolve the endpoint and retry (get_task/task_finished/
                # task_failed are safe to retry — the lease epoch guard
                # rejects stale duplicates)
                last_err = e
                if attempt < self._retries:
                    time.sleep(self._backoff * (attempt + 1))
        raise ConnectionError(
            f"master unreachable after {self._retries + 1} attempts: "
            f"{last_err}") from last_err

    def _call_once(self, method: str, *args):
        # lint: allow-blocking — _lock serializes this client's frames on
        # its single master connection (same design as RpcClient.call);
        # concurrent trainers each hold their own MasterClient.
        with self._lock, _tracing.span(f"master.client.{method}",
                                       method=method):
            req = {"method": method, "args": list(args)}
            if _tracing.trace_enabled():
                fid = _tracing.new_flow_id()
                wire_tr = _tracing.wire_context(fid)
                if wire_tr is not None:
                    req["__trace__"] = wire_tr
                    _tracing.flow_start(fid)
            try:
                if self._sock is None:
                    addr = self._resolver() if self._resolver else self._addr
                    # timeout covers the dial AND every subsequent
                    # read/write on the socket (a wedged master surfaces
                    # as socket.timeout -> OSError -> retry/raise, not a
                    # silent hang)
                    self._sock = socket.create_connection(
                        addr, timeout=self._timeout)
                    _no_delay(self._sock)
                    self._rfile = self._sock.makefile("rb")
                    self._wfile = self._sock.makefile("wb")
                # sender-side cap must match the SERVER's read cap, or an
                # oversized request dies as an opaque dropped connection
                write_frame(self._wfile, req,
                            max_frame=MasterService._MAX_FRAME)
                resp = read_frame(self._rfile)
                if resp is None:
                    raise ConnectionError(
                        "master closed the connection mid-call")
            except (ConnectionError, OSError):
                # drop the broken socket so the next call reconnects
                try:
                    if self._sock is not None:
                        self._sock.close()
                finally:
                    self._sock = None
                raise
            if not resp.get("ok"):
                raise RuntimeError(f"master RPC failed: {resp.get('error')}")
            return _from_wire(resp.get("result"))

    def set_dataset(self, shard_paths: Sequence[str]):
        return self._call("set_dataset", list(shard_paths))

    def get_task(self) -> Optional[Task]:
        return self._call("get_task")

    def task_finished(self, task_id: int, epoch: Optional[int] = None) -> bool:
        return self._call("task_finished", task_id, epoch)

    def task_failed(self, task_id: int, epoch: Optional[int] = None) -> bool:
        return self._call("task_failed", task_id, epoch)

    def task_released(self, task_id: int, epoch: Optional[int] = None) -> bool:
        """Voluntarily return a leased task to todo, without failure mark."""
        return self._call("task_released", task_id, epoch)

    def all_done(self) -> bool:
        return self._call("all_done")

    def new_pass(self) -> bool:
        """Re-queue the finished pass's tasks for another epoch."""
        return self._call("new_pass")

    def stats(self):
        return self._call("stats")

    def records(self, poll_interval: float = 0.2, should_stop=None):
        """Iterate every record of the leased tasks until the dataset is
        exhausted (role of client.go NextRecord): lease task -> stream its
        recordio shards -> mark finished; crashes mid-task just let the
        lease expire and another trainer re-reads it. `should_stop`:
        zero-arg callable polled while WAITING for a task — lets a
        prefetch pump abandon the pass even when it is parked in the poll
        loop (another trainer holding the last lease), not just at a
        yield."""
        from ..native.recordio import multi_file_reader

        while True:
            if should_stop is not None and should_stop():
                return
            task = self.get_task()
            if task is None:
                if self.all_done():
                    return
                time.sleep(poll_interval)
                continue
            try:
                for rec in multi_file_reader(task.paths):
                    yield rec
            except GeneratorExit:
                # consumer abandoned the pass (gen.close()): hand the
                # lease back NOW so the task re-serves immediately instead
                # of after lease_timeout — and without a failure mark.
                # An unreachable master amounts to the same thing: the
                # lease expires and the task re-serves.
                try:
                    self.task_released(task.id, task.epoch)
                except (ConnectionError, OSError):
                    pass
                raise
            except Exception:
                try:
                    self.task_failed(task.id, task.epoch)
                except (ConnectionError, OSError):
                    # can't report the failure: the lease will expire and
                    # requeue the task anyway — surface the ORIGINAL error
                    _log.warning("task_failed(%d) unreachable; letting "
                                 "the lease expire", task.id)
                raise
            try:
                self.task_finished(task.id, task.epoch)
            except (ConnectionError, OSError) as e:
                # RPC failure is NOT a trainer crash: the master (or its
                # successor) re-serves this task when the lease lapses —
                # at-least-once delivery, same as a death mid-task. Keep
                # training on the next lease instead of dying here.
                _log.warning("task_finished(%d) unreachable (%s); task "
                             "re-serves via lease expiry", task.id, e)

    def close(self):
        # under _lock (guards-lint finding): a close() racing another
        # thread's in-flight _call_once could tear the socket down
        # mid-frame — or leak the one create_connection just opened
        with self._lock:
            if self._sock is not None:
                self._sock.close()
                self._sock = None
