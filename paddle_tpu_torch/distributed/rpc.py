"""Length-prefixed JSON RPC framing — the transport under the parameter
server (and the same wire shape the master service uses,
distributed/master.py:serve). One message = 4-byte little-endian length +
UTF-8 JSON header, then zero or more RAW binary segments (lengths listed
in the header's "__segs__"). Tensors ride as raw segments — no base64
inflation, no JSON number lists — matching the reference transport's
zero-copy intent (operators/detail/sendrecvop_utils.cc serializes
VariableMessage as name + type + dims + chunked raw bytes; the proto is
send_recv.proto:17). Small/legacy frames may still inline tensors as
base64 blobs; both decode. Nothing needs pickle, so a hostile peer can at
worst force a parse error or a dropped connection.
"""
from __future__ import annotations

import base64
import json
import random
import socket
import socketserver
import struct
import threading
import time
import uuid
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import faults as _faults
from ..observability import metrics as _metrics, tracing as _tracing
from ..observability.log import get_logger

_log = get_logger("rpc")

# the JSON header is small once tensors ride as segments: 16 MiB is roomy
MAX_FRAME = 16 << 20
# raw tensor segments per message: 1 GiB total
MAX_SEGMENT_BYTES = 1 << 30


class FrameTooLargeError(IOError):
    """A payload failed the SENDER-side size pre-flight (nothing hit the
    wire). Deterministic and actionable ("shard the tensor") — the retry
    loop must re-raise it untouched, never burn its budget re-sending
    the same oversized payload and bury the cause in a ConnectionError."""


class _ByteMeter(threading.local):
    """Per-thread wire-byte tally. read_frame/write_frame credit it as
    bytes cross the socket; RpcClient.call and the server handler
    snapshot it around each message to attribute deltas to their side's
    counters. Thread-local so concurrent client threads and server
    handler threads never share (or contend on) an accumulator."""

    def __init__(self):
        self.read = 0
        self.written = 0


_meter = _ByteMeter()

# client-side observability: per-method latency histograms are created on
# first use (method sets are small); byte/retry/timeout counters are flat
_m_cli_bytes_out = _metrics.counter("rpc.client.bytes_out")
_m_cli_bytes_in = _metrics.counter("rpc.client.bytes_in")
_m_cli_conn_retries = _metrics.counter("rpc.client.connect_retries")
# retransmissions: retry attempts after a prior attempt began writing the
# request frame (the server MAY have received it — the dedup cache is what
# makes resending correct). For plans that only drop RESPONSE frames this
# equals rpc.server.dedup_hits exactly: every such drop implies delivery,
# and every retransmit of a delivered frame is answered from the cache.
_m_cli_retries = _metrics.counter("rpc.client.retries")
_m_cli_timeouts = _metrics.counter("rpc.client.timeouts")
_m_cli_errors = _metrics.counter("rpc.client.errors")
_m_srv_bytes_out = _metrics.counter("rpc.server.bytes_out")
_m_srv_bytes_in = _metrics.counter("rpc.server.bytes_in")
_m_srv_errors = _metrics.counter("rpc.server.errors")
_m_srv_dedup = _metrics.counter("rpc.server.dedup_hits")


def _host(t):
    """A tensor as host numpy: a torch tensor (a CUDA one included) by one
    explicit device-to-host copy, numpy as itself."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()  # the one DtoH copy of this tensor
    return np.asarray(t)


def to_wire(obj, segs: Optional[list] = None):
    """JSON-encode numpy arrays, torch tensors and SelectedRows. With
    `segs` (a list to append to), tensor bytes become out-of-band raw
    segments referenced by index; without it they inline as base64
    (legacy/small-frame form). A torch tensor, on the card or not, goes
    to host numpy by one explicit copy (``_host``) and then rides as the
    array would, so a frame carries the JAX package's bytes for the same
    values; a SelectedRows' rows and value go the same way, one copy
    each."""
    from ..fluid.selected_rows import is_selected_rows

    if is_selected_rows(obj):
        return {"__sr__": {
            "rows": to_wire(_host(obj.rows), segs),
            "value": to_wire(_host(obj.value), segs),
            "height": int(obj.height),
        }}
    if isinstance(obj, torch.Tensor):
        obj = _host(obj)
    if isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        spec = {"dtype": str(arr.dtype), "shape": list(arr.shape)}
        if segs is not None:
            spec["seg"] = len(segs)
            segs.append(arr.tobytes())
        else:
            spec["b64"] = base64.b64encode(arr.tobytes()).decode("ascii")
        return {"__nd__": spec}
    if isinstance(obj, dict):
        return {k: to_wire(v, segs) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_wire(v, segs) for v in obj]
    return obj


def from_wire(obj, segs: Optional[list] = None, copy: bool = True):
    """Decode a wire object. ``copy=True`` (default) materializes each
    tensor as a fresh writable array. ``copy=False`` returns NON-
    WRITEABLE views straight over the frame's segment bytes — zero
    receive-side copies, the right mode for read-path results
    (get_param pulls) that are immediately consumed by tensor math;
    callers that need to mutate in place must copy themselves
    (numpy raises on write, so misuse is loud, never silent
    corruption). The view pins its frame's bytes alive exactly as long
    as the array — same peak memory as the copy, minus the copy. A
    SelectedRows decodes with numpy rows and value: the receiver's
    Executor places it on its own device when it is fed."""
    from ..fluid.selected_rows import SelectedRows

    if isinstance(obj, dict):
        if "__nd__" in obj and len(obj) == 1:
            spec = obj["__nd__"]
            if "seg" in spec:
                if segs is None:
                    raise ValueError("segment-encoded tensor in a message "
                                     "read without segments")
                raw = segs[int(spec["seg"])]
            else:
                raw = base64.b64decode(spec["b64"])
            arr = np.frombuffer(
                raw, dtype=np.dtype(spec["dtype"])
            ).reshape(spec["shape"])
            # frombuffer over immutable bytes is already read-only; the
            # copy is what makes it writable (and owner of its memory)
            return arr.copy() if copy else arr
        if "__sr__" in obj and len(obj) == 1:
            spec = obj["__sr__"]
            return SelectedRows(
                from_wire(spec["rows"], segs, copy),
                from_wire(spec["value"], segs, copy),
                int(spec["height"]),
            )
        return {k: from_wire(v, segs, copy) for k, v in obj.items()}
    if isinstance(obj, list):
        return [from_wire(v, segs, copy) for v in obj]
    return obj


def _no_delay(sock):
    """TCP_NODELAY on a connection: a message is a header write and then
    its segments' writes, and Nagle's algorithm held each small write
    after the first for the peer's delayed ACK (~40 ms a call on
    loopback)."""
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)


def read_frame(rfile, max_frame: int = MAX_FRAME) -> Optional[dict]:
    head = rfile.read(4)
    if len(head) != 4:
        return None
    (n,) = struct.unpack("<I", head)
    if n > max_frame:
        raise IOError(f"frame of {n} bytes exceeds cap")
    body = rfile.read(n)
    if len(body) != n:
        return None
    _meter.read += 4 + n
    return json.loads(body.decode("utf-8"))


def write_frame(wfile, obj: dict, max_frame: int = MAX_FRAME):
    out = json.dumps(obj).encode("utf-8")
    if len(out) > max_frame:
        # fail HERE with the cause — the receiver would just drop the
        # connection, and the sender would retry the same oversized
        # payload forever behind an opaque ConnectionError
        raise FrameTooLargeError(
            f"frame of {len(out)} bytes exceeds the {max_frame}-byte cap "
            "(tensor too large for one RPC — shard it)"
        )
    wfile.write(struct.pack("<I", len(out)) + out)
    wfile.flush()
    _meter.written += 4 + len(out)


def write_msg(wfile, obj, max_frame: int = MAX_FRAME):
    """Encode `obj` (tensors as raw segments) and write header + segments.
    All size checks happen BEFORE the first byte hits the socket, so an
    oversized payload raises IOError with the stream still clean — the
    caller can still send a small error frame on the same connection."""
    segs: list = []
    wire = to_wire(obj, segs)
    total = sum(len(s) for s in segs)
    if total > MAX_SEGMENT_BYTES:
        raise FrameTooLargeError(
            f"message tensors total {total} bytes, exceeding the "
            f"{MAX_SEGMENT_BYTES}-byte cap (shard the tensor)"
        )
    if segs:
        wire = {"__segs__": [len(s) for s in segs], **wire} \
            if isinstance(wire, dict) else {"__segs__": [len(s) for s in segs],
                                            "__body__": wire}
    write_frame(wfile, wire, max_frame)
    for s in segs:
        wfile.write(s)
        _meter.written += len(s)
    if segs:
        wfile.flush()


def read_msg(rfile, max_frame: int = MAX_FRAME):
    """Read one header frame + its raw segments. Returns (obj, segs) with
    tensors NOT yet decoded — pass both to from_wire — or None on EOF."""
    obj = read_frame(rfile, max_frame)
    if obj is None:
        return None
    segs: list = []
    if isinstance(obj, dict) and "__segs__" in obj:
        lens = obj.pop("__segs__")
        # validate EVERY length individually: a negative entry would turn
        # rfile.read(-1) into a read-until-EOF hang, and mixed
        # negative/huge entries could cancel out in a sum-only check
        total = 0
        for n in lens:
            n = int(n)
            if n < 0 or n > MAX_SEGMENT_BYTES:
                raise IOError(f"bad segment length {n}")
            total += n
            if total > MAX_SEGMENT_BYTES:
                raise IOError("declared segments exceed the byte cap")
        for n in lens:
            b = rfile.read(int(n))
            if len(b) != int(n):
                return None
            _meter.read += len(b)
            segs.append(b)
        if "__body__" in obj and len(obj) == 1:
            obj = obj["__body__"]
    return obj, segs


class _DedupCache:
    """Bounded (client_id, seq) -> response cache — the server half of
    the idempotency-token protocol that makes client retransmits SAFE.

    `begin(rid)` either claims the id (first delivery: the caller must
    run the handler, then `finish` with the response) or returns the
    existing entry (retransmit: the caller waits for the original
    in-flight execution to finish and resends ITS response — the
    handler must not run twice, which for push_grad is the whole
    point). In-flight entries carry an Event so a retransmit that races
    the original's (slow) execution blocks instead of re-executing.

    Bounded: past `cap` entries, COMPLETED responses older than
    `min_age` seconds are dropped, oldest first. A retransmit arriving
    after eviction would re-execute, so eviction must never outrun the
    client's retry window — which is dominated by the PER-ATTEMPT
    socket timeout, not the backoff sleeps: a black-holed response
    means the client parks in read for its full timeout (180 s default)
    before retransmitting the same token. In-flight entries are never
    evicted (a racing retransmit must find the original, not re-run
    the handler), and completed ones are held for at least `min_age` —
    sized past 4 default-timeout attempts — even if that temporarily
    overshoots `cap` under a burst. A hard limit of 4x cap is the
    memory safety valve: past it the oldest completed entries go
    regardless of age (a retransmit landing after THAT is the
    documented residual risk; entries are small because large reads
    are declared idempotent and skip this cache entirely)."""

    def __init__(self, cap: int = 1024, min_age: float = 900.0):
        self._cap = cap
        self._min_age = float(min_age)
        self._mu = threading.Lock()
        self._entries: "OrderedDict[tuple, dict]" = \
            OrderedDict()  # guarded-by: _mu
        # lifetime retransmit answers, for stats()
        self._hits = 0  # guarded-by: _mu

    def stats(self) -> Dict[str, int]:
        """Introspection for /statusz: size, in-flight count, lifetime
        hits. O(n) over a bounded cache, only on debug-server scrapes."""
        with self._mu:
            in_flight = sum(1 for e in self._entries.values()
                            if not e["ev"].is_set())
            return {"entries": len(self._entries), "in_flight": in_flight,
                    "hits": self._hits, "cap": self._cap}

    def begin(self, rid):
        with self._mu:
            e = self._entries.get(rid)
            if e is not None:
                self._entries.move_to_end(rid)
                self._hits += 1
                return e, False
            e = {"ev": threading.Event(), "resp": None, "t": None}
            self._entries[rid] = e
            n = len(self._entries)
            if n > self._cap:
                now = time.monotonic()
                aged = [k for k, v in self._entries.items()
                        if v["ev"].is_set()
                        and now - v["t"] >= self._min_age]
                drop = aged[:n - self._cap]
                if n - len(drop) > 4 * self._cap:  # safety valve
                    done = [k for k, v in self._entries.items()
                            if v["ev"].is_set()]
                    drop = done[:n - self._cap]
                for k in drop:
                    del self._entries[k]
            return e, True

    @staticmethod
    def finish(entry, resp):
        entry["resp"] = resp
        entry["t"] = time.monotonic()
        entry["ev"].set()

    @staticmethod
    def wait(entry, timeout: float = 3600.0):
        # generous: the original may legitimately be a barrier parked for
        # a whole slow sync round — a waiter giving up earlier than the
        # barrier channel's client timeout would manufacture failures
        if entry["ev"].wait(timeout):
            return entry["resp"]
        return {"ok": False,
                "error": "duplicate call: original still executing"}


class RpcServer:
    """Threaded JSON-RPC server over a method dispatch table.

    `idempotent`: method names whose re-execution is harmless (reads
    like get_param). Their responses skip the dedup cache — retransmits
    just re-run them — so a server streaming large tensors never pins
    up to `dedup_cap` response arrays in the cache. Everything else
    (push_grad!) goes through the exactly-once dedup protocol."""

    def __init__(self, methods: Dict[str, Callable], dedup_cap: int = 1024,
                 idempotent: Optional[set] = None):
        self._methods = dict(methods)
        self._server: Optional[socketserver.ThreadingTCPServer] = None
        self._dedup = _DedupCache(dedup_cap)
        self._idempotent = frozenset(idempotent or ())

    def stats(self) -> Dict[str, Any]:
        """Transport introspection for the debug server's /statusz:
        registered methods, idempotent set, and dedup-cache occupancy."""
        return {
            "methods": sorted(self._methods),
            "idempotent": sorted(self._idempotent),
            "dedup": self._dedup.stats(),
        }

    def serve(self, host: str = "127.0.0.1", port: int = 0
              ) -> Tuple[str, int]:
        methods = self._methods
        dedup = self._dedup
        idempotent = self._idempotent

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                try:
                    while True:
                        r0, w0 = _meter.read, _meter.written
                        try:
                            msg = read_msg(self.rfile)
                        except (json.JSONDecodeError, UnicodeDecodeError) as e:
                            # malformed header: report, then CLOSE. If the
                            # unparseable header declared __segs__, their raw
                            # bytes are still on the wire and cannot be
                            # skipped — reading on would parse tensor bytes
                            # as the next length prefix and silently desync
                            _m_srv_errors.inc()
                            _log.error(
                                "bad frame from %s: %s",
                                self.client_address, e)
                            write_frame(self.wfile,
                                        {"ok": False,
                                         "error": f"bad frame: {e}"})
                            return
                        if msg is None:
                            return
                        req, segs = msg
                        method = req.get("method", "?")
                        # trace context stamped by a tracing-enabled
                        # client: adopt it so this handler's span (and
                        # everything under it) joins the client's trace,
                        # and answer the flow event so Perfetto draws the
                        # client→server arrow. Popped BEFORE dispatch so
                        # handlers never see the header as an argument.
                        wire_tr = req.pop("__trace__", None)
                        # idempotency token: [client_id, seq] stamped by
                        # RpcClient; frames without one (legacy/foreign
                        # peers) execute unconditionally as before
                        rid = req.get("id")
                        entry = first = None
                        if (isinstance(rid, list) and len(rid) == 2
                                and isinstance(rid[1], int)
                                and method not in idempotent):
                            entry, first = dedup.begin(
                                (str(rid[0]), rid[1]))
                            if not first:
                                # retransmit: ack from the cache — the
                                # handler already ran (or is running)
                                _m_srv_dedup.inc()
                                _log.info(
                                    "dedup hit for %r id=%s from %s",
                                    method, rid, self.client_address)
                                self._respond(method, dedup.wait(entry),
                                              traced=wire_tr is not None)
                                _m_srv_bytes_in.inc(_meter.read - r0)
                                _m_srv_bytes_out.inc(_meter.written - w0)
                                continue
                        t0 = time.perf_counter()
                        # span named per-method ("rpc.server.push_grad")
                        # so the merged timeline reads without arg
                        # inspection; the metric-name hostile-peer concern
                        # doesn't apply — spans land in a bounded ring,
                        # not the process-wide registry
                        with _tracing.adopt(wire_tr), \
                                _tracing.span(f"rpc.server.{method}",
                                              method=method):
                            if wire_tr:
                                _tracing.flow_end(wire_tr.get("f"))
                            try:
                                _faults.fire(f"handler.{method}")
                                fn = methods.get(method)
                                if fn is None:
                                    raise ValueError(
                                        f"unknown RPC method {method!r}")
                                result = fn(
                                    *from_wire(req.get("args", []), segs))
                                resp = {"ok": True, "result": result}
                            except Exception as e:  # report, keep serving
                                # handler failures used to surface only
                                # client-side; name the method and peer so
                                # the server's log carries the evidence
                                _m_srv_errors.inc()
                                _log.error(
                                    "handler %r failed for peer %s: "
                                    "%s: %s", method, self.client_address,
                                    type(e).__name__, e)
                                resp = {"ok": False,
                                        "error": f"{type(e).__name__}: {e}"}
                        if entry is not None:
                            # cache BEFORE responding: a response lost on
                            # the wire must find its answer here when the
                            # client retransmits
                            dedup.finish(entry, resp)
                        if method in methods:
                            # per-method only for REGISTERED methods — a
                            # hostile peer must not mint unbounded metric
                            # names into the process-wide registry
                            _metrics.histogram(
                                f"rpc.server.{method}.ms").observe(
                                    (time.perf_counter() - t0) * 1e3)
                        self._respond(method, resp,
                                      traced=wire_tr is not None)
                        _m_srv_bytes_in.inc(_meter.read - r0)
                        _m_srv_bytes_out.inc(_meter.written - w0)
                except (ConnectionError, EOFError, IOError):
                    return

            def _respond(self, method, resp, traced=False):
                if traced:
                    # clock handshake for `timeline merge`: the server's
                    # wall time rides the response; the client brackets
                    # it with its own send/recv times (NTP-style) and
                    # feeds tracing.note_clock_offset. A COPY — the
                    # dedup cache must keep the unstamped original
                    resp = {**resp, "__ts_srv__": time.time() * 1e6}
                self._respond_raw(method, resp)

            def _respond_raw(self, method, resp):
                try:
                    write_msg(self.wfile, resp)
                except IOError as e:
                    # oversized response (caught before any byte was
                    # written): tell the CLIENT why instead of
                    # dropping the connection into an opaque
                    # "server closed mid-call"
                    _m_srv_errors.inc()
                    _log.error(
                        "oversized response to %r for peer %s: %s",
                        method, self.client_address, e)
                    write_frame(self.wfile,
                                {"ok": False,
                                 "error": f"{type(e).__name__}: {e}"})

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

            def __init__(self, addr, handler_cls):
                super().__init__(addr, handler_cls)
                # established connections, tracked so kill() can sever
                # them the way a SIGKILLed process's sockets die —
                # shutdown() alone only closes the LISTENER, and an
                # in-process chaos "kill" that leaves accepted
                # connections answering proves nothing about failover
                self._conns_mu = threading.Lock()
                self._conns: set = set()
                self._severed = False  # guarded-by: _conns_mu

            @staticmethod
            def _sever(conn):
                try:
                    conn.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    conn.close()
                except OSError:
                    pass

            def track(self, conn, on: bool):
                with self._conns_mu:
                    if on and self._severed:
                        # a handler thread whose accept raced kill():
                        # it reached setup() only after sever_all()
                        # snapshotted the set — without this late kill
                        # the connection would survive the "SIGKILL"
                        # and keep answering
                        late_kill = True
                    else:
                        late_kill = False
                        (self._conns.add if on
                         else self._conns.discard)(conn)
                if late_kill:
                    self._sever(conn)

            def sever_all(self):
                with self._conns_mu:
                    self._severed = True
                    conns = list(self._conns)
                    self._conns.clear()
                for c in conns:
                    self._sever(c)

        class TrackedHandler(Handler):
            def setup(self):
                super().setup()
                _no_delay(self.connection)
                self.server.track(self.connection, True)

            def finish(self):
                self.server.track(self.connection, False)
                super().finish()

        self._server = Server((host, port), TrackedHandler)
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()
        return self._server.server_address

    @property
    def address(self) -> Tuple[str, int]:
        return self._server.server_address

    def shutdown(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None

    def kill(self):
        """Abrupt transport death for chaos tests: stop accepting AND
        sever every ESTABLISHED connection, so peers mid-call see a
        connection reset — what a SIGKILLed process's sockets do.
        Nothing else is torn down: handlers that were executing keep
        running to completion (their replies go nowhere), exactly like
        work in flight when a real process dies mid-reply."""
        if self._server is not None:
            self._server.shutdown()
            self._server.sever_all()
            self._server.server_close()
            self._server = None


class RpcClient:
    """Blocking client with SAFE retries. Every request frame carries an
    idempotency token ``id = [client_id, seq]``; the server's dedup
    cache answers a retransmitted frame from the original response
    without re-running the handler, so resending a push_grad whose
    response was lost cannot apply the gradient twice — which is what
    makes retrying on a dropped connection correct at all (the old
    client reconnected but never retransmitted, so ONE lost frame
    failed the whole step). Connection failures retry with exponential
    backoff + jitter up to a bounded budget; application errors
    (``ok: false`` responses) are delivered results and never retried.
    The default timeout exceeds the server's default 120s sync-barrier
    wait so a slow round can't masquerade as a dead connection; barrier
    channels use param_server.BARRIER_CLIENT_TIMEOUT, which outlasts
    any configurable barrier_timeout."""

    def __init__(self, addr: Tuple[str, int], timeout: float = 180.0,
                 retries: int = 3, backoff: float = 0.05,
                 connect_timeout: Optional[float] = None):
        """`timeout` bounds each read/write; `connect_timeout` bounds the
        DIAL only (default: min(timeout, 30s)) — a channel that
        legitimately waits hours for a response (barrier) must still
        discover a black-holed host in seconds, not inherit the long
        read timeout into every SYN."""
        if isinstance(addr, str):
            host, _, port = addr.rpartition(":")
            addr = (host or "127.0.0.1", int(port))
        self._addr = tuple(addr)
        self._timeout = timeout
        self._connect_timeout = (min(timeout, 30.0)
                                 if connect_timeout is None
                                 else float(connect_timeout))
        self._retries = max(0, int(retries))
        self._backoff = float(backoff)
        # connection state + token sequence all ride _mu — the same lock
        # that serializes call() on this client's single connection
        self._sock: Optional[socket.socket] = None  # guarded-by: _mu
        self._rfile = None  # guarded-by: _mu
        self._wfile = None  # guarded-by: _mu
        self._mu = threading.Lock()
        # token namespace: unique per client INSTANCE (uuid, not addr) —
        # two clients to one server must never collide in its dedup cache
        self._client_id = uuid.uuid4().hex[:16]
        self._seq = 0  # guarded-by: _mu

    def call(self, method: str, *args, copy_result: bool = True):
        """``copy_result=False``: tensors in the response come back as
        read-only views over the received frame bytes — zero receive-
        side copies, for read-path results (get_param/get_rows pulls)
        that feed straight into tensor math. The default stays a
        writable copy so callers that mutate results in place keep
        working."""
        t0 = time.perf_counter()
        # lint: allow-blocking — _mu deliberately serializes calls (and
        # their retry sleeps) on this client's single connection: two
        # threads interleaving frames on one socket would corrupt the
        # stream. Blocking callers park here by design; use a separate
        # channel (get_client(ep, channel=...)) for isolation.
        with self._mu, _tracing.span(f"rpc.client.{method}",
                                     method=method):
            self._seq += 1
            req = {"method": method, "args": list(args),
                   "id": [self._client_id, self._seq]}
            if _tracing.trace_enabled():
                # one flow id per LOGICAL call (retransmits share it —
                # the server answers whichever delivery executed): the
                # idempotency token already names the call uniquely
                fid = f"{self._client_id}:{self._seq}"
                wire_tr = _tracing.wire_context(fid)
                if wire_tr is not None:
                    req["__trace__"] = wire_tr
                    _tracing.flow_start(fid)
            sent_any = False
            last_err: Optional[Exception] = None
            for attempt in range(self._retries + 1):
                if attempt:
                    if sent_any:
                        _m_cli_retries.inc()  # a true retransmission
                    else:
                        _m_cli_conn_retries.inc()
                    # exponential backoff with jitter, capped: spreads a
                    # thundering herd of trainers re-dialing a restarted
                    # pserver without stretching recovery into minutes
                    delay = min(self._backoff * (2 ** (attempt - 1)), 2.0)
                    time.sleep(delay * (0.5 + random.random() * 0.5))
                try:
                    resp, segs = self._attempt(method, req)
                    break
                except FrameTooLargeError:
                    # deterministic sender-side pre-flight failure:
                    # resending the same payload can never succeed —
                    # surface the "shard it" diagnosis directly
                    _m_cli_errors.inc()
                    raise
                except (ConnectionError, OSError) as e:
                    (_m_cli_timeouts if isinstance(e, socket.timeout)
                     else _m_cli_errors).inc()
                    sent_any = sent_any or getattr(e, "_after_send", False)
                    self.close_locked()
                    last_err = e
            else:
                raise ConnectionError(
                    f"RPC {method} to {self._addr} failed after "
                    f"{self._retries + 1} attempts: {last_err}"
                ) from last_err
        _metrics.histogram(f"rpc.client.{method}.ms").observe(
            (time.perf_counter() - t0) * 1e3)
        if not resp.get("ok"):
            _m_cli_errors.inc()
            raise RuntimeError(f"RPC {method} failed: {resp.get('error')}")
        return from_wire(resp.get("result"), segs, copy=copy_result)

    def _attempt(self, method: str, req: dict):
        """One connect+send+recv try. Exceptions are tagged with
        `_after_send` once the request frame started down the wire, so
        the retry loop can tell a retransmission (counts toward
        rpc.client.retries, may hit the server's dedup cache) from a
        never-sent re-dial."""
        if self._sock is None:
            _faults.fire("connect")
            self._sock = socket.create_connection(
                self._addr, timeout=self._connect_timeout)
            self._sock.settimeout(self._timeout)
            _no_delay(self._sock)
            self._rfile = self._sock.makefile("rb")
            self._wfile = self._sock.makefile("wb")
        r0, w0 = _meter.read, _meter.written
        sent = False
        try:
            _faults.fire(f"call.{method}")  # delay rules sleep here
            try:
                _faults.fire(f"send.{method}")
            except _faults.InjectedFault:
                # simulate a MID-FRAME disconnect: a dangling length
                # prefix with a truncated body, then the connection dies
                # — the server must discard it without desyncing
                try:
                    self._wfile.write(struct.pack("<I", 64) + b"\x7f")
                    self._wfile.flush()
                except OSError:
                    pass
                raise
            t_send = time.time()
            write_msg(self._wfile, req)
            sent = True
            _faults.fire(f"recv.{method}")  # response lost after delivery
            msg = read_msg(self._rfile)
        except (ConnectionError, OSError) as e:
            e._after_send = sent
            raise
        finally:
            _m_cli_bytes_out.inc(_meter.written - w0)
            _m_cli_bytes_in.inc(_meter.read - r0)
        if msg is None:
            err = ConnectionError("server closed mid-call")
            err._after_send = True
            raise err
        obj, segs = msg
        if isinstance(obj, dict) and "__ts_srv__" in obj:
            # NTP-style offset sample: the server stamped its wall time
            # mid-round-trip; the midpoint of our send/recv brackets it,
            # so (server - midpoint) estimates the clock skew `timeline
            # merge` corrects for. Popped so callers never see it.
            srv_us = obj.pop("__ts_srv__")
            _tracing.note_clock_offset(
                float(srv_us) - (t_send + time.time()) / 2.0 * 1e6)
        return obj, segs

    def close_locked(self):
        # close the makefile objects too: they hold their own references
        # to the socket's fd, and a client that cycles through many
        # broken connections would otherwise leak both wrappers per cycle
        for f in (self._rfile, self._wfile):
            if f is not None:
                try:
                    f.close()
                except (OSError, ValueError):
                    pass
        self._rfile = self._wfile = None
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self):
        with self._mu:
            self.close_locked()
