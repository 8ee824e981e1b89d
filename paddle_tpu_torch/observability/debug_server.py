"""Live introspection HTTP server — the counterpart of
``paddle_tpu/observability/debug_server.py``: inspect a running serving
replica, fleet controller or trainer WITHOUT killing it.

Stdlib-only (http.server on an ephemeral port), serving:

  /healthz   liveness probe — 200 "ok"
  /metrics   the whole paddle_tpu_torch.observability registry in
             Prometheus exposition text (RPC latency histograms,
             fleet.*, autotune.*, tracing.dropped_spans, ...)
  /tracez    recent spans from the trace ring buffer as JSON
             (?n=100 bounds the tail; includes enable state + drops)
  /statusz   process status JSON: flags, the torch device view, uptime,
             plus every registered status provider (a ServingServer's
             "serving:<port>" section, a FleetController's
             "fleet:<port>", the mesh layer's "mesh")

The JAX package's ``/statusz`` carries a ``jax`` section (backend,
device count, device strings). The port's carries ``device`` instead:
the server's device, the platform, the card count, the card names and
the torch and CUDA versions. ``DebugServer(device=None)`` means the
card and raises without one; ``device="cpu"`` describes the CPU.

Two ways in:

  - explicit: ``DebugServer(device=...).start(port=0)`` → (host, port)
  - env flag: ``PADDLE_TPU_DEBUG_PORT=0`` (ephemeral) or ``=8321``
    makes ``ServingServer.serve()`` / ``FleetController.serve()`` start
    the PROCESS-SHARED server via ``maybe_serve_from_env()`` and attach
    their status providers; the bound address is logged at WARNING.

Read-only by design: every endpoint is a GET with no side effects. It
binds 127.0.0.1 by default.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from . import metrics as _metrics, tracing as _tracing
from .log import get_logger

__all__ = ["DebugServer", "maybe_serve_from_env", "shared_server",
           "ensure_shared", "add_status", "remove_status", "device_view"]

_log = get_logger("debug")

_START_TIME = time.time()


def _json_safe(v):
    """Best-effort JSON coercion: status providers return whatever is
    handy (numpy ints, tuples, sets); the wire format must never raise."""
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, set, frozenset)):
        return [_json_safe(x) for x in v]
    if isinstance(v, (str, bool)) or v is None:
        return v
    if isinstance(v, (int, float)):
        return v
    try:  # numpy scalars expose item(); anything else degrades to repr
        return v.item()
    except AttributeError:
        return repr(v)


def _flags_view() -> Dict[str, Any]:
    from ..flags import FLAGS

    return {k: _json_safe(FLAGS[k]) for k in sorted(FLAGS)}


def device_view(device) -> Dict[str, Any]:
    """The ``/statusz`` device section: the server's device, the
    platform, the card count and names, and the torch/CUDA versions."""
    import torch

    cuda = torch.cuda.is_available()
    n = torch.cuda.device_count() if cuda else 0
    return {"device": str(device),
            "platform": "gpu" if device.type == "cuda" else device.type,
            "device_count": n,
            "devices": [torch.cuda.get_device_name(i) for i in range(n)],
            "torch": torch.__version__,
            "cuda": torch.version.cuda}


class DebugServer:
    """One HTTP introspection server; `add_status(name, fn)` registers a
    zero-arg callable whose (JSON-safe-coerced) return value appears
    under that name in /statusz. Provider failures are reported inline
    per provider — one broken subsystem must not blank the whole page."""

    def __init__(self, device=None):
        from ..device import resolve_device

        self.device = resolve_device(device)
        self._providers: Dict[str, Callable[[], Any]] = {}
        self._mu = threading.Lock()
        self._server: Optional[ThreadingHTTPServer] = None

    def add_status(self, name: str, fn: Callable[[], Any]):
        with self._mu:
            self._providers[str(name)] = fn

    def remove_status(self, name: Optional[str]):
        if name is None:
            return
        with self._mu:
            self._providers.pop(str(name), None)

    # -- endpoint payloads -------------------------------------------------
    def _statusz(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "pid": os.getpid(),
            "argv": list(sys.argv),
            "uptime_s": round(time.time() - _START_TIME, 3),
            "process_label": _tracing.process_label(),
            "flags": _flags_view(),
            "device": device_view(self.device),
            "tracing": {
                "enabled": _tracing.trace_enabled(),
                "buffer_capacity": _tracing.buffer_capacity(),
                "dropped_spans": _tracing.dropped_spans(),
            },
        }
        with self._mu:
            providers = dict(self._providers)
        for name, fn in sorted(providers.items()):
            try:
                out[name] = _json_safe(fn())
            except Exception as e:
                out[name] = {"error": f"{type(e).__name__}: {e}"}
        return out

    @staticmethod
    def _tracez(n: int) -> Dict[str, Any]:
        events = _tracing.trace_events()
        return {
            "enabled": _tracing.trace_enabled(),
            "buffer_capacity": _tracing.buffer_capacity(),
            "buffered": len(events),
            "dropped_spans": _tracing.dropped_spans(),
            "recent": events[-n:] if n > 0 else [],
        }

    # -- lifecycle ---------------------------------------------------------
    def start(self, host: str = "127.0.0.1", port: int = 0
              ) -> Tuple[str, int]:
        srv = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                u = urlparse(self.path)
                try:
                    if u.path == "/healthz":
                        self._send(200, "text/plain; charset=utf-8", "ok\n")
                    elif u.path == "/metrics":
                        self._send(200, "text/plain; version=0.0.4",
                                   _metrics.prometheus_text())
                    elif u.path == "/tracez":
                        q = parse_qs(u.query)
                        n = int(q.get("n", ["100"])[0])
                        self._send(200, "application/json",
                                   json.dumps(srv._tracez(n)))
                    elif u.path == "/statusz":
                        self._send(200, "application/json",
                                   json.dumps(srv._statusz()))
                    else:
                        self._send(404, "text/plain; charset=utf-8",
                                   "not found; try /healthz /metrics "
                                   "/tracez /statusz\n")
                except (BrokenPipeError, ConnectionError):
                    pass  # scraper went away mid-response

            def _send(self, code: int, ctype: str, body: str):
                data = body.encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, fmt, *args):  # stdlib logs to stderr
                _log.debug("debug-server %s", fmt % args)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        t = threading.Thread(target=self._server.serve_forever,
                             daemon=True, name="paddle-tpu-debug-http")
        t.start()
        return self._server.server_address

    @property
    def address(self) -> Tuple[str, int]:
        return self._server.server_address

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


# --- the process-shared instance the env flag controls -------------------

_shared: Optional[DebugServer] = None
_shared_mu = threading.Lock()


def shared_server() -> Optional[DebugServer]:
    """The process-wide server (None if never started)."""
    return _shared


def ensure_shared(port: int = 0, host: str = "127.0.0.1",
                  device=None) -> DebugServer:
    """Start (once) and return the process-shared server. Subsequent
    calls — a second ServingServer in the same process, the fleet
    controller — reuse it: one port per process, many status
    providers. ``device`` (``None``: the card) is the first caller's."""
    global _shared
    with _shared_mu:
        if _shared is None:
            s = DebugServer(device=device)
            addr = s.start(host, port)
            _shared = s
            _log.warning("debug server listening on http://%s:%d "
                         "(/healthz /metrics /tracez /statusz)", *addr)
            # the mesh layer's section, as the JAX package registers it
            from ..mesh.observe import mesh_status

            s.add_status("mesh", mesh_status)
        return _shared


def stop_shared():
    """Stop the process-shared server (tests and the chip smoke)."""
    global _shared
    with _shared_mu:
        s, _shared = _shared, None
    if s is not None:
        s.stop()


def maybe_serve_from_env(device=None) -> Optional[DebugServer]:
    """PADDLE_TPU_DEBUG_PORT unset/empty → None; "0" → shared server on
    an ephemeral port; "<port>" → that port. Called by every serve()
    entry point so attaching introspection needs no code changes.

    A malformed port value or a bind failure degrades to a logged error
    — the OPTIONAL introspection layer must not take down the
    data-plane server that asked for it. A missing card (``device``
    ``None``) still raises, as every entry point of the port does."""
    port = os.environ.get("PADDLE_TPU_DEBUG_PORT")
    if port is None or port.strip() == "":
        return None
    try:
        return ensure_shared(int(port), device=device)
    except (ValueError, OSError) as e:
        _log.error("debug server disabled: PADDLE_TPU_DEBUG_PORT=%r "
                   "unusable (%s: %s)", port, type(e).__name__, e)
        return None


def add_status(name: str, fn: Callable[[], Any]):
    """Register on the shared server if it is running (no-op otherwise —
    callers don't need to care whether the operator enabled the flag)."""
    if _shared is not None:
        _shared.add_status(name, fn)


def remove_status(name: Optional[str]):
    if _shared is not None:
        _shared.remove_status(name)
