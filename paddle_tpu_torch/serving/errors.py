"""Typed serving errors.

Every error a ServingServer hands back rides the RPC wire as the string
``"<TypeName>: <message>"`` (distributed/rpc.py wraps handler exceptions
that way); ServingClient parses the type name back out and re-raises the
matching class, so callers catch ``ServerOverloaded`` — a structured,
immediate admission rejection — instead of pattern-matching error
strings. Overload/deadline/not-found are APPLICATION errors: RpcClient
never retries them (retries are for transport failures only), which is
what makes an overloaded server shed load instead of being hammered by
its own rejected clients."""
from __future__ import annotations

__all__ = [
    "ServingError", "ServerOverloaded", "DeadlineExceeded",
    "ModelNotFound", "RequestTooLarge", "EngineRetired",
    "StreamExpired",
]


class ServingError(RuntimeError):
    """Base class for every structured serving failure."""


class ServerOverloaded(ServingError):
    """Admission control rejected the request: the model's bounded queue
    is full. Rejecting immediately keeps latency bounded for the
    requests already admitted — the alternative (unbounded queueing)
    turns overload into unbounded latency for everyone."""


class DeadlineExceeded(ServingError):
    """The request's deadline lapsed before a response could be
    produced (either while queued or by the time its batch finished)."""


class ModelNotFound(ServingError):
    """No model (or no live version) is registered under that name."""


class RequestTooLarge(ServingError):
    """A single request carries more rows than the model's largest
    batch bucket — it can never be scheduled; shard it client-side."""


class StreamExpired(ServingError):
    """A streaming-generate continuation named a stream id the server
    no longer holds: it was closed, its idle TTL lapsed (the abandoned-
    stream sweep canceled the sequence), or the server restarted. The
    caller restarts the stream — against a fleet, the router does this
    automatically, resuming from the last delivered offset."""


class EngineRetired(ServingError):
    """Internal hand-off signal: the engine stopped accepting work
    because a hot-swap retired it. The server catches this and resubmits
    to the registry's CURRENT engine, so a swap never fails a request —
    it should not normally escape to clients."""
