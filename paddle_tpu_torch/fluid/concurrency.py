"""CSP concurrency facade: Go / Channel / Select — the counterpart of
``paddle_tpu/fluid/concurrency.py``.

Capability parity with the reference's concurrency layer
(python/paddle/fluid/concurrency.py; ops go_op.cc, select_op.cc,
channel_{create,send,recv,close}_op.cc over framework/channel.h). The
reference runs CSP *inside* the graph (channels are Variables, go_op
spawns an Executor thread). The port's Executor runs a program eagerly
from the host, so, as in the JAX package, pipelines of blocks live on the
HOST: Go spawns a Python thread (typically driving its own Executor.run
loop), channels are the port's native C++ ByteChannel
(``csrc/host/channel.cc`` through ``native.channel``), and Select polls
them. Same Go-style programming model, host-side control plane.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple

from ..native.channel import Channel, ChannelClosed

__all__ = ["Go", "make_channel", "channel_send", "channel_recv",
           "channel_close", "Select", "ChannelClosed"]


def make_channel(dtype=None, capacity: int = 0) -> Channel:
    """A typed-in-spirit channel (dtype is documentation; payloads are any
    picklable object). capacity=0 — unbuffered rendezvous, like the
    reference's default (channel.h)."""
    return Channel(capacity)


def channel_send(ch: Channel, value) -> bool:
    return ch.send(value)


def channel_recv(ch: Channel):
    """Returns (value, ok) — ok False when the channel is closed+drained
    (mirrors the reference's Receive returning success)."""
    try:
        return ch.recv(), True
    except ChannelClosed:
        return None, False


def channel_close(ch: Channel):
    ch.close()


class Go:
    """Run a block concurrently (reference go_op spawns the sub-block in a
    thread, go_op.cc). Use as a decorator or context manager:

        with Go() as g:
            g.spawn(producer, ch)
        ...
        g.join()
    """

    def __init__(self):
        self._threads: List[threading.Thread] = []

    def spawn(self, fn: Callable, *args, **kwargs) -> threading.Thread:
        # scope guards are per-thread (executor.py _scope_tls), so inherit
        # the SPAWNER's current scope explicitly — a goroutine driving its
        # own Executor.run loop keeps resolving the scope its creator was in
        from .executor import global_scope, scope_guard

        spawner_scope = global_scope()

        def run():
            with scope_guard(spawner_scope):
                fn(*args, **kwargs)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        self._threads.append(t)
        return t

    def __call__(self, fn: Callable) -> Callable:
        def wrapper(*args, **kwargs):
            return self.spawn(fn, *args, **kwargs)

        return wrapper

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def join(self, timeout: Optional[float] = None):
        for t in self._threads:
            t.join(timeout)


class Select:
    """Wait on several channels (reference select_op.cc). Cases are
    (channel, 'recv') or (channel, 'send', value); run() blocks until one
    fires and returns (index, value_or_None). Polling implementation — the
    host control plane is not the hot path."""

    def __init__(self, cases: Sequence[Tuple]):
        self.cases = list(cases)

    def run(self, poll_interval: float = 0.002) -> Tuple[int, Any]:
        import random
        import time

        order = list(range(len(self.cases)))
        while True:
            random.shuffle(order)  # Go-style fairness among ready cases
            for i in order:
                case = self.cases[i]
                ch, kind = case[0], case[1]
                if kind == "recv":
                    status, value = ch.try_recv()
                    if status == "ok":
                        return i, value
                    if status == "closed":
                        return i, None  # closed recv fires with None (Go nil)
                elif kind == "send":
                    status = ch.try_send(case[2])
                    if status in ("sent", "closed"):
                        return i, None
                else:
                    raise ValueError(f"unknown select case kind '{kind}'")
            time.sleep(poll_interval)
