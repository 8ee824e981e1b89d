"""CSP channel of Python objects over the port's native ByteChannel
(``csrc/host/channel.cc``; reference ``framework/channel.h`` +
``channel_impl.h``), the counterpart of ``paddle_tpu/native/channel.py``.
Payloads are pickled; capacity 0 is a rendezvous like the reference's
unbuffered channel. There is no pure-Python channel: the host library
builds or the constructor raises (``native.load_native``)."""
from __future__ import annotations

import contextlib
import ctypes
import pickle
import threading
from typing import Optional

from . import load_native

__all__ = ["Channel", "ChannelClosed"]


class ChannelClosed(Exception):
    pass


class _Destroyed(Exception):
    """The handle is already freed (or being freed)."""


class Channel:
    """Blocking send/recv of arbitrary picklable objects.

    send(obj) -> bool (False if closed); recv() -> obj or raises
    ChannelClosed when closed and drained.

    Lifecycle: the native ByteChannel is freed by destroy() (also via the
    context-manager exit). Destruction is deferred while any thread is
    inside a native call on the handle — close() only wakes blocked
    waiters, it does not wait for them to leave the object, so freeing
    immediately would be a use-after-free under their feet. The last
    in-flight call performs the deferred free.
    """

    def __init__(self, capacity: int = 0):
        self._lib = load_native()
        self._mu = threading.Lock()
        self._inflight = 0  # guarded-by: _mu
        self._destroy_pending = False  # guarded-by: _mu
        self._h: Optional[int] = self._lib.pt_chan_create(capacity)

    @contextlib.contextmanager
    def _native_call(self):
        """Guards a native call: holds the handle alive until it returns."""
        with self._mu:
            if self._h is None or self._destroy_pending:
                raise _Destroyed()
            self._inflight += 1
            h = self._h
        try:
            yield h
        finally:
            with self._mu:
                self._inflight -= 1
                if (self._destroy_pending and self._inflight == 0
                        and self._h is not None):
                    self._lib.pt_chan_destroy(self._h)
                    self._h = None

    def _take(self, out, n):
        """Unpickle the ``n`` bytes the library malloc'd at ``out`` and
        free them."""
        try:
            return pickle.loads(ctypes.string_at(out, n))
        finally:
            self._lib.pt_buf_free(out)

    def send(self, obj) -> bool:
        data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        try:
            with self._native_call() as h:
                return self._lib.pt_chan_send(h, data, len(data)) == 0
        except _Destroyed:
            return False  # destroyed == closed for the send contract

    def recv(self):
        out = ctypes.POINTER(ctypes.c_char)()
        try:
            with self._native_call() as h:
                n = self._lib.pt_chan_recv(h, ctypes.byref(out))
                if n < 0:
                    raise ChannelClosed()
                return self._take(out, n)
        except _Destroyed:
            raise ChannelClosed() from None

    def try_send(self, obj) -> str:
        """'sent' | 'full' | 'closed' — non-blocking (Select cases)."""
        data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
        try:
            with self._native_call() as h:
                rc = self._lib.pt_chan_try_send(h, data, len(data))
        except _Destroyed:
            return "closed"
        return "sent" if rc == 1 else ("full" if rc == 0 else "closed")

    def try_recv(self):
        """(status, value): 'ok' | 'empty' | 'closed' — non-blocking."""
        out = ctypes.POINTER(ctypes.c_char)()
        try:
            with self._native_call() as h:
                n = self._lib.pt_chan_try_recv(h, ctypes.byref(out))
                if n == -2:
                    return "empty", None
                if n == -1:
                    return "closed", None
                return "ok", self._take(out, n)
        except _Destroyed:
            return "closed", None

    def close(self):
        # through the in-flight guard: close must not race a concurrent
        # destroy() freeing the handle under us
        try:
            with self._native_call() as h:
                self._lib.pt_chan_close(h)
        except _Destroyed:
            pass  # already freed (or being freed) -> closed by definition

    def destroy(self):
        """Close and free the native channel. Safe while other threads are
        blocked in send/recv: they are woken by the close and the last one
        out frees the handle."""
        self.close()
        with self._mu:
            if self._h is None:
                return
            if self._inflight == 0:
                self._lib.pt_chan_destroy(self._h)
                self._h = None
            else:
                self._destroy_pending = True

    def size(self) -> int:
        try:
            with self._native_call() as h:
                return int(self._lib.pt_chan_size(h))
        except _Destroyed:
            return 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.destroy()
        return False

    def __iter__(self):
        while True:
            try:
                yield self.recv()
            except ChannelClosed:
                return

    def __del__(self):
        try:
            self.destroy()
        except Exception:
            pass
