"""The port's native host layer: the pure-Python recordio writer and
reader (``recordio.py``, byte-compatible with the JAX package's
``paddle_tpu/native/recordio.py``), and a C++ host library of its own
loaded with ctypes: the CSP byte channel (``csrc/host/channel.cc``,
``channel.h``; reference ``framework/channel.h``) under
``native.channel.Channel``, and the buddy allocator over a host arena
(``csrc/host/buddy_allocator.cc``; reference
``memory/detail/buddy_allocator.h:33``) under
``native.memory.BuddyAllocator``.

The library builds at first use with ``g++`` from the sources in the
checkout into ``paddle_tpu_torch/_build/`` (listed in ``.gitignore``);
its file name carries a digest of the sources, so an edited source never
loads a stale build. A failed build raises with the compiler's message:
there is no pure-Python fallback (the JAX package degrades silently to
one). Nothing builds at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["load_native", "HOST_SRC", "BUILD_DIR", "CXX_FLAGS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_SRC = os.path.join(_PKG, "csrc", "host")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared"]

_lock = threading.Lock()
_libs = {}  # library path -> CDLL; guarded-by: _lock

_P, _U64, _I64 = ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64
_BUF = ctypes.POINTER(ctypes.c_char)
# every C entry point of the library: name -> (argtypes, restype)
_SIGNATURES = {
    "pt_buddy_create": ([_U64, _U64, ctypes.c_int], _P),
    "pt_buddy_alloc": ([_P, _U64], _P),
    "pt_buddy_free": ([_P, _P], ctypes.c_int),
    "pt_buddy_used": ([_P], _U64),
    "pt_buddy_check": ([_P], _U64),
    "pt_buddy_quarantined": ([_P], _U64),
    "pt_buddy_total": ([_P], _U64),
    "pt_buddy_destroy": ([_P], None),
    "pt_chan_create": ([_I64], _P),
    "pt_chan_send": ([_P, ctypes.c_char_p, _U64], ctypes.c_int),
    "pt_chan_recv": ([_P, ctypes.POINTER(_BUF)], _I64),
    "pt_buf_free": ([_BUF], None),
    "pt_chan_try_send": ([_P, ctypes.c_char_p, _U64], ctypes.c_int),
    "pt_chan_try_recv": ([_P, ctypes.POINTER(_BUF)], _I64),
    "pt_chan_close": ([_P], None),
    "pt_chan_size": ([_P], _I64),
    "pt_chan_destroy": ([_P], None),
}


def _sources():
    return sorted(f for f in os.listdir(HOST_SRC)
                  if f.endswith((".cc", ".h")))


def _lib_path() -> str:
    """The library's path, named by a digest of every source and header
    in ``csrc/host/`` and of the compiler flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0")
    for fname in _sources():
        with open(os.path.join(HOST_SRC, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read() + b"\0")
    return os.path.join(BUILD_DIR,
                        f"libpaddle_tpu_torch_host-{h.hexdigest()[:16]}.so")


def _build(out: str):
    """Compile the host sources into ``out``; raise with the compiler's
    output when it fails."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the port's host library "
                           f"(channel, buddy allocator) builds from "
                           f"{HOST_SRC} with it")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    srcs = [os.path.join(HOST_SRC, f) for f in _sources()
            if f.endswith(".cc")]
    proc = subprocess.run([cxx, *CXX_FLAGS, *srcs, "-lpthread", "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed to build the host library from "
                           f"{HOST_SRC} (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or none


def load_native() -> ctypes.CDLL:
    """The loaded host library, built first when this checkout has none
    for its sources."""
    path = _lib_path()
    with _lock:
        lib = _libs.get(path)
        if lib is not None:
            return lib
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        for fn, (argtypes, restype) in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _libs[path] = lib
        return lib


from . import channel, memory, recordio  # noqa: E402,F401
from .channel import Channel, ChannelClosed  # noqa: E402,F401
from .memory import BuddyAllocator  # noqa: E402,F401
