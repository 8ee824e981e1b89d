"""Build and load the hand-written CUDA kernels.

Each ``paddle_tpu_torch/csrc/<name>.cu`` compiles with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``. The build happens at first use, from the sources in the
checkout, into ``paddle_tpu_torch/_build/`` (listed in ``.gitignore``);
the library's file name carries a digest of its source and of the
shared headers (``csrc/*.cuh``), so an edited kernel or header never
loads a stale build. Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional, Sequence

__all__ = ["load_library", "build_all", "kernel_sources", "CSRC", "BUILD_DIR"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# where the CUDA toolkit puts nvcc when it is not on PATH
NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_mu = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}  # guarded-by: _mu

# the C interface of every kernel library: name -> (argtypes, restype).
# Every pointer and the stream are c_void_p (a plain int would be cut to
# 32 bits); each function returns cudaGetLastError() after its launch.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "paged_attention": {
        # q, k_pages, v_pages, tables, kv_lens, q_lens, part_ml,
        # part_acc, out, B, C, Hq, Hkv, D, page_size, W, split, n_splits,
        # q_bf16, scale, stream (launches the split kernel and the merge
        # kernel); float32 pools, or bfloat16 ones
        "paged_attention_f32": ([_P] * 9 + [_I] * 10 + [_F, _P], _I),
        "paged_attention_bf16": ([_P] * 9 + [_I] * 10 + [_F, _P], _I),
        "error_string": ([_I], ctypes.c_char_p),
    },
    "layer_norm": {
        # x, scale, bias, y, mean, rstd, N, F, eps, stream
        "layer_norm_f32": ([_P] * 6 + [_I] * 2 + [_F, _P], _I),
        # the same with bfloat16 x, scale, bias and y
        "layer_norm_bf16": ([_P] * 6 + [_I] * 2 + [_F, _P], _I),
        "error_string": ([_I], ctypes.c_char_p),
    },
    "flash_attention": {
        # q, k, v, o, lse, BH, Sq, Sk, D, causal, scale, stream
        "flash_fwd_f32": ([_P] * 5 + [_I] * 5 + [_F, _P], _I),
        # q, k, v, dout, lse, delta, dk, dv, BH, Sq, Sk, D, causal,
        # scale, stream
        "flash_bwd_dkdv_f32": ([_P] * 8 + [_I] * 5 + [_F, _P], _I),
        # q, k, v, dout, lse, delta, dq, BH, Sq, Sk, D, causal, scale,
        # stream
        "flash_bwd_dq_f32": ([_P] * 7 + [_I] * 5 + [_F, _P], _I),
        # the same arguments with bfloat16 q, k, v, dout and outputs (lse
        # and delta float32)
        "flash_fwd_bf16": ([_P] * 5 + [_I] * 5 + [_F, _P], _I),
        "flash_bwd_dkdv_bf16": ([_P] * 8 + [_I] * 5 + [_F, _P], _I),
        "flash_bwd_dq_bf16": ([_P] * 7 + [_I] * 5 + [_F, _P], _I),
        # dout, o, delta, rows, D, bf16, stream (delta = rowsum(dO * O))
        "flash_delta": ([_P] * 3 + [_I] * 3 + [_P], _I),
        "error_string": ([_I], ctypes.c_char_p),
    },
    "conv_bn_relu": {
        # x, w, scale, shift, y, N, C, H, W, F, KH, KW, stride, pad, OH,
        # OW, relu, stream (float32 x, w, y; scale and shift float32)
        "conv_bn_relu_f32": ([_P] * 5 + [_I] * 12 + [_P], _I),
        # x, w, scale, shift, y, ws, N, C, H, W, F, KH, KW, stride, pad,
        # OH, OW, relu, body, splits, bn, stream: bfloat16 x, w and y;
        # the plan's body, splits and tile (kernels/conv_bn_relu.py:
        # _plan); ws the float32 split partials (null when splits == 1)
        "conv_bn_relu_bf16": ([_P] * 6 + [_I] * 15 + [_P], _I),
        # ws, scale, shift, y, M, F, OHW, splits, relu, stream
        "conv_split_combine_bf16": ([_P] * 4 + [_I] * 5 + [_P], _I),
        "error_string": ([_I], ctypes.c_char_p),
    },
}


def kernel_sources() -> List[str]:
    """Names of the kernel sources in ``csrc/`` (``<name>.cu``)."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or NVCC_FALLBACK
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
            "kernels of paddle_tpu_torch build on a machine with the CUDA "
            "toolkit; on the CPU the plain PyTorch versions run instead")
    return path


def _lib_path(name: str) -> str:
    """The library's path, named by a digest of its source and of every
    header in ``csrc/`` (a source includes them by relative path), so an
    edited header rebuilds every library."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu"] + headers:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read() + b"\0")
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for one source into a private temp file; returns
    (process, temp path, final path), or None when already built."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    with open(out + ".log", "w") as f:
        f.write(log)
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
    return log


def build_all(names: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Compile every kernel source not yet built, one ``nvcc`` process
    per source, all started together. Returns the wall seconds the whole
    build took, per source (0.0 for one already built)."""
    names = list(kernel_sources() if names is None else names)
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names}
    secs = {}
    for n in names:
        if started[n] is not None:
            _finish(n, started[n])
        secs[n] = time.perf_counter() - t0 if started[n] else 0.0
    return secs


def ptxas_report(name: str) -> str:
    """What ``-Xptxas -v`` said when the library was built (registers,
    shared memory, spills per kernel), or '' when it was built
    elsewhere."""
    path = _lib_path(name) + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    with _mu:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        started = _start(name)
        if started is not None:
            _finish(name, started)
        lib = ctypes.CDLL(_lib_path(name))
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _libs[name] = lib
        return lib


def launch(name: str, fn: str, device, *args) -> None:
    """Call the C entry point ``fn`` of library ``name`` with ``args``
    and the current stream of ``device``; raise if the launch failed
    (the entry point returns cudaGetLastError() after its launch)."""
    import torch

    lib = load_library(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err:
        raise RuntimeError(f"{fn} launch failed: CUDA error {err} "
                           f"({lib.error_string(err).decode()})")
