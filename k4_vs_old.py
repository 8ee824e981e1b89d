"""Time the paged-attention kernel (K4) beside an earlier revision of it
on one NVIDIA card, and read the device time of its two kernels.

    git show REV:paddle_tpu_torch/csrc/paged_attention.cu > _tree/old_k4.cu
    python3 k4_vs_old.py _tree/old_k4.cu

The earlier source is built with nvcc (the flags of kernels/_build.py)
into the gitignored _tree/ and called through its C interface, the one
K4 had before split-K: paged_attention_f32(q, k_pages, v_pages, tables,
kv_lens, q_lens, out, B, C, Hq, Hkv, D, page_size, W, scale, stream).
At chip_smoke.py's timing shapes (decode B=8, the one-slot request B=1,
GQA decode, a C=64 prefill chunk; head_dim 64, page 16, table width 64)
both are held to each other (max abs difference printed) and timed in
turns (old, new, new, old; chip_smoke._time_ms: the median of 25
launches, the L2 flushed and the queue kept busy before each). Then 20
calls of the current wrapper run under torch.profiler: the mean device
microseconds of its split kernel and of its merge kernel. Prints one
JSON line per shape and the card's nvidia-smi line.
"""
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


def load_old(src):
    from paddle_tpu_torch.kernels import _build

    out_dir = os.path.join(REPO, "_tree")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "libold_k4.so")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib_path,
                        src], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(lib_path)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_attention_f32.argtypes = [P] * 7 + [I] * 7 + [F, P]
    lib.paged_attention_f32.restype = I
    return lib


def kernel_us(torch, fn, flush, n=20):
    """{kernel name: mean device us a call} of the paged kernels."""
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush.zero_()
            torch.cuda._sleep(cs.QUEUE_SLEEP_CYCLES)
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        for name in ("paged_split_kernel", "paged_merge_kernel"):
            if name in ev.key:
                us = getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0.0))
                out[name] = out.get(name, 0.0) + us / n
    return out


def main(old_src):
    import numpy as np
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.kernels import paged_attention as pa

    cs.device_phase(torch)
    old = load_old(old_src)
    rng = np.random.RandomState(2024)
    base = dict(D=64, ps=16, W=64, P=513)
    lens = [int(x) for x in rng.randint(512, 1025, size=8)]
    shapes = {
        "decode": dict(base, B=8, C=None, Hq=16, Hkv=16, kv_lens=lens,
                       q_lens=None),
        "decode_b1": dict(base, B=1, C=None, Hq=16, Hkv=16,
                          kv_lens=[1024], q_lens=None),
        "decode_gqa4": dict(base, B=8, C=None, Hq=16, Hkv=4, kv_lens=lens,
                            q_lens=None),
        "prefill": dict(base, B=8, C=64, Hq=16, Hkv=16, kv_lens=lens,
                        q_lens=[64] * 8),
    }
    flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")
    for name, case in shapes.items():
        args = cs._paged_case(torch, rng, **case)
        q, kp, vp, tables, kv, ql = args
        q4 = q[:, None] if q.ndim == 3 else q
        ql4 = kv.clamp(0, 1) if ql is None else ql
        out = torch.empty_like(q4)
        B, C, Hq, D = q4.shape

        def old_call():
            err = old.paged_attention_f32(
                q4.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                tables.data_ptr(), kv.data_ptr(), ql4.data_ptr(),
                out.data_ptr(), B, C, Hq, case["Hkv"], D, case["ps"],
                case["W"], D ** -0.5,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"old kernel: CUDA error {err}")

        def new_call():
            return pa.paged_attention(*args[:5], q_lens=args[5])

        old_call()
        diff = (new_call().reshape(out.shape) - out).abs().max().item()
        old_ms, new_ms, turns = cs._in_turns(torch, old_call, new_call,
                                             flush)
        row = {"shape": name, "kv_lens": case["kv_lens"], "old_ms": old_ms,
               "new_ms": new_ms, "old_over_new": old_ms / new_ms,
               "turns_ms": {"old": turns[0], "new": turns[1]},
               "max_abs_diff": diff,
               "new_kernels_device_us": kernel_us(torch, new_call, flush)}
        print(json.dumps(row), flush=True)
    print(cs.smi_line(), flush=True)


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    main(sys.argv[1])
