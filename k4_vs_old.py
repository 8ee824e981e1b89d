"""Time the paged-attention kernel (K4) beside an earlier revision of it
on one NVIDIA card, hold the two to each other bit for bit, and read the
device time of the current one's kernels.

    mkdir -p _tree/old_k4
    for f in paged_attention.cu tf32x3.cuh; do
      git show REV:paddle_tpu_torch/csrc/$f > _tree/old_k4/$f; done
    python3 k4_vs_old.py _tree/old_k4

The earlier source (with the headers it includes, in one directory) is
built with nvcc (the flags of kernels/_build.py) into the gitignored
_tree/ and called through the split-K C interface, the current one:
paged_attention_f32 / paged_attention_bf16(q, k_pages, v_pages, tables,
kv_lens, q_lens, part_ml, part_acc, out, B, C, Hq, Hkv, D, page_size, W,
split, n_splits, q_bf16, scale, stream), with its own scratch and
OLD_SPLIT keys a split at every head_dim (the split rule before the wide
split length); the current source runs through the wrapper.

1. Bit for bit: at head_dim 1, 18, 64, 100, 129, 130, 256 (every bucket
   and copy width up to 256) and 520 (paged_wide_kernel, above the wide
   bodies), float32 and bf16 pages, decode and chunked, MHA and GQA, the
   two outputs are compared with torch.equal (max abs difference
   printed); float32 pages up to 256 must be equal.
2. Timed in turns (old, new, new, old; chip_smoke._time_ms: the median
   of 25 launches, the L2 flushed and the queue kept busy before each),
   each against the plain version: float32 pages at chip_smoke.py's
   timing shapes (decode B=8, B=1, GQA, a C=64 prefill chunk, the verify
   chunk; head_dim 64, page 16, table width 64), decode and a C=64 chunk
   at head_dim 264 and 512 (B=8, Hq=Hkv=4); bf16 pages at decode, prefill
   and verify (head_dim 64) and the four wide shapes. Then 20 calls of
   the wrapper under torch.profiler: the mean device microseconds of
   each of its kernels.
Prints one JSON line per row and the card's nvidia-smi line.
"""
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

OLD_SPLIT = 256  # the split length at every head_dim before the wide split
K4_KERNELS = ("paged_split_kernel", "wide_decode_kernel",
              "wide_chunk_kernel", "paged_wide_kernel", "paged_merge_kernel")


def build(src_dir):
    """The library built by nvcc from src_dir/paged_attention.cu (the
    flags of kernels/_build.py) into the gitignored _tree/."""
    from paddle_tpu_torch.kernels import _build

    os.makedirs(os.path.join(REPO, "_tree"), exist_ok=True)
    lib = os.path.join(REPO, "_tree", "libk4_old.so")
    proc = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
         os.path.join(src_dir, "paged_attention.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src_dir}:\n{proc.stdout}")
    L = ctypes.CDLL(lib)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for fn in (L.paged_attention_f32, L.paged_attention_bf16):
        fn.argtypes = [P] * 9 + [I] * 10 + [F, P]
        fn.restype = I
    return L


def old_caller(torch, lib, args):
    """A call of the old build's C entry on the case's tensors (its own
    output and scratch, OLD_SPLIT keys a split), returning the output in
    the wrapper's shape."""
    q, kp, vp, tables, kv, ql = args
    q4 = q[:, None] if q.ndim == 3 else q
    ql4 = kv.clamp(0, 1) if ql is None else ql
    B, C, Hq, D = q4.shape
    ps, Hkv, W = kp.shape[1], kp.shape[2], tables.shape[1]
    ns = -(-W * ps // OLD_SPLIT)
    rows = ns * B * C * Hq
    scratch = torch.empty(rows * (2 + D), dtype=torch.float32,
                          device=q.device)
    out = torch.empty_like(q4)
    fn = (lib.paged_attention_bf16 if kp.dtype == torch.bfloat16
          else lib.paged_attention_f32)

    def call():
        err = fn(q4.data_ptr(), kp.data_ptr(), vp.data_ptr(),
                 tables.data_ptr(), kv.data_ptr(), ql4.data_ptr(),
                 scratch.data_ptr(), scratch.data_ptr() + 8 * rows,
                 out.data_ptr(), B, C, Hq, Hkv, D, ps, W, OLD_SPLIT, ns,
                 int(q.dtype == torch.bfloat16), D ** -0.5,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return out[:, 0] if q.ndim == 3 else out
    return call


def kernel_us(torch, fn, flush, n=20):
    """{kernel name: mean device us a call} of K4's kernels."""
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
        for name in K4_KERNELS:
            if name in ev.key:
                us = getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0.0))
                out[name] = out.get(name, 0.0) + us / n
    return out


def _bf16_pages(args):
    args = list(args)
    args[1], args[2] = args[1].bfloat16(), args[2].bfloat16()
    return tuple(args)


def bitwise_sweep(torch, old, pa, cs, rng):
    """(f32 cases up to 256 equal, rows): every bucket and copy width up
    to 256, then 520 (from a stream of its own, so the timed shapes
    after keep their inputs)."""
    import numpy as np

    rows, f32_equal = [], True
    kv4 = [300, 40, 0, 1024]
    d520_rng = np.random.RandomState(2041)
    for d in (1, 18, 64, 100, 129, 130, 256, 520):
        for hq, hkv in ((8, 8), (8, 2)):
            for C, ql in ((None, None), (40, [40, 3, 0, 1])):
                case = dict(D=d, ps=16, W=64, P=300, B=4, C=C, Hq=hq,
                            Hkv=hkv, kv_lens=kv4, q_lens=ql)
                f32 = cs._paged_case(torch, d520_rng if d > 256 else rng,
                                     **case)
                for pages, args in (("f32", f32), ("bf16", _bf16_pages(f32))):
                    new = pa.paged_attention(*args[:5], q_lens=args[5])
                    ref = old_caller(torch, old, args)()
                    same = bool(torch.equal(new, ref))
                    if pages == "f32" and d <= 256:
                        f32_equal &= same
                    rows.append({"D": d, "Hq": hq, "Hkv": hkv, "C": C,
                                 "pages": pages, "bitwise": same,
                                 "max_abs_diff": (new - ref).abs().max()
                                 .item()})
    return f32_equal, rows


def main(old_dir):
    import numpy as np
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import paged_attention as pa

    cs.device_phase(torch)
    _build.build_all(["paged_attention"])
    old = build(old_dir)
    rng = np.random.RandomState(2024)
    f32_equal, sweep = bitwise_sweep(torch, old, pa, cs, rng)
    for row in sweep:
        print(json.dumps({"bitwise_sweep": row}), flush=True)
    low = [r for r in sweep if r["D"] <= 256]
    print(json.dumps({"f32_up_to_256_bitwise": f32_equal,
                      "bf16_up_to_256_bitwise": all(
                          r["bitwise"] for r in low
                          if r["pages"] == "bf16"),
                      "bf16_max_abs_diff": max(
                          r["max_abs_diff"] for r in low
                          if r["pages"] == "bf16"),
                      "d520_bitwise": {r["pages"] + f" Hkv={r['Hkv']} "
                                       f"C={r['C']}": r["bitwise"]
                                       for r in sweep if r["D"] == 520}}),
          flush=True)

    base = dict(D=64, ps=16, W=64, P=513)
    lens = [int(x) for x in rng.randint(512, 1025, size=8)]
    wide = dict(base, B=8, Hq=4, Hkv=4, kv_lens=lens)
    shapes = {
        "decode": dict(base, B=8, C=None, Hq=16, Hkv=16, kv_lens=lens,
                       q_lens=None),
        "decode_b1": dict(base, B=1, C=None, Hq=16, Hkv=16,
                          kv_lens=[1024], q_lens=None),
        "decode_gqa4": dict(base, B=8, C=None, Hq=16, Hkv=4, kv_lens=lens,
                            q_lens=None),
        "prefill": dict(base, B=8, C=64, Hq=16, Hkv=16, kv_lens=lens,
                        q_lens=[64] * 8),
        "verify": dict(base, B=8, C=5, Hq=16, Hkv=16, kv_lens=lens,
                       q_lens=[5] * 8),
        "decode_d264": dict(wide, D=264, C=None, q_lens=None),
        "decode_d512": dict(wide, D=512, C=None, q_lens=None),
        "prefill_d264": dict(wide, D=264, C=64, q_lens=[64] * 8),
        "prefill_d512": dict(wide, D=512, C=64, q_lens=[64] * 8),
    }
    bf16_shapes = ("decode", "prefill", "verify", "decode_d264",
                   "decode_d512", "prefill_d264", "prefill_d512")
    flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")
    for name, case in shapes.items():
        f32 = cs._paged_case(torch, rng, **case)
        for pages in ("f32", "bf16"):
            if pages == "bf16" and name not in bf16_shapes:
                continue
            args = f32 if pages == "f32" else _bf16_pages(f32)

            def new_call(args=args):
                return pa.paged_attention(*args[:5], q_lens=args[5])

            old_call = old_caller(torch, old, args)
            new, ref = new_call(), old_call()
            plain = pa.paged_attention_reference(*args[:5], q_lens=args[5])
            old_ms, new_ms, turns = cs._in_turns(torch, old_call, new_call,
                                                 flush)
            row = {"shape": name, "pages": pages,
                   "split_keys": pa.split_keys(case["D"]),
                   "kv_lens": case["kv_lens"], "old_ms": old_ms,
                   "new_ms": new_ms, "old_over_new": old_ms / new_ms,
                   "turns_ms": {"old": turns[0], "new": turns[1]},
                   "bitwise_old": bool(torch.equal(new, ref)),
                   "max_abs_diff_old": (new - ref).abs().max().item(),
                   "new_vs_plain": (new - plain).abs().max().item(),
                   "old_vs_plain": (ref - plain).abs().max().item(),
                   "new_kernels_device_us": kernel_us(torch, new_call,
                                                      flush)}
            print(json.dumps(row), flush=True)
    print(cs.smi_line(), flush=True)


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    main(sys.argv[1])
