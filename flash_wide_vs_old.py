"""Time the float32 flash kernels above head_dim 128 (the CUDA-core
kernels of csrc/flash_wide.cuh: K2, K3a and K3b) beside an earlier
revision of csrc/flash_attention.cu on one NVIDIA card.

    git show REV:paddle_tpu_torch/csrc/flash_attention.cu > _tree/old_flash.cu
    python3 flash_wide_vs_old.py _tree/old_flash.cu

The earlier source is built with nvcc (the flags of kernels/_build.py,
and -I paddle_tpu_torch/csrc for the shared headers) into the gitignored
_tree/ and called through the float32 C interface both revisions have
(flash_fwd_f32, flash_bwd_dkdv_f32, flash_bwd_dq_f32). At [BH=32, S=512,
D] full, D = 256 (one 256-column chunk), 264 and 512 (256-column
slices), each kernel of both revisions runs on the same seeded inputs
(outputs compared bitwise) and is timed in turns (old, new, new, old;
chip_smoke._time_ms: the median of 25 launches, the L2 flushed and the
queue kept busy before each). Prints one JSON line per kernel and shape
and the card's nvidia-smi line.
"""
import ctypes
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

BH, S = 32, 512


def load_old(src):
    from paddle_tpu_torch.kernels import _build

    out_dir = os.path.join(REPO, "_tree")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "libold_flash.so")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                        _build.CSRC, "-o", lib_path, src],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(lib_path)
    sigs = _build._SIGNATURES["flash_attention"]
    for fn in ("flash_fwd_f32", "flash_bwd_dkdv_f32", "flash_bwd_dq_f32"):
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = sigs[fn]
    return lib


def main(argv):
    import torch

    import chip_smoke
    from paddle_tpu_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("flash_wide_vs_old.py needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    old, new = load_old(argv[1]), _build.load_library("flash_attention")
    flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(0)
    for d in (256, 264, 512):
        q, k, v, do = (torch.randn(BH, S, d, device="cuda", generator=gen)
                       for _ in range(4))
        delta = torch.randn(BH, S, device="cuda", generator=gen)
        outs = {lib: (torch.empty_like(q), torch.empty(BH, S, device="cuda"),
                      torch.empty_like(q), torch.empty_like(k),
                      torch.empty_like(v)) for lib in (old, new)}
        scale = d ** -0.5
        p = [t.data_ptr() for t in (q, k, v, do, delta)]

        def fwd(lib):
            o, lse = outs[lib][:2]
            return lib.flash_fwd_f32(p[0], p[1], p[2], o.data_ptr(),
                                     lse.data_ptr(), BH, S, S, d, 0, scale,
                                     stream)

        def dkdv(lib):
            _, lse, _, dk, dv = outs[lib]
            return lib.flash_bwd_dkdv_f32(p[0], p[1], p[2], p[3],
                                          lse.data_ptr(), p[4],
                                          dk.data_ptr(), dv.data_ptr(), BH,
                                          S, S, d, 0, scale, stream)

        def dq(lib):
            _, lse, dqt, _, _ = outs[lib]
            return lib.flash_bwd_dq_f32(p[0], p[1], p[2], p[3],
                                        lse.data_ptr(), p[4], dqt.data_ptr(),
                                        BH, S, S, d, 0, scale, stream)

        # each kernel with the indices of its outputs in outs[lib]
        for name, call, written in (("flash_fwd_f32", fwd, (0, 1)),
                                    ("flash_bwd_dkdv_f32", dkdv, (3, 4)),
                                    ("flash_bwd_dq_f32", dq, (2,))):
            if call(old) or call(new):
                raise RuntimeError(f"{name} D={d}: launch failed")
            torch.cuda.synchronize()
            times = {"old": [], "new": []}
            for who in ("old", "new", "new", "old"):
                lib = old if who == "old" else new
                times[who].append(chip_smoke._time_ms(
                    torch, lambda: call(lib), flush))
            same = all(torch.equal(outs[old][i], outs[new][i])
                       for i in written)
            print(json.dumps({
                "kernel": name, "shape": f"[BH={BH}, S={S}, D={d}] f32 full",
                "old_ms": statistics.mean(times["old"]),
                "new_ms": statistics.mean(times["new"]),
                "outputs_bitwise_equal": same, "turns_ms": times}),
                flush=True)
    print(chip_smoke.smi_line(), flush=True)


if __name__ == "__main__":
    main(sys.argv)
