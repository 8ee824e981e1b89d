"""Time tilings of the fused conv + folded-BN + relu kernel (K5) on one
NVIDIA card, beside F.conv2d (cuDNN, TF32 off) + the same epilogue.

    python3 k5_tiles.py                      # the variants below
    python3 k5_tiles.py NAME=kBM:128,kMinBlocks:1 ...

Each variant is paddle_tpu_torch/csrc/conv_bn_relu.cu with some of its
`constexpr int` tiling constants replaced (kBM, kBF, kWarpsM, kWarpsF,
kGroups, kStages, kMinBlocks), built with nvcc into the gitignored
_tree/k5_tiles/ and loaded with ctypes. On each of the 20 shapes of a
batch-16 ResNet-50 forward every variant is held against the plain
version (within 1e-4 of the output's max) and against the variants with
the same kGroups (bitwise: the k order is the same), then the variants
and the library call are timed in turns (forward order, then reversed;
median of 15 launches each, L2 flushed before each). Prints each
variant's ptxas line, one JSON line per shape and the sums over the
forward's 53 convs.
"""
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# the source's own constants first; warp tiles of 64 x 32 need ~240
# registers a thread, hence kMinBlocks 1, and at most 256 threads a block
VARIANTS = {
    "source": {},
    "128x64": {"kBM": 128, "kMinBlocks": 1},
    "128x64_8warps": {"kBM": 128, "kWarpsM": 4},
    "128x128_1group": {"kBM": 128, "kBF": 128, "kWarpsF": 4, "kGroups": 1,
                       "kMinBlocks": 1},
    "1group_3stages": {"kGroups": 1, "kStages": 3},
    "2groups_3stages": {"kStages": 3},
    "4groups": {"kGroups": 4},
}


def parse(args):
    out = {}
    for a in args:
        name, _, spec = a.partition("=")
        out[name] = {k: int(v) for k, v in
                     (kv.split(":") for kv in spec.split(",") if kv)}
    return out


def build(variants):
    """{name: (ctypes library, kGroups)}; every nvcc runs at once."""
    import chip_smoke
    from paddle_tpu_torch.kernels import _build

    src = open(os.path.join(_build.CSRC, "conv_bn_relu.cu")).read()
    out_dir = os.path.join(REPO, "_tree", "k5_tiles")
    os.makedirs(out_dir, exist_ok=True)
    procs, groups = {}, {}
    for name, consts in variants.items():
        text = src
        for const, value in consts.items():
            text, n = re.subn(rf"constexpr int {const} = [^;]+;",
                              f"constexpr int {const} = {value};", text)
            if n != 1:
                raise ValueError(f"{const}: {n} declarations in the source")
        groups[name] = int(re.search(r"constexpr int kGroups = (\d+);",
                                     text).group(1))
        path = os.path.join(out_dir, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o",
               os.path.join(out_dir, f"lib{name}.so"), path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    argtypes, restype = _build._SIGNATURES["conv_bn_relu"][
        "conv_bn_relu_f32"]
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        print(name, variants[name], json.dumps(chip_smoke.ptxas_table(log)),
              flush=True)
        lib = ctypes.CDLL(os.path.join(out_dir, f"lib{name}.so"))
        lib.conv_bn_relu_f32.argtypes = argtypes
        lib.conv_bn_relu_f32.restype = restype
        libs[name] = (lib, groups[name])
    return libs


def main():
    import numpy as np
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.kernels import conv_bn_relu as k5

    cs.device_phase(torch)
    variants = parse(sys.argv[1:]) or VARIANTS
    libs = build(variants)

    def call(lib, x, w, sc, sh, s, p, relu):
        n, c, h, wd = x.shape
        f, _, kh, kw = w.shape
        oh, ow = k5.conv_out_hw(h, wd, kh, kw, s, p)
        y = torch.empty((n, f, oh, ow), device="cuda")
        err = lib.conv_bn_relu_f32(
            x.data_ptr(), w.data_ptr(), sc.data_ptr(), sh.data_ptr(),
            y.data_ptr(), n, c, h, wd, f, kh, kw, s, p, oh, ow, int(relu),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return y

    rng = np.random.RandomState(5)
    main_prog = cs.build_resnet50(seed=1)[0]
    census = cs.conv_census(main_prog, cs.INFER_BATCH)
    flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")
    sums = dict.fromkeys(list(libs) + ["library", "bound"], 0.0)
    for shape, count in census.items():
        args = cs._conv_case(torch, rng, *shape)
        want = k5.fused_conv_bn_relu_reference(*args)
        outs = {n: call(lib, *args) for n, (lib, _) in libs.items()}
        for n, y in outs.items():
            rel = ((y - want).abs().max() / want.abs().max()).item()
            if not rel <= cs.TOL:
                raise RuntimeError(f"{n} at {shape}: {rel:.3g} of max")
            first = next(m for m, (_, g) in libs.items()
                         if g == libs[n][1])
            if not torch.equal(y, outs[first]):
                raise RuntimeError(f"{n} at {shape} differs from {first}, "
                                   f"which sums in the same order")
        calls = {n: (lambda lib=lib: call(lib, *args))
                 for n, (lib, _) in libs.items()}
        calls["library"] = cs._conv_library(torch, *args)
        times = {n: [] for n in calls}
        for n in list(calls) + list(calls)[::-1]:
            times[n].append(cs._time_ms(torch, calls[n], flush, n=15))
        row = {n: statistics.mean(v) for n, v in times.items()}
        row["bound"] = cs._conv_bounds(*shape)["bound_ms"]
        for n in sums:
            sums[n] += count * row[n]
        print(json.dumps({"shape": list(shape), "count": count, **row}),
              flush=True)
    print("sums over the forward (ms): " + json.dumps(sums))
    print(cs.smi_line())


if __name__ == "__main__":
    main()
