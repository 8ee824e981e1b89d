"""Time the bfloat16 flash backward kernels (K3a flash_bwd_dkdv_bf16 and
K3b flash_bwd_dq_bf16) beside an earlier revision of
csrc/flash_attention_bf16.cuh on one NVIDIA card.

    git show REV:paddle_tpu_torch/csrc/flash_attention_bf16.cuh > _tree/old_bf16.cuh
    python3 flash_bf16_bwd_vs_old.py _tree/old_bf16.cuh

The earlier source is built with nvcc (the flags of kernels/_build.py,
-x cu, and -I paddle_tpu_torch/csrc for the shared headers) into the
gitignored _tree/ and called through the C interface both revisions have.
Both revisions then:
  - run chip_smoke.py's bf16 kernels cases (BF16_FLASH_CASES, replayed
    from its seed), and each output is compared with the plain version:
    bf16 ulps of its max and the share of elements that differ, and the
    two revisions' outputs with each other, bit for bit;
  - are timed in turns (old, new, new, old; chip_smoke._time_ms: the
    median of 25 launches, the L2 flushed and the queue kept busy before
    each) at chip_smoke.py's timed shapes (BF16_FLASH_TIMED, head_dim 64);
  - have the host time of one call of their C entry point read at
    [BH=1, S=64, D=64] (chip_smoke._host_us; the new one encodes its TMA
    descriptors there).
Prints one JSON line per case and per shape, the worst case of each
revision, and the card's nvidia-smi line.
"""
import ctypes
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

FNS = ("flash_bwd_dkdv_bf16", "flash_bwd_dq_bf16")


def load_old(src):
    from paddle_tpu_torch.kernels import _build

    out_dir = os.path.join(REPO, "_tree")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "libold_bf16.so")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                        _build.CSRC, "-x", "cu", "-o", lib_path, src],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(lib_path)
    sigs = _build._SIGNATURES["flash_attention"]
    for fn in FNS:
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = sigs[fn]
    return lib


def kernels(lib, c, stream):
    """(dK/dV call, dQ call, outputs) of one revision on case c."""
    import torch

    dk, dv, dq = (torch.empty_like(c[n]) for n in ("k", "v", "q"))
    bh, sq, d = c["q"].shape
    sk = c["k"].shape[1]
    p = [c[n].data_ptr() for n in ("q", "k", "v", "do", "lse", "delta")]
    causal, scale = int(c["causal"]), c["scale"]

    def dkdv():
        if lib.flash_bwd_dkdv_bf16(*p, dk.data_ptr(), dv.data_ptr(), bh, sq,
                                   sk, d, causal, scale, stream):
            raise RuntimeError("flash_bwd_dkdv_bf16 launch failed")

    def dqf():
        if lib.flash_bwd_dq_bf16(*p, dq.data_ptr(), bh, sq, sk, d, causal,
                                 scale, stream):
            raise RuntimeError("flash_bwd_dq_bf16 launch failed")
    return dkdv, dqf, {"dQ": dq, "dK": dk, "dV": dv}


def main(argv):
    import numpy as np
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("flash_bf16_bwd_vs_old.py needs an NVIDIA card")
    libs = {"old": load_old(argv[1]),
            "new": _build.load_library("flash_attention")}
    stream = torch.cuda.current_stream().cuda_stream

    # accuracy at chip_smoke.py's bf16 cases, both revisions
    rng = np.random.RandomState(cs.BF16_FLASH_SEED)
    worst = {who: {n: [0.0, 0.0] for n in ("dQ", "dK", "dV")} for who in libs}
    all_equal = True
    for bh, sq, sk, d, causal in cs.BF16_FLASH_CASES:
        c = cs._flash_bf16_case(torch, rng, bh, sq, sk, d, causal)
        want = dict(zip(("dQ", "dK", "dV"), fa.flash_attention_bwd_reference(
            c["q"], c["k"], c["v"], c["do"], c["lse"], c["delta"], causal,
            c["scale"])))
        row = {"case": [bh, sq, sk, d, causal]}
        outs = {}
        for who, lib in libs.items():
            dkdv, dqf, out = outs[who] = kernels(lib, c, stream)
            dkdv()
            dqf()
            torch.cuda.synchronize()
            row[who] = {}
            for n, got in out.items():
                _, ulps, share = cs._bf16_ulps(got, want[n])
                row[who][n] = [ulps, share]
                w = worst[who][n]
                w[0], w[1] = max(w[0], ulps), max(w[1], share)
        row["bitwise_equal"] = all(torch.equal(outs["old"][2][n],
                                               outs["new"][2][n])
                                   for n in want)
        all_equal = all_equal and row["bitwise_equal"]
        print(json.dumps(row), flush=True)
    print(json.dumps({"worst_ulps_share": worst,
                      "all_bitwise_equal": all_equal}), flush=True)

    # times in turns at the timed shapes
    flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")
    for bh, s, causal in cs.BF16_FLASH_TIMED:
        c = cs._flash_bf16_case(torch, rng, bh, s, s, 64, causal)
        calls = {who: kernels(lib, c, stream)[:2] for who, lib in
                 libs.items()}
        bounds = cs._flash_bf16_bounds(bh, s, s, 64, causal)
        for i, fn in enumerate(FNS):
            times = {"old": [], "new": []}
            for who in ("old", "new", "new", "old"):
                times[who].append(cs._time_ms(torch, calls[who][i], flush))
            old, new = (statistics.mean(times[w]) for w in ("old", "new"))
            print(json.dumps({
                "kernel": fn, "shape": f"[BH={bh}, S={s}, D=64] bf16 "
                                       f"causal={causal}",
                "old_ms": old, "new_ms": new, "new_over_old": new / old,
                "bound_ms": bounds[fn]["bound_ms"],
                "share_of_bound_old": bounds[fn]["bound_ms"] / old,
                "share_of_bound_new": bounds[fn]["bound_ms"] / new,
                "turns_ms": times}), flush=True)
        del c, calls

    # the C entry points' host time a call
    c = cs._flash_bf16_case(torch, rng, 1, 64, 64, 64, False)
    host = {}
    for who, lib in libs.items():
        dkdv, dqf, _ = kernels(lib, c, stream)
        host[who] = {FNS[0]: cs._host_us(torch, dkdv),
                     FNS[1]: cs._host_us(torch, dqf)}
    print(json.dumps({"host_us_of_the_c_entry": host,
                      "shape": "[BH=1, S=64, D=64]"}), flush=True)
    print(cs.smi_line(), flush=True)


if __name__ == "__main__":
    main(sys.argv)
