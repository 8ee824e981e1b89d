"""Hold the bfloat16 flash kernels (K2 flash_fwd_bf16, K3a
flash_bwd_dkdv_bf16, K3b flash_bwd_dq_bf16) against an earlier revision
of csrc/flash_attention_bf16.cuh on one NVIDIA card.

    mkdir -p _tree/old
    git archive REV paddle_tpu_torch/csrc | tar -x -C _tree/old
    python3 flash_bf16_bwd_vs_old.py \\
        _tree/old/paddle_tpu_torch/csrc/flash_attention_bf16.cuh

The earlier source is built with nvcc (the flags of kernels/_build.py,
-x cu) into the gitignored _tree/, with the headers that sit beside it
(its own revision's), and called through the C interface both revisions
have. Both revisions then:
  - run chip_smoke.py's bf16 kernels cases (BF16_FLASH_CASES, replayed
    from its seed), and each output is compared with the plain version:
    bf16 ulps of its max and the share of elements that differ (LSE: max
    abs error), and the two revisions' outputs with each other, bit for
    bit;
  - are timed in turns (old, new, new, old; chip_smoke._time_ms: the
    median of 25 launches, the L2 flushed and the queue kept busy before
    each) at chip_smoke.py's timed shapes (BF16_FLASH_TIMED, head_dim 64);
  - have the host time of one call of their C entry points read at
    [BH=1, S=64, D=64] (chip_smoke._host_us; the wgmma kernels encode
    their TMA descriptors there).
Prints one JSON line per case and per shape and kernel, the worst case
of each revision, and the card's nvidia-smi line.
"""
import ctypes
import json
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

FNS = ("flash_fwd_bf16", "flash_bwd_dkdv_bf16", "flash_bwd_dq_bf16")
OUTS = ("O", "dQ", "dK", "dV")


def load_old(src):
    from paddle_tpu_torch.kernels import _build

    out_dir = os.path.join(REPO, "_tree")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "libold_bf16.so")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                        os.path.dirname(os.path.abspath(src)), "-x", "cu",
                        "-o", lib_path, src], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(lib_path)
    sigs = _build._SIGNATURES["flash_attention"]
    for fn in FNS:
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = sigs[fn]
    return lib


def kernels(lib, c, stream):
    """({C entry name: call}, outputs) of one revision on case c."""
    import torch

    o, dq, dk, dv = (torch.empty_like(c[n]) for n in ("q", "q", "k", "v"))
    lse = torch.empty_like(c["lse"])
    bh, sq, d = c["q"].shape
    sk = c["k"].shape[1]
    p = [c[n].data_ptr() for n in ("q", "k", "v", "do", "lse", "delta")]
    causal, scale = int(c["causal"]), c["scale"]

    def check(fn, err):
        if err:
            raise RuntimeError(f"{fn} launch failed: CUDA error {err}")

    def fwd():
        check(FNS[0], lib.flash_fwd_bf16(*p[:3], o.data_ptr(),
                                         lse.data_ptr(), bh, sq, sk, d,
                                         causal, scale, stream))

    def dkdv():
        check(FNS[1], lib.flash_bwd_dkdv_bf16(*p, dk.data_ptr(),
                                              dv.data_ptr(), bh, sq, sk, d,
                                              causal, scale, stream))

    def dqf():
        check(FNS[2], lib.flash_bwd_dq_bf16(*p, dq.data_ptr(), bh, sq, sk,
                                            d, causal, scale, stream))
    return (dict(zip(FNS, (fwd, dkdv, dqf))),
            {"O": o, "LSE": lse, "dQ": dq, "dK": dk, "dV": dv})


def main(argv):
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("flash_bf16_bwd_vs_old.py needs an NVIDIA card")
    import numpy as np

    libs = {"old": load_old(argv[1]),
            "new": _build.load_library("flash_attention")}
    stream = torch.cuda.current_stream().cuda_stream

    # accuracy at chip_smoke.py's bf16 cases, both revisions
    rng = np.random.RandomState(cs.BF16_FLASH_SEED)
    worst = {who: {n: [0.0, 0.0] for n in OUTS + ("LSE",)} for who in libs}
    all_equal = {n: True for n in OUTS + ("LSE",)}
    differ = {n: [0, 0, 0.0] for n in OUTS + ("LSE",)}
    for bh, sq, sk, d, causal in cs.BF16_FLASH_CASES:
        c = cs._flash_bf16_case(torch, rng, bh, sq, sk, d, causal)
        want = dict(zip(("dQ", "dK", "dV"), fa.flash_attention_bwd_reference(
            c["q"], c["k"], c["v"], c["do"], c["lse"], c["delta"], causal,
            c["scale"])))
        want["O"] = c["o"]
        row = {"case": [bh, sq, sk, d, causal]}
        outs = {}
        for who, lib in libs.items():
            calls, out = kernels(lib, c, stream)
            for fn in FNS:
                calls[fn]()
            torch.cuda.synchronize()
            outs[who] = out
            row[who] = {}
            for n in OUTS:
                _, ulps, share = cs._bf16_ulps(out[n], want[n])
                row[who][n] = [ulps, share]
                w = worst[who][n]
                w[0], w[1] = max(w[0], ulps), max(w[1], share)
            lse_err = (out["LSE"] - c["lse"]).abs().max().item()
            row[who]["LSE"] = lse_err
            worst[who]["LSE"][0] = max(worst[who]["LSE"][0], lse_err)
        # old against new, bit for bit: equal, or the count and the
        # largest difference of the elements that differ
        row["bitwise_equal"] = {}
        for n in OUTS + ("LSE",):
            a, b = outs["old"][n], outs["new"][n]
            eq = torch.equal(a, b)
            row["bitwise_equal"][n] = eq
            all_equal[n] = all_equal[n] and eq
            if not eq:
                ne = a != b
                differ[n][0] += int(ne.sum().item())
                differ[n][1] += a.numel()
                differ[n][2] = max(differ[n][2], (a.float() - b.float()).abs()
                                   .max().item())
        print(json.dumps(row), flush=True)
    print(json.dumps({
        "worst_ulps_share": worst, "all_bitwise_equal": all_equal,
        "old_vs_new_differing": {n: {"elements": v[0], "of": v[1],
                                     "max_abs_diff": v[2]}
                                 for n, v in differ.items() if v[0]}}),
          flush=True)

    # times in turns at the timed shapes
    flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")
    for bh, s, causal in cs.BF16_FLASH_TIMED:
        c = cs._flash_bf16_case(torch, rng, bh, s, s, 64, causal)
        calls = {who: kernels(lib, c, stream)[0] for who, lib in
                 libs.items()}
        bounds = cs._flash_bf16_bounds(bh, s, s, 64, causal)
        for fn in FNS:
            times = {"old": [], "new": []}
            for who in ("old", "new", "new", "old"):
                times[who].append(cs._time_ms(torch, calls[who][fn], flush))
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
        calls, _ = kernels(lib, c, stream)
        host[who] = {fn: cs._host_us(torch, calls[fn]) for fn in FNS}
    print(json.dumps({"host_us_of_the_c_entry": host,
                      "shape": "[BH=1, S=64, D=64]"}), flush=True)
    print(cs.smi_line(), flush=True)


if __name__ == "__main__":
    main(sys.argv)
