"""Time the float32 flash backward above head_dim 128 (K3a and K3b:
csrc/flash_bwd_wide_mma.cuh on the tensor cores up to 512) beside an
earlier revision of csrc/flash_attention.cu on one NVIDIA card, and hold
the kernels both revisions share bit for bit.

    git show REV:paddle_tpu_torch/csrc/flash_attention.cu > _tree/old_flash.cu
    python3 flash_wide_vs_old.py _tree/old_flash.cu

The earlier source is built with nvcc (the flags of kernels/_build.py,
and -I paddle_tpu_torch/csrc for the shared headers) into the gitignored
_tree/ and called through the C interface both revisions have. On the
same seeded inputs:

  - at [BH=32, S=512, D] full, D = 256, 264 and 512: K3a and K3b of each
    revision are held against the plain version (max abs error <= TOL);
    each kernel and the whole float32 backward (delta + K3a + K3b, as
    _Flash.backward runs it) are timed in turns (old, new, new, old;
    chip_smoke._time_ms: the median of 25 launches, the L2 flushed and
    the queue kept busy before each); K2 above 128 (flash_wide.cuh, not
    changed) is timed and held bitwise against the earlier revision;
  - the kernels the tensor-core backward left alone give the earlier
    revision's bits: float32 K2, K3a and K3b at head_dim 64 and 128, and
    the bfloat16 K2, K3a and K3b at head_dim 64, 256 and 264 (full and
    causal, Sq != Sk).

Prints one JSON line per kernel and shape and the card's nvidia-smi line;
exits 1 if a hold fails.
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
TIMED_DIMS = (256, 264, 512)
# (dtype, BH, Sq, Sk, head_dim, causal) held bitwise against the earlier
# revision: the kernels the tensor-core backward left alone
BITWISE = [("f32", 8, 200, 130, 64, True), ("f32", 8, 130, 200, 128, False),
           ("bf16", 8, 200, 130, 64, True), ("bf16", 8, 200, 130, 256, True),
           ("bf16", 4, 130, 200, 264, False)]
FNS = ("flash_fwd_f32", "flash_bwd_dkdv_f32", "flash_bwd_dq_f32",
       "flash_fwd_bf16", "flash_bwd_dkdv_bf16", "flash_bwd_dq_bf16",
       "flash_delta")


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
    for fn in FNS:
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = sigs[fn]
    return lib


class Calls:
    """The C entry points of one library on one case's tensors, each
    writing its own outputs."""

    def __init__(self, torch, lib, c, stream):
        self.lib, self.c, self.stream = lib, c, stream
        q, k = c["q"], c["k"]
        self.o, self.dq = torch.empty_like(q), torch.empty_like(q)
        self.dk, self.dv = torch.empty_like(k), torch.empty_like(k)
        self.lse = torch.empty(q.shape[:2], device=q.device)
        self.delta = torch.empty(q.shape[:2], device=q.device)
        self.suffix = "bf16" if q.dtype == torch.bfloat16 else "f32"
        self.dims = (q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                     int(c["causal"]))

    def _p(self, *names):
        return [self.c[n].data_ptr() for n in names]

    def fwd(self):
        return getattr(self.lib, f"flash_fwd_{self.suffix}")(
            *self._p("q", "k", "v"), self.o.data_ptr(), self.lse.data_ptr(),
            *self.dims, self.c["scale"], self.stream)

    def dkdv(self, delta=None):
        return getattr(self.lib, f"flash_bwd_dkdv_{self.suffix}")(
            *self._p("q", "k", "v", "do", "lse"),
            (delta if delta is not None else self.c["delta"]).data_ptr(),
            self.dk.data_ptr(), self.dv.data_ptr(), *self.dims,
            self.c["scale"], self.stream)

    def dq_(self, delta=None):
        return getattr(self.lib, f"flash_bwd_dq_{self.suffix}")(
            *self._p("q", "k", "v", "do", "lse"),
            (delta if delta is not None else self.c["delta"]).data_ptr(),
            self.dq.data_ptr(), *self.dims, self.c["scale"], self.stream)

    def whole_bwd(self):
        """delta = rowsum(dO * O), then K3a and K3b on it."""
        do = self.c["do"]
        e = self.lib.flash_delta(do.data_ptr(), self.c["o"].data_ptr(),
                                 self.delta.data_ptr(),
                                 do.numel() // do.shape[-1], do.shape[-1],
                                 int(self.suffix == "bf16"), self.stream)
        return e or self.dkdv(self.delta) or self.dq_(self.delta)


def main(argv):
    import numpy as np
    import torch

    import chip_smoke
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("flash_wide_vs_old.py needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    old, new = load_old(argv[1]), _build.load_library("flash_attention")
    flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.RandomState(0)
    failed = []

    def report(row, ok):
        row["ok"] = ok
        print(json.dumps(row), flush=True)
        if not ok:
            failed.append(row)

    for d in TIMED_DIMS:
        c = chip_smoke._flash_case(torch, rng, BH, S, S, d, False)
        calls = {"old": Calls(torch, old, c, stream),
                 "new": Calls(torch, new, c, stream)}
        plain = fa.flash_attention_bwd_reference(
            c["q"], c["k"], c["v"], c["do"], c["lse"], c["delta"], False,
            c["scale"])
        shape = f"[BH={BH}, S={S}, D={d}] f32 full"
        for name, fn in (("flash_fwd_f32", "fwd"),
                         ("flash_bwd_dkdv_f32", "dkdv"),
                         ("flash_bwd_dq_f32", "dq_"),
                         ("whole_backward_f32", "whole_bwd")):
            if any(getattr(calls[w], fn)() for w in calls):
                raise RuntimeError(f"{name} D={d}: launch failed")
            torch.cuda.synchronize()
            row = {"kernel": name, "shape": shape}
            if fn == "fwd":
                ok = all(torch.equal(getattr(calls["old"], a),
                                     getattr(calls["new"], a))
                         for a in ("o", "lse"))
                row["outputs_bitwise_equal"] = ok
            else:
                outs = {"dkdv": (("dk", 1), ("dv", 2)), "dq_": (("dq", 0),),
                        "whole_bwd": (("dq", 0), ("dk", 1), ("dv", 2))}[fn]
                errs = {w: max((getattr(calls[w], a) - plain[i]).abs().max()
                               .item() for a, i in outs) for w in calls}
                row["max_abs_err_vs_plain"] = errs
                ok = all(e <= chip_smoke.TOL for e in errs.values())
            times = {"old": [], "new": []}
            for who in ("old", "new", "new", "old"):
                times[who].append(chip_smoke._time_ms(
                    torch, getattr(calls[who], fn), flush))
            row.update(old_ms=statistics.mean(times["old"]),
                       new_ms=statistics.mean(times["new"]),
                       turns_ms=times)
            row["old_over_new"] = row["old_ms"] / row["new_ms"]
            report(row, ok)
        del c, calls, plain

    for dt, bh, sq, sk, d, causal in BITWISE:
        make = chip_smoke._flash_bf16_case if dt == "bf16" else \
            chip_smoke._flash_case
        c = make(torch, rng, bh, sq, sk, d, causal)
        calls = {"old": Calls(torch, old, c, stream),
                 "new": Calls(torch, new, c, stream)}
        for w in calls:
            if calls[w].fwd() or calls[w].dkdv() or calls[w].dq_():
                raise RuntimeError(f"{dt} D={d}: launch failed")
        torch.cuda.synchronize()
        same = {a: torch.equal(getattr(calls["old"], a),
                               getattr(calls["new"], a))
                for a in ("o", "lse", "dk", "dv", "dq")}
        report({"kernels": f"K2, K3a, K3b {dt}",
                "shape": f"[BH={bh}, Sq={sq}, Sk={sk}, D={d}] {dt} "
                         f"causal={causal}",
                "bitwise_equal_to_old": same}, all(same.values()))
    print(chip_smoke.smi_line(), flush=True)
    if failed:
        raise SystemExit(f"{len(failed)} holds failed")


if __name__ == "__main__":
    main(sys.argv)
