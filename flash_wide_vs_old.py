"""Time the flash kernels above head_dim 128 beside an earlier revision of
paddle_tpu_torch/csrc/ on one NVIDIA card, and hold the kernels both
revisions share bit for bit.

    mkdir -p _tree/old
    git archive REV paddle_tpu_torch/csrc | tar -x -C _tree/old
    python3 flash_wide_vs_old.py _tree/old/paddle_tpu_torch/csrc/flash_attention.cu

The earlier flash_attention.cu is built with nvcc (the flags of
kernels/_build.py) into the gitignored _tree/ beside its own revision's
headers (-I its directory: the whole earlier csrc/, never this one's) and
called through the C interface both revisions have. On the same seeded
inputs:

  - at [BH=32, S=512, D] full, D = 256, 264 and 512: the bfloat16 K3b
    (flash_bwd_dq_bf16) and the whole bfloat16 backward (delta + K3a +
    K3b, as _Flash.backward runs it), and the float32 K2 (flash_fwd_f32),
    of each revision are timed in turns (old, new, new, old;
    chip_smoke._time_ms: the median of 25 launches, the L2 flushed and the
    queue kept busy before each) and held against the plain version
    (bfloat16: within chip_smoke.BF16_FLASH_ULPS ulps of the tensor's max,
    at most chip_smoke.BF16_FLASH_SHARE of the elements differing;
    float32: O and LSE within chip_smoke.TOL);
  - the kernels this revision left alone give the earlier revision's
    bits: every float32 K3a and K3b (head_dim 64, 128, 256, 264, 512,
    520), the float32 K2 at 64, 128 and 520, the bfloat16 K2 and K3a at
    every head_dim, and the bfloat16 K3b at 64, 128 and 520 (full and
    causal, Sq != Sk).

Prints one JSON line per kernel and shape and the card's nvidia-smi line;
exits 1 if a hold fails.

    python3 flash_wide_vs_old.py --ablate

times this revision's kernels above head_dim 128 at [BH=32, S=512, D]
full, D = 256 and 512: the bfloat16 K2, K3a and K3b
(csrc/flash_wide_wgmma.cuh) and the float32 K2
(csrc/flash_fwd_wide_mma.cuh), beside copies of the headers built into
_tree/ablate/ with parts switched off (their outputs are not the
function; only their times are read): "no_mma" issues no tensor-core
product (no wgmma; in the float32 K2 no mma.sync, and the compiler drops
the fragment loads and splits that only fed it; the staged loads, waits,
softmax and ds arithmetic stay), "no_alu" skips the softmax, exp and ds
arithmetic (and the bfloat16 kernels' hand-offs of P and dS; the float32
K2 still hands its scores over), "loads_only" both. The switches are put
in by matching the headers' text, so an edit there that moves one makes
this mode fail, not time something else.
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
# (dtype, BH, Sq, Sk, head_dim, causal, outputs held bitwise against the
# earlier revision): the kernels this revision left alone (above 128 not
# the float32 K2 or the bfloat16 K3b up to 512)
ALL = ("o", "lse", "dk", "dv", "dq")
BWD_F32 = ("dk", "dv", "dq")
NOT_DQ = ("o", "lse", "dk", "dv")
BITWISE = [("f32", 8, 200, 130, 64, True, ALL),
           ("f32", 8, 130, 200, 128, False, ALL),
           ("f32", 2, 200, 130, 256, True, BWD_F32),
           ("f32", 2, 130, 200, 264, False, BWD_F32),
           ("f32", 1, 200, 130, 512, True, BWD_F32),
           ("f32", 1, 130, 200, 520, False, ALL),
           ("bf16", 8, 200, 130, 64, True, ALL),
           ("bf16", 8, 130, 200, 128, False, ALL),
           ("bf16", 2, 200, 130, 256, True, NOT_DQ),
           ("bf16", 2, 130, 200, 264, False, NOT_DQ),
           ("bf16", 1, 200, 130, 512, True, NOT_DQ),
           ("bf16", 1, 130, 200, 520, False, ALL),
           ("bf16", 1, 200, 130, 520, True, ALL)]
FNS = ("flash_fwd_f32", "flash_bwd_dkdv_f32", "flash_bwd_dq_f32",
       "flash_fwd_bf16", "flash_bwd_dkdv_bf16", "flash_bwd_dq_bf16",
       "flash_delta")


def load_old(src):
    from paddle_tpu_torch.kernels import _build

    out_dir = os.path.join(REPO, "_tree")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "libold_flash.so")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                        os.path.dirname(os.path.abspath(src)), "-o",
                        lib_path, src], capture_output=True, text=True)
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


# (the header's text, what replaces it) for each switch
_ABLATE_EDITS = [
    ("float p = exp2_ftz(sc[i] * c - rv[2 * j + e]);",
     "\n#ifdef ABL_NO_ALU\n            float p = sc[i];\n#else\n"
     "            float p = exp2_ftz(sc[i] * c - rv[2 * j + e]);\n#endif\n"),
    ("      if (it > 0) named_sync(kPEmpty, kWideThreads);",
     "#ifndef ABL_NO_ALU\n      if (it > 0) named_sync(kPEmpty, "
     "kWideThreads);"),
    ("      named_arrive(kPFull, kWideThreads);\n    } else {\n"
     "      named_sync(kPFull, kWideThreads);",
     "      named_arrive(kPFull, kWideThreads);\n#endif\n    } else {\n"
     "#ifndef ABL_NO_ALU\n      named_sync(kPFull, kWideThreads);"),
    ("      if (it + 1 < n_tiles) named_arrive(kPEmpty, kWideThreads);",
     "      if (it + 1 < n_tiles) named_arrive(kPEmpty, kWideThreads);"
     "\n#endif"),
    ("            sc[i] = pbuf[i * kThreads + tw] * (sc[i] - rv[2 * j + e]);",
     "#ifdef ABL_NO_ALU\n            sc[i] = sc[i] - rv[2 * j + e];\n#else"
     "\n            sc[i] = pbuf[i * kThreads + tw] * (sc[i] - "
     "rv[2 * j + e]);\n#endif"),
    ("    // masked scores become -inf", "#ifndef ABL_NO_ALU\n"
     "    // masked scores become -inf"),
    ("    uint32_t pa[kKeySteps][4];", "#else\n    float alpha[2] = {1.f, "
     "1.f};\n#endif\n    uint32_t pa[kKeySteps][4];"),
]
_ABLATE_DQ_EDITS = [
    ("    // P in place, zero where masked or padded, to warpgroup 1 through",
     "#ifndef ABL_NO_ALU\n"
     "    // P in place, zero where masked or padded, to warpgroup 1 through"),
    ("    uint32_t da[kTileSteps][4];",
     "#endif\n    uint32_t da[kTileSteps][4];"),
]
_ABLATE_F32_EDITS = [
    ("      if (!(t0 + kTile <= Sk && (!causal || t0 + kTile - 1 <= q0 + rw))) {",
     "#ifndef ABL_NO_ALU\n"
     "      if (!(t0 + kTile <= Sk && (!causal || t0 + kTile - 1 <= q0 + rw))) {"),
    ("      // P and alpha to the group-1 warp of these rows",
     "#else\n      alpha[0] = alpha[1] = 1.f;\n#endif\n"
     "      // P and alpha to the group-1 warp of these rows"),
]
_ABLATE_MMA = ("unit_scores(float (&d)[32]", "unit_scores128(float (&d)[64]",
               "products_into(float (&d)[32]")
_ABLATE_ENTRY = """#include "flash_fwd_wide_mma.cuh"
#include "flash_wide_wgmma.cuh"
extern "C" int ablate_fwd(const void* q, const void* k, const void* v,
                          void* o, void* lse, int BH, int Sq, int Sk, int D,
                          int causal, float scale, void* stream) {
  return flash_wgmma::launch_wide_fwd(
      q, k, v, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      BH, Sq, Sk, D, causal, scale, static_cast<cudaStream_t>(stream));
}
extern "C" int ablate_dkdv(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dk, void* dv, int BH,
                           int Sq, int Sk, int D, int causal, float scale,
                           void* stream) {
  return flash_wgmma::launch_wide_dkdv(
      q, k, v, dout, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), BH, Sq, Sk, D, causal, scale,
      static_cast<cudaStream_t>(stream));
}
extern "C" int ablate_dq(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dq, int BH, int Sq, int Sk, int D, int causal,
                         float scale, void* stream) {
  return flash_wgmma::launch_wide_dq(
      q, k, v, dout, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), BH,
      Sq, Sk, D, causal, scale, static_cast<cudaStream_t>(stream));
}
extern "C" int ablate_fwd_f32(const void* q, const void* k, const void* v,
                              void* o, void* lse, int BH, int Sq, int Sk,
                              int D, int causal, float scale, void* stream) {
  return flash_fwd_wide::launch_fwd(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), BH, Sq, Sk, D, causal, scale,
      static_cast<cudaStream_t>(stream));
}
"""
ABLATE_VARIANTS = {"full": [], "no_mma": ["-DABL_NO_MMA"],
                   "no_alu": ["-DABL_NO_ALU"],
                   "loads_only": ["-DABL_NO_MMA", "-DABL_NO_ALU"]}


def build_ablations():
    """The header with the switches put in, and one library a variant
    (built at once); {variant: ctypes library}."""
    import shutil

    from paddle_tpu_torch.kernels import _build

    out = os.path.join(REPO, "_tree", "ablate")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC, out)
    for header, edits, early in (
            ("flash_wide_wgmma.cuh", _ABLATE_EDITS + _ABLATE_DQ_EDITS,
             _ABLATE_MMA),
            ("flash_fwd_wide_mma.cuh", _ABLATE_F32_EDITS, ()),
            ("tf32x3.cuh", [], ("void mma3x4(",))):
        path = os.path.join(out, header)
        src = open(path).read()
        for old, new in edits:
            if src.count(old) != 1:
                raise SystemExit(f"--ablate: {header} no longer has {old!r}")
            src = src.replace(old, new)
        for fn in early:
            at = src.index("{", src.index(fn)) + 1
            src = src[:at] + "\n#ifdef ABL_NO_MMA\n  return;\n#endif\n" + \
                src[at:]
        open(path, "w").write(src)
    entry = os.path.join(out, "ablate.cu")
    open(entry, "w").write(_ABLATE_ENTRY)
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o",
         os.path.join(out, f"lib{name}.so"), entry],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, flags in ABLATE_VARIANTS.items()}
    libs = {}
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log}")
        lib = ctypes.CDLL(os.path.join(out, f"lib{name}.so"))
        lib.ablate_fwd.argtypes = [p] * 5 + [i] * 5 + [f, p]
        lib.ablate_dkdv.argtypes = [p] * 8 + [i] * 5 + [f, p]
        lib.ablate_dq.argtypes = [p] * 7 + [i] * 5 + [f, p]
        lib.ablate_fwd_f32.argtypes = [p] * 5 + [i] * 5 + [f, p]
        for fn in ("ablate_fwd", "ablate_dkdv", "ablate_dq",
                   "ablate_fwd_f32"):
            getattr(lib, fn).restype = i
        libs[name] = lib
    return libs


def ablate():
    import numpy as np
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        raise SystemExit("flash_wide_vs_old.py needs an NVIDIA card")
    libs = build_ablations()
    flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.RandomState(0)
    for d in (256, 512):
        c = chip_smoke._flash_bf16_case(torch, rng, BH, S, S, d, False)
        f = chip_smoke._flash_case(torch, rng, BH, S, S, d, False)
        o, dk, dv, dq = (torch.empty_like(c[n]) for n in ("q", "k", "k", "q"))
        o32 = torch.empty_like(f["q"])
        lse = torch.empty(c["q"].shape[:2], device="cuda")
        dims = (BH, S, S, d, 0, c["scale"], stream)
        row = {"shape": f"[BH={BH}, S={S}, D={d}] full"}
        for name, lib in libs.items():
            def ptrs(case, names):
                return [case[n].data_ptr() for n in names]
            calls = {
                "flash_fwd_bf16": lambda lib=lib: lib.ablate_fwd(
                    *ptrs(c, "qkv"), o.data_ptr(), lse.data_ptr(), *dims),
                "flash_bwd_dkdv_bf16": lambda lib=lib: lib.ablate_dkdv(
                    *ptrs(c, ("q", "k", "v", "do", "lse", "delta")),
                    dk.data_ptr(), dv.data_ptr(), *dims),
                "flash_bwd_dq_bf16": lambda lib=lib: lib.ablate_dq(
                    *ptrs(c, ("q", "k", "v", "do", "lse", "delta")),
                    dq.data_ptr(), *dims),
                "flash_fwd_f32": lambda lib=lib: lib.ablate_fwd_f32(
                    *ptrs(f, "qkv"), o32.data_ptr(), lse.data_ptr(), *dims)}
            if any(call() for call in calls.values()):
                raise RuntimeError(f"{name} D={d}: launch failed")
            torch.cuda.synchronize()
            row[name] = {f"{k}_ms": chip_smoke._time_ms(torch, call, flush)
                         for k, call in calls.items()}
        print(json.dumps(row), flush=True)
    print(chip_smoke.smi_line(), flush=True)


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

    def vs_plain(got, want):
        """(ulps of the max, share differing, within the holds)"""
        _, ulps, share = chip_smoke._bf16_ulps(got, want)
        return ulps, share, (ulps <= chip_smoke.BF16_FLASH_ULPS and
                             share <= chip_smoke.BF16_FLASH_SHARE)

    def vs_tol(got, want):
        """(max abs error, within chip_smoke.TOL)"""
        err = (got - want).abs().max().item()
        return err, err <= chip_smoke.TOL

    for d in TIMED_DIMS:
        cases = {"bf16": chip_smoke._flash_bf16_case(torch, rng, BH, S, S, d,
                                                     False),
                 "f32": chip_smoke._flash_case(torch, rng, BH, S, S, d,
                                               False)}
        for name, dt, fn in (("flash_bwd_dq_bf16", "bf16", "dq_"),
                             ("whole_backward_bf16", "bf16", "whole_bwd"),
                             ("flash_fwd_f32", "f32", "fwd")):
            c = cases[dt]
            calls = {"old": Calls(torch, old, c, stream),
                     "new": Calls(torch, new, c, stream)}
            if any(getattr(calls[w], fn)() for w in calls):
                raise RuntimeError(f"{name} D={d}: launch failed")
            torch.cuda.synchronize()
            if fn == "fwd":
                holds = {w: {"o": vs_tol(calls[w].o, c["o"]),
                             "lse": vs_tol(calls[w].lse, c["lse"])}
                         for w in calls}
                ok = all(h[1] for h in holds["new"].values())
            else:
                plain = fa.flash_attention_bwd_reference(
                    c["q"], c["k"], c["v"], c["do"], c["lse"], c["delta"],
                    False, c["scale"])
                outs = (("dq", plain[0]),) if fn == "dq_" else (
                    ("dq", plain[0]), ("dk", plain[1]), ("dv", plain[2]))
                holds = {w: {a: vs_plain(getattr(calls[w], a), want)
                             for a, want in outs} for w in calls}
                ok = all(h[2] for h in holds["new"].values())
            row = {"kernel": name, "shape": f"[BH={BH}, S={S}, D={d}] {dt} "
                                            f"full",
                   "vs_plain": holds}
            times = {"old": [], "new": []}
            for who in ("old", "new", "new", "old"):
                times[who].append(chip_smoke._time_ms(
                    torch, getattr(calls[who], fn), flush))
            row.update(old_ms=statistics.mean(times["old"]),
                       new_ms=statistics.mean(times["new"]),
                       turns_ms=times)
            row["old_over_new"] = row["old_ms"] / row["new_ms"]
            report(row, ok and row["new_ms"] < row["old_ms"])
            del calls
        del cases

    for dt, bh, sq, sk, d, causal, held in BITWISE:
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
                               getattr(calls["new"], a)) for a in held}
        report({"kernels": f"K2, K3a, K3b {dt}",
                "shape": f"[BH={bh}, Sq={sq}, Sk={sk}, D={d}] {dt} "
                         f"causal={causal}",
                "bitwise_equal_to_old": same}, all(same.values()))
    print(chip_smoke.smi_line(), flush=True)
    if failed:
        raise SystemExit(f"{len(failed)} holds failed")


if __name__ == "__main__":
    if sys.argv[1:] == ["--ablate"]:
        ablate()
    else:
        main(sys.argv)
