"""Hold K5's bfloat16 form (conv_bn_relu_bf16, with its split-K combine)
against an earlier revision of csrc/conv_bn_relu.cu on one NVIDIA card.

    mkdir -p _tree/old
    git archive REV paddle_tpu_torch/csrc | tar -x -C _tree/old
    python3 k5_bf16_vs_old.py _tree/old/paddle_tpu_torch/csrc/conv_bn_relu.cu \\
        [--sweep]

The earlier source is built with nvcc (the flags of kernels/_build.py)
into the gitignored _tree/, with the headers that sit beside it (its own
revision's), and called through its C entry (the signature of the
revisions before the plan: no workspace, no plan arguments). This
revision runs through the wrapper, as the main path does (the plan, the
workspace, the combine). Both revisions then:
  - run the 20 convolutions of a batch-16 ResNet-50 forward on the
    inputs chip_smoke.py's amp kernels phase draws for them
    (chip_smoke.amp_census_cases, its seed): each output against the
    plain version in bf16 ulps of its max and the share of elements that
    differ, and the two revisions' outputs against each other (the share
    of outputs where they differ);
  - are timed in turns at those shapes (old, new, new, old;
    chip_smoke._time_ms: the median of 25 launches, the L2 flushed and
    the queue kept busy before each) and summed over the forward's 53
    convolutions;
  - have the host time of their C entries read at batch 1 and 8x8 images
    (chip_smoke._host_us), a 1x1 and a 3x3 whose plan splits K: this
    revision encodes a TMA map a call, and a split plan adds the combine's
    entry (and, in the wrapper, a workspace allocation).
With --sweep, each shape's other plans (tile, split, body) are timed in
turns with the default plan and held against the plain version too.
Prints one JSON line per shape, the sums, and the card's nvidia-smi line.
"""
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

FN = "conv_bn_relu_bf16"
# the earlier revisions' C entry: x, w, scale, shift, y, N, C, H, W, F,
# KH, KW, stride, pad, OH, OW, relu, stream
OLD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p]


def load_old(src):
    from paddle_tpu_torch.kernels import _build

    out_dir = os.path.join(REPO, "_tree")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "libold_k5.so")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                        os.path.dirname(os.path.abspath(src)), "-x", "cu",
                        "-o", lib_path, src], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(lib_path)
    getattr(lib, FN).argtypes = OLD_ARGTYPES
    getattr(lib, FN).restype = ctypes.c_int
    return lib


def old_call(lib, args, stream):
    """(call, y) of the earlier revision's kernel on _amp_conv_case args."""
    import torch

    from paddle_tpu_torch.kernels import conv_bn_relu as k5

    x, w, sc, sh, s, p, relu = args
    n, c, h, wd = x.shape
    f, _, kh, kw = w.shape
    oh, ow = k5.conv_out_hw(h, wd, kh, kw, s, p)
    y = torch.empty((n, f, oh, ow), dtype=torch.bfloat16, device=x.device)

    def call():
        err = getattr(lib, FN)(x.data_ptr(), w.data_ptr(), sc.data_ptr(),
                               sh.data_ptr(), y.data_ptr(), n, c, h, wd, f,
                               kh, kw, s, p, oh, ow, int(relu), stream)
        if err:
            raise RuntimeError(f"old {FN} launch failed: CUDA error {err}")
    return call, y


def plan_call(args, plan):
    """(call, y) of this revision on args under ``plan`` (the wrapper's
    launch with a given plan)."""
    import torch

    from paddle_tpu_torch.kernels import conv_bn_relu as k5

    x, w, sc, sh, s, p, relu = args
    n, _, h, wd = x.shape
    f, _, kh, kw = w.shape
    oh, ow = k5.conv_out_hw(h, wd, kh, kw, s, p)
    y = torch.empty((n, f, oh, ow), dtype=torch.bfloat16, device=x.device)
    return (lambda: k5._launch_bf16(x, w, sc, sh, y, plan, s, p,
                                    int(relu))), y


def other_plans(shape):
    """Plans to time beside the default one at a batch-16 shape."""
    from paddle_tpu_torch.kernels import conv_bn_relu as k5

    _, c, h, w, f, k, s, p, _ = shape
    base = k5._plan(c, h, w, f, k, k, s, p)
    if base.body == "mma":
        return []
    stages = -(-c * k * k // k5.STAGE_K)
    out = []
    for bn in (64, 128):
        for splits in sorted({1, 2, 3, 4, 6, 8, base.splits}):
            if splits > stages:
                continue
            plan = k5.Plan(base.body, splits, bn)
            if plan != base:
                out.append(plan)
    if base.body == "1x1":  # the row-tile gather on the same shape
        out.append(k5.Plan("gather", base.splits, base.bn))
    out.append(k5.Plan("mma", 1, 64))
    return out


def main(argv):
    import numpy as np
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import conv_bn_relu as k5

    if not torch.cuda.is_available():
        raise SystemExit("k5_bf16_vs_old.py needs an NVIDIA card")
    sweep = "--sweep" in argv[2:]
    old = load_old(argv[1])
    _build.load_library("conv_bn_relu")
    stream = torch.cuda.current_stream().cuda_stream
    flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")
    print(cs.smi_line(), flush=True)

    total = {"old_ms": 0.0, "new_ms": 0.0}
    worst = {"old_ulps": 0.0, "new_ulps": 0.0, "old_share": 0.0,
             "new_share": 0.0}
    n_out = n_diff = 0
    for shape, count, args in cs.amp_census_cases(torch):
        x, w = args[0], args[1]
        plan = k5._plan(*x.shape[1:], w.shape[0], *w.shape[2:], args[4],
                        args[5])
        want = k5.fused_conv_bn_relu_reference(*args)
        ocall, yo = old_call(old, args, stream)
        ncall, yn = plan_call(args, plan)
        ocall()
        ncall()
        torch.cuda.synchronize()
        row = {"shape": list(shape), "count": count, "plan": plan._asdict()}
        for who, y in (("old", yo), ("new", yn)):
            err, ulps, share = cs._bf16_ulps(y, want)
            row[f"{who}_ulps"], row[f"{who}_share"] = ulps, share
            worst[f"{who}_ulps"] = max(worst[f"{who}_ulps"], ulps)
            worst[f"{who}_share"] = max(worst[f"{who}_share"], share)
        diff = int((yo != yn).sum().item())
        row["share_new_vs_old"] = diff / yn.numel()
        n_out, n_diff = n_out + yn.numel(), n_diff + diff
        t_old, t_new, _ = cs._in_turns(torch, ocall, ncall, flush)
        row.update(old_ms=t_old, new_ms=t_new, new_over_old=t_new / t_old)
        total["old_ms"] += count * t_old
        total["new_ms"] += count * t_new
        if sweep:
            row["sweep"] = []
            for other in other_plans(shape):
                call, y = plan_call(args, other)
                call()
                torch.cuda.synchronize()
                _, ulps, share = cs._bf16_ulps(y, want)
                t_base, t_other, _ = cs._in_turns(torch, ncall, call, flush)
                row["sweep"].append({"plan": other._asdict(), "ms": t_other,
                                     "default_ms": t_base, "ulps": ulps,
                                     "share": share})
        print(json.dumps(row), flush=True)
        del args, want, yo, yn

    # host time of the C entries at batch 1 and small images, where the
    # card's work is short: a 1x1 (one launch) and a 3x3 whose plan
    # splits K (conv entry + combine entry; the wrapper also allocates
    # the workspace)
    lib = _build.load_library("conv_bn_relu")
    host = {}
    for name, shape in (("1x1", (1, 64, 8, 8, 64, 1, 1, 0, True)),
                        ("3x3 split", (1, 64, 8, 8, 64, 3, 1, 1, True))):
        args = cs._amp_conv_case(torch, np.random.RandomState(5), *shape)
        x, w, sc, sh, st, pd, relu = args
        n, c, h, wd = x.shape
        f, _, kh, kw = w.shape
        oh, ow = k5.conv_out_hw(h, wd, kh, kw, st, pd)
        plan = k5.plan_for(x.shape, w.shape, st, pd)
        y = torch.empty((n, f, oh, ow), dtype=torch.bfloat16, device="cuda")
        m = n * oh * ow
        ws = torch.empty(plan.splits * f * (-(-m // 4) * 4),
                         dtype=torch.float32, device="cuda")

        def conv_entry():
            err = lib.conv_bn_relu_bf16(
                x.data_ptr(), w.data_ptr(), sc.data_ptr(), sh.data_ptr(),
                y.data_ptr(), ws.data_ptr(), n, c, h, wd, f, kh, kw, st, pd,
                oh, ow, int(relu), k5.BODIES.index(plan.body), plan.splits,
                plan.bn, stream)
            if err:
                raise RuntimeError(f"{FN} launch failed: CUDA error {err}")

        def combine_entry():
            err = lib.conv_split_combine_bf16(
                ws.data_ptr(), sc.data_ptr(), sh.data_ptr(), y.data_ptr(), m,
                f, oh * ow, plan.splits, int(relu), stream)
            if err:
                raise RuntimeError(f"combine launch failed: CUDA error {err}")

        ocall, _ = old_call(old, args, stream)
        host[name] = {"shape": list(shape), "plan": plan._asdict(),
                      "old_entry_us": cs._host_us(torch, ocall),
                      "new_entry_us": cs._host_us(torch, conv_entry),
                      "new_wrapper_us": cs._host_us(
                          torch, lambda: k5._conv_cuda(*args))}
        if plan.splits > 1:
            host[name]["combine_entry_us"] = cs._host_us(torch, combine_entry)
    print(json.dumps({
        "forward_53_convs": dict(total, new_over_old=total["new_ms"]
                                 / total["old_ms"]),
        "worst": worst, "share_new_vs_old_all": n_diff / n_out,
        "host": host, "device": torch.cuda.get_device_name(0)}), flush=True)
    print(cs.smi_line(), flush=True)


if __name__ == "__main__":
    main(sys.argv)
