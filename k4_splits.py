"""Time the paged-attention kernel (K4) at several split lengths on one
NVIDIA card.

    python3 k4_splits.py                    # splits 64, 128, 256, 512
    python3 k4_splits.py 128 256            # the given splits
    python3 k4_splits.py --wide             # head_dim 264, 512: 32..256
    python3 k4_splits.py --wide 64 128      # the given splits there

K4 cuts each slot's keys into fixed splits (one partial softmax state
per split, merged by a second kernel) whose length follows from head_dim
alone: ``kernels/paged_attention.py:SPLIT_KEYS``, and ``SPLIT_KEYS_WIDE``
at head_dim 257-512. This script sets that constant to each value in
turn, in the same process, with the kernels built from the checkout as
``chip_smoke.py`` builds them, and at the shapes of ``chip_smoke.py``'s
kernels phase (decode B=8, the one-slot request B=1, GQA decode, a C=64
prefill chunk; head_dim 64, page 16, table width 64; with --wide decode
and a C=64 chunk at head_dim 264 and 512, B=8, Hq=Hkv=4, float32 pages,
and decode on bf16 pages) holds each split's output against the plain
version (within chip_smoke.TOL) and times it: the splits in order, then
reversed, the median of 25 launches each with the L2 flushed and the
queue kept busy before each (chip_smoke._time_ms). Prints one JSON line
per shape and the card's nvidia-smi line.
"""
import json
import os
import statistics
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


def main(splits, wide):
    import numpy as np
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import paged_attention as pa

    cs.device_phase(torch)
    _build.build_all(["paged_attention"])
    rng = np.random.RandomState(2024)
    base = dict(D=64, ps=16, W=64, P=513)
    lens = [int(x) for x in rng.randint(512, 1025, size=8)]
    knob = "SPLIT_KEYS_WIDE" if wide else "SPLIT_KEYS"
    w8 = dict(base, B=8, Hq=4, Hkv=4, kv_lens=lens)
    shapes = {
        "decode_d264": dict(w8, D=264, C=None, q_lens=None),
        "decode_d512": dict(w8, D=512, C=None, q_lens=None),
        "prefill_d264": dict(w8, D=264, C=64, q_lens=[64] * 8),
        "prefill_d512": dict(w8, D=512, C=64, q_lens=[64] * 8),
        "decode_d264_bf16": dict(w8, D=264, C=None, q_lens=None),
        "decode_d512_bf16": dict(w8, D=512, C=None, q_lens=None),
    } if wide else {
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
    default = getattr(pa, knob)
    try:
        for name, case in shapes.items():
            args = cs._paged_case(torch, rng, **case)
            if name.endswith("_bf16"):
                args = (args[0], args[1].bfloat16(), args[2].bfloat16(),
                        *args[3:])
            ref = pa.paged_attention_reference(*args[:5], q_lens=args[5])
            times = {s: [] for s in splits}
            errs = {}
            for order in (splits, splits[::-1]):
                for split in order:
                    setattr(pa, knob, split)
                    out = pa.paged_attention(*args[:5], q_lens=args[5])
                    errs[split] = (out - ref).abs().max().item()
                    if errs[split] > cs.TOL:
                        raise RuntimeError(f"split {split} {name}: max abs "
                                           f"err {errs[split]:.3g}")
                    times[split].append(cs._time_ms(
                        torch, lambda: pa.paged_attention(
                            *args[:5], q_lens=args[5]), flush))
            row = {"shape": name, "kv_lens": case["kv_lens"],
                   "ms": {s: statistics.mean(t) for s, t in times.items()},
                   "turns_ms": times, "max_abs_err": errs}
            print(json.dumps(row), flush=True)
    finally:
        setattr(pa, knob, default)
    print(cs.smi_line(), flush=True)


if __name__ == "__main__":
    wide = "--wide" in sys.argv[1:]
    main([int(a) for a in sys.argv[1:] if a != "--wide"]
         or ([32, 64, 128, 256] if wide else [64, 128, 256, 512]), wide)
