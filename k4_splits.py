"""Time the paged-attention kernel (K4) at several split lengths on one
NVIDIA card.

    python3 k4_splits.py                    # splits 64, 128, 256, 512
    python3 k4_splits.py 128 256            # the given splits

K4 cuts each slot's keys into fixed splits of
``kernels/paged_attention.py:SPLIT_KEYS`` keys (one partial softmax
state per split, merged by a second kernel). This script sets that
constant to each value in turn, in the same process, with the kernels
built from the checkout as ``chip_smoke.py`` builds them, and at the
shapes of ``chip_smoke.py``'s kernels phase (decode B=8, the one-slot
request B=1, GQA decode, a C=64 prefill chunk; head_dim 64, page 16,
table width 64) holds each split's output against the plain version
(within chip_smoke.TOL) and times it: the splits in order, then
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


def main(splits):
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
    default = pa.SPLIT_KEYS
    try:
        for name, case in shapes.items():
            args = cs._paged_case(torch, rng, **case)
            ref = pa.paged_attention_reference(*args[:5], q_lens=args[5])
            times = {s: [] for s in splits}
            errs = {}
            for order in (splits, splits[::-1]):
                for split in order:
                    pa.SPLIT_KEYS = split
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
        pa.SPLIT_KEYS = default
    print(cs.smi_line(), flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [64, 128, 256, 512])
