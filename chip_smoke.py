"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

  device   requires CUDA; prints the card, its capability and the
           `nvidia-smi --query-gpu=name,power.limit` line; TF32 off
           (float32 matmuls in full float32, as the JAX package's
           matmul_precision='highest').
  build    compiles every kernel in paddle_tpu_torch/csrc with nvcc for
           sm_90a, one process per source, all started together, and
           prints the seconds.
  kernels  holds the paged-attention kernel (K4) against its plain
           PyTorch version on the card on seeded cases (max abs error
           <= 1e-4; dead slots and dead query lanes exactly 0), then
           times kernel, plain version and one PyTorch library call at
           the serving phase's shapes (CUDA events, L2 flushed before
           each launch, median of 25).
  train kernels
           the same for the training kernels: layer norm (K1), flash
           forward (K2), flash dK/dV (K3a) and flash dQ (K3b) against
           their plain versions (max abs error <= 1e-4 at unit-scale
           inputs; causal and not, lengths that fit no tile, Sq != Sk
           both ways, head_dim 64, 16, 20 and 128); K3a and K3b twice on
           the same inputs, bitwise equal; K3a/K3b, the plain backward
           and SDPA's against float64 at the train shape and a 4x longer
           sequence (max abs error, recorded, not held); timed at the
           train phase's shapes beside F.layer_norm and SDPA pinned to
           its memory-efficient backend (forward, and its backward alone for
           K3a + K3b); the port's whole flash backward (delta + K3a +
           K3b) and SDPA's backward in turns, with their ratio.
  infer kernels
           the same for the fused conv + folded-BN + relu kernel (K5)
           against its plain version (max abs error within 1e-4 of the
           output's max at unit-scale inputs: the JAX tests' four
           shapes with F and K that fit no tile, the 7x7/2 stem, a 1x1/2
           projection, a res5 3x3, relu on and off), timed beside its
           plain version and F.conv2d (cuDNN, TF32 off) + the same
           epilogue at three batch-16 ResNet-50 shapes and summed over
           the 53 convolutions of one batch-16 forward.
  serve    the decode-serving main path at GPT-2-medium width (24
           layers, d_model 1024, 16 heads, vocab 50257, seeded weights):
           a ServingServer on the card, load_decoder, 8 concurrent
           generate requests, a repeated prompt (prefix-cache hit, same
           tokens), a streamed request (equals its buffered twin). The
           kernel counters are zeroed just before and read just after:
           every attention launch must have gone through the kernel
           (24 per engine step) and none through the plain version.
  train    the Fluid training main path: Transformer-base (6+6 layers,
           d_model 512, 8 heads, d_ff 2048, vocab 32000, max_len 512,
           dropout 0.1, seq_parallel attention), Adam(1e-4), batch 16,
           the startup program run on the card, 5 steps on one seeded
           batch (transformer_bench.py's copy task). Counters zeroed
           just before the steps and read just after: 30 layer-norm, 18
           flash-forward, 18 dK/dV and 18 dQ launches per step, no plain
           call; the loss finite and falling. The embedding gradient
           twice on the feed's ids, bitwise equal. Then one more step
           under torch.profiler for the device's busy share.
  check    the decoder step at full width (2 layers) on the card and on
           the CPU: logits agree, and a small engine decodes the same
           greedy tokens on both devices; then one Transformer training
           step at full width (2+2 layers, dropout 0, batch 2) on the
           card (kernels) and on the CPU (plain versions) from the same
           parameters: the loss and every parameter gradient agree.

  infer    the fused ResNet inference main path: ResNet-50 ImageNet
           (224x224x3, 1000 classes, [3, 4, 6, 3] bottlenecks, 25.6M
           parameters, float32; seeded weights, every conv's Scale/Shift
           from fold_bn of seeded statistics), save_inference_model, a
           ServingServer on the card, load_model with the [1, 2, 4, 8,
           16] ladder, 24 concurrent infer requests of 1-4 images over
           RPC. Counters zeroed just before the requests and read just
           after: 53 K5 launches per executed batch, no plain call; every
           answer equals a direct exe.run of its images. Then 10 bucket-16
           requests for images/s, per-bucket compute ms, the feed's
           host->device copy, and one profiled request.
  infer check
           ResNet-50 at batch 2 on the card (K5) and on the CPU (plain
           version) from the same parameters: logits agree within 1e-4
           of the largest |logit|.

The last lines are the kernels JSON line, the nvidia-smi line and
{"ok": true, "device": {...}}.
"""
import json
import os
import statistics
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth, float32
# outside the tensor cores, and TF32 on the tensor cores (dense)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
TOL = 1e-4

GPT2_MEDIUM = dict(vocab=50257, d_model=1024, n_layers=24, n_heads=16,
                   n_kv_heads=16, seed=0)
SERVE = dict(slots=[1, 2, 4, 8], page_size=16, num_pages=513,
             max_seq_len=1024, prefill_chunk=64)


def log(*a):
    print(*a, flush=True)


def phase(name):
    log(f"== {name}")


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi failed: {out.stderr.strip()}"


# --- device --------------------------------------------------------------

def device_phase(torch):
    phase("device")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this "
                           "script needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(f"device {name} capability {torch.cuda.get_device_capability(0)} "
        f"count {torch.cuda.device_count()} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    smi = smi_line()
    log(smi)
    return name, smi


# --- build ---------------------------------------------------------------

def build_phase():
    phase("build")
    from paddle_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"built {sorted(secs)} in {time.perf_counter() - t0:.2f} s "
        f"(per source {secs})")
    for name in secs:
        rep = _build.ptxas_report(name)
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


# --- kernels -------------------------------------------------------------

def _paged_case(torch, rng, *, B, C, Hq, Hkv, D, ps, W, P, kv_lens,
                q_lens):
    """Seeded inputs on the card: tables hold distinct live pages for
    each slot's visible keys and the garbage page 0 past them."""
    import numpy as np

    shape = (B, Hq, D) if C is None else (B, C, Hq, D)
    q = torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda()
    kp = torch.from_numpy(rng.randn(P, ps, Hkv, D).astype(np.float32)).cuda()
    vp = torch.from_numpy(rng.randn(P, ps, Hkv, D).astype(np.float32)).cuda()
    kv = np.asarray(kv_lens, np.int32)
    tables = np.zeros((B, W), np.int32)
    pages = rng.permutation(np.arange(1, P))
    used = 0
    for b in range(B):
        n = -(-int(kv[b]) // ps)
        tables[b, :n] = pages[used:used + n] if used + n <= len(pages) \
            else rng.randint(1, P, size=n)
        used += n
    ql = None if q_lens is None else \
        torch.from_numpy(np.asarray(q_lens, np.int32)).cuda()
    return (q, kp, vp, torch.from_numpy(tables).cuda(),
            torch.from_numpy(kv).cuda(), ql)


def _dead_rows(case, out):
    import numpy as np

    kv = np.asarray(case["kv_lens"])
    if case["q_lens"] is None:
        return out[kv == 0]
    ql = np.asarray(case["q_lens"])
    mask = np.arange(out.shape[1])[None, :] >= ql[:, None]
    return out[mask]


def _time_ms(torch, fn, flush, n=25, warmup=3):
    """Median device ms of one call, L2 flushed before each (the serving
    step reads a layer's pool cold: 23 other layers ran in between)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def _bound(case, D):
    """Least time for the function on these inputs: bytes each input
    read once (visible K/V only) and each output written once over HBM
    bandwidth, against its float32 operations over the float32 peak."""
    import numpy as np

    B, Hq, Hkv = case["B"], case["Hq"], case["Hkv"]
    C = case["C"] or 1
    kv = np.asarray(case["kv_lens"], np.int64)
    ql = (np.asarray(case["q_lens"], np.int64) if case["q_lens"] is not None
          else (kv > 0).astype(np.int64))
    kv_bytes = 2 * int(kv.sum()) * Hkv * D * 4
    qo_bytes = 2 * B * C * Hq * D * 4
    idx_bytes = 4 * (B * case["W"] + 2 * B)
    pairs = sum(int(kv[b] - ql[b] + j + 1) for b in range(B)
                for j in range(int(ql[b])))
    flops = 4 * D * Hq * pairs
    return _bound_of(kv_bytes + qo_bytes + idx_bytes, flops)


def _bound_of(nbytes, flops):
    """(ms, what bounds it): the larger of the bytes over HBM bandwidth
    and the float32 operations over the float32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _library_call(torch, args, case):
    """scaled_dot_product_attention on K/V already gathered dense (the
    gather is outside the timed call): the yardstick, never used by the
    port."""
    import torch.nn.functional as F

    q, kp, vp, tables, kv_lens, q_lens = args
    B, W, ps = case["B"], case["W"], kp.shape[1]
    Hq, Hkv, D = case["Hq"], case["Hkv"], kp.shape[3]
    T = int(kv_lens.max().item())
    k = kp[tables.long()].reshape(B, W * ps, Hkv, D)[:, :T]
    v = vp[tables.long()].reshape(B, W * ps, Hkv, D)[:, :T]
    rep = Hq // Hkv
    k = k.repeat_interleave(rep, 2).transpose(1, 2).contiguous()
    v = v.repeat_interleave(rep, 2).transpose(1, 2).contiguous()
    q4 = q[:, None] if q.ndim == 3 else q
    C = q4.shape[1]
    ql = (kv_lens > 0).int() if q_lens is None else q_lens
    lane = torch.arange(C, device=q.device)[None, :]
    limit = kv_lens[:, None] - ql[:, None] + lane
    t = torch.arange(T, device=q.device)[None, None, :]
    mask = (t <= limit[:, :, None])[:, None]             # [B, 1, C, T]
    qh = q4.transpose(1, 2).contiguous()                 # [B, Hq, C, D]
    return lambda: F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)


def kernels_phase(torch):
    phase("kernels")
    import numpy as np

    from paddle_tpu_torch.kernels import paged_attention as pa

    rng = np.random.RandomState(2024)
    base = dict(D=64, ps=16, W=64, P=600)
    kv8 = [1, 1024, 0, 517, 33, 800, 256, 999]
    cases = {
        "single_token": dict(base, B=8, C=None, Hq=16, Hkv=16,
                             kv_lens=kv8, q_lens=None),
        "chunked": dict(base, B=8, C=64, Hq=16, Hkv=16,
                        kv_lens=[64, 1024, 0, 517, 40, 800, 256, 999],
                        q_lens=[64, 64, 0, 17, 40, 1, 33, 5]),
        "gqa4_single": dict(base, B=8, C=None, Hq=16, Hkv=4,
                            kv_lens=kv8, q_lens=None),
        "gqa4_chunked": dict(base, B=4, C=64, Hq=16, Hkv=4,
                             kv_lens=[700, 64, 3, 0],
                             q_lens=[64, 50, 3, 0]),
    }
    max_err = 0.0
    for name, case in cases.items():
        args = _paged_case(torch, rng, **case)
        ref = pa.paged_attention_reference(*args[:5], q_lens=args[5])
        out = pa.paged_attention(*args[:5], q_lens=args[5])
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        out_np = out.cpu().numpy()
        dead = _dead_rows(case, out_np if out_np.ndim == 4
                          else out_np[:, None])
        if not np.isfinite(out_np).all():
            raise RuntimeError(f"kernel case {name}: non-finite output")
        if dead.size == 0 or np.any(dead != 0.0):
            raise RuntimeError(f"kernel case {name}: dead rows not exactly "
                               f"0 ({dead.size} dead values)")
        if err > TOL:
            raise RuntimeError(f"kernel case {name}: max abs err {err:.3g} "
                               f"> {TOL}")
        max_err = max(max_err, err)
        log(f"  {name}: max abs err {err:.3g}, {dead.size} dead values "
            f"exactly 0")

    # timings at the serving phase's shapes: decode (C=1) and a prefill
    # chunk (C=64), ragged kv_lens 512..1024, all slots live
    flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")
    lens = [int(x) for x in rng.randint(512, 1025, size=8)]
    shapes = {
        "decode": dict(base, B=8, C=None, Hq=16, Hkv=16, P=513,
                       kv_lens=lens, q_lens=None),
        "prefill": dict(base, B=8, C=64, Hq=16, Hkv=16, P=513,
                        kv_lens=lens, q_lens=[64] * 8),
    }
    timings = {}
    for name, case in shapes.items():
        args = _paged_case(torch, rng, **case)
        kw = dict(q_lens=args[5])
        row = {
            "kernel_ms": _time_ms(torch, lambda: pa.paged_attention(
                *args[:5], **kw), flush),
            "plain_ms": _time_ms(torch, lambda: pa.paged_attention_reference(
                *args[:5], **kw), flush),
            "library_ms": _time_ms(torch, _library_call(torch, args, case),
                                   flush),
        }
        row["bound_ms"], row["bound_by"] = _bound(case, 64)
        row["kv_lens"] = lens
        timings[name] = row
        log(f"  time {name}: " + json.dumps(row))
    del flush
    return max_err, timings


# --- the training kernels (K1 layer norm, K2/K3a/K3b flash attention) ---

# the train phase's shapes: Transformer-base, batch 16, length 512
TRAIN_ROWS, D_MODEL, N_HEADS, SEQ = 16 * 512, 512, 8, 512


def _randn(torch, rng, *shape):
    import numpy as np

    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda()


def _flash_case(torch, rng, bh, sq, sk, d, causal):
    """Seeded q/k/v/dO on the card, and the saved LSE and delta from the
    plain forward (the backward kernels' inputs)."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    q, k, v = (_randn(torch, rng, bh, s, d) for s in (sq, sk, sk))
    do = _randn(torch, rng, bh, sq, d)
    scale = d ** -0.5
    o, lse = fa.flash_attention_fwd_reference(q, k, v, causal, scale)
    delta = (do * o).sum(-1)
    return dict(q=q, k=k, v=v, do=do, o=o, lse=lse, delta=delta,
                causal=causal, scale=scale)


def _flash_pairs(sq, sk, causal):
    """(query, key) pairs the function computes: all, or causal ones."""
    if not causal:
        return sq * sk
    return sum(min(i + 1, sk) for i in range(sq))


# what the flash kernels' operations are timed against in ``bound_ms``
FLASH_PEAK = ("products as 3xTF32 on the tensor cores (3 x flops over "
              "495 TFLOP/s TF32 dense) + ~5 float32 flops a pair over "
              "67 TFLOP/s")


def _flash_bounds(bh, sq, sk, d, causal):
    """Least time per kernel: each input read once and each output
    written once over HBM bandwidth, against the flops each (query, key)
    pair needs — 2 per multiply-add of the products, plus ~5 for the
    scale, mask, exp and the softmax or ds arithmetic. The card computes
    float32-accurate products fastest as 3xTF32 on the tensor cores
    (three TF32 products each, over the TF32 peak), and the ~5 on the
    float32 ALUs: that is ``bound_ms``. ``bound_f32_ms`` counts every
    flop over the float32 peak (the CUDA-core floor of a scalar kernel,
    the bound before the backward ran on the tensor cores)."""
    pairs = bh * _flash_pairs(sq, sk, causal)
    qo = bh * sq * d * 4
    kv = bh * sk * d * 4
    rows = bh * sq * 4
    out = {}
    for name, nbytes, products in (
            ("flash_fwd_f32", 2 * qo + 2 * kv + rows, 4 * d),
            # reads q, k, v, dO, lse, delta; writes dK, dV
            ("flash_bwd_dkdv_f32", 2 * qo + 4 * kv + 2 * rows, 8 * d),
            # reads q, k, v, dO, lse, delta; writes dQ
            ("flash_bwd_dq_f32", 3 * qo + 2 * kv + 2 * rows, 6 * d)):
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = (pairs * 3 * products / TF32_FLOP_PER_S
                 + pairs * 5 / F32_FLOP_PER_S)
        out[name] = {
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_peak": FLASH_PEAK,
            "bound_f32_ms": _bound_of(nbytes, pairs * (products + 5))[0]}
    return out


# The yardstick of the flash kernels, pinned: SDPA's memory-efficient
# backend, the one PyTorch runs in float32 on this card (the flash and
# cuDNN backends take fp16/bf16 only). Its products are 3xTF32 mma.sync
# (gemm_kernel_utils.h: OpMultiplyAddFastF32), as K3a/K3b's.
SDPA_LIBRARY = "sdpa efficient (3xTF32 mma.sync)"


def _sdpa(torch, c, causal):
    """(forward, backward) calls of SDPA, pinned to its memory-efficient
    backend, on [B, H, S, D] views of a case: the yardstick, never used
    by the port. The backward computes dQ, dK and dV from one retained
    graph."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    b, s, d = 16, SEQ, c["q"].shape[-1]
    q4, k4, v4 = (t.reshape(b, N_HEADS, s, d).detach().requires_grad_()
                  for t in (c["q"], c["k"], c["v"]))
    do4 = c["do"].reshape(b, N_HEADS, s, d)

    def fwd():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q4, k4, v4,
                                                  is_causal=causal)
    out4 = fwd()

    def bwd():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return torch.autograd.grad(out4, (q4, k4, v4), do4,
                                       retain_graph=True)
    return fwd, bwd


def _backward_in_turns(torch, fa, c, causal, sdpa_bwd, flush):
    """The port's whole flash backward as ``_Flash.backward`` runs it
    (delta = rowsum(dO * O), K3a, K3b) and SDPA's backward, timed in
    turns port, SDPA, SDPA, port; each time the median of 25."""
    def port():
        delta = (c["do"] * c["o"]).sum(dim=-1)
        return fa.flash_attention_bwd(c["q"], c["k"], c["v"], c["do"],
                                      c["lse"], delta, causal, c["scale"])
    calls = {"port": port, "sdpa": sdpa_bwd}
    times = {who: [] for who in calls}
    for who in ("port", "sdpa", "sdpa", "port"):
        times[who].append(_time_ms(torch, calls[who], flush))
    port_ms = statistics.mean(times["port"])
    sdpa_ms = statistics.mean(times["sdpa"])
    row = {"port_ms": port_ms, "sdpa_ms": sdpa_ms,
           "ratio_port_over_sdpa": port_ms / sdpa_ms,
           "turns_ms": times, "library": SDPA_LIBRARY}
    log(f"  whole backward causal={causal}: port (delta + K3a + K3b) "
        f"{port_ms:.4f} ms, SDPA efficient backward {sdpa_ms:.4f} ms, "
        f"ratio {port_ms / sdpa_ms:.3f} (turns {json.dumps(times)})")
    return row


def _bwd_float64(torch, c, causal, lse=None, delta=None):
    """(dQ, dK, dV) of a case in float64 by the dense formulas: from
    q, k, v and dO alone, or from the given float32 LSE and delta (the
    kernels' own inputs), which leaves only the backward's arithmetic."""
    q, k, v, do = (c[n].double() for n in ("q", "k", "v", "do"))
    s = q @ k.transpose(1, 2) * c["scale"]
    if causal:
        keep = (torch.arange(q.shape[1], device=q.device)[:, None]
                >= torch.arange(k.shape[1], device=q.device)[None, :])
        s = s.masked_fill(~keep, float("-inf"))
    lse = torch.logsumexp(s, -1) if lse is None else lse.double()
    p = torch.exp(s - lse[..., None])
    if delta is None:
        delta = (do * (p @ v)).sum(-1)
    ds = p * (do @ v.transpose(1, 2) - delta.double()[..., None])
    return (ds @ k * c["scale"], ds.transpose(1, 2) @ q * c["scale"],
            p.transpose(1, 2) @ do)


def _backward_vs_float64(torch, fa, rng):
    """Max abs error of dQ/dK/dV against float64 at the train shape and
    at a 4x longer sequence, full and causal: K3a/K3b and the plain
    version, each from scratch (float32 LSE and delta from the plain
    forward, as the kernels get them) and given the same LSE and delta;
    SDPA's memory-efficient forward + backward from scratch."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    out = {}
    for bh, s in ((16 * N_HEADS, SEQ), (2 * N_HEADS, 4 * SEQ)):
        for causal in (False, True):
            c = _flash_case(torch, rng, bh, s, s, D_MODEL // N_HEADS, causal)
            bargs = (c["q"], c["k"], c["v"], c["do"], c["lse"], c["delta"],
                     causal, c["scale"])
            exact = _bwd_float64(torch, c, causal)
            given = _bwd_float64(torch, c, causal, c["lse"], c["delta"])
            dk, dv = fa._bwd_dkdv_cuda(*bargs)
            port = (fa._bwd_dq_cuda(*bargs), dk, dv)
            plain = fa.flash_attention_bwd_reference(*bargs)
            q4, k4, v4 = (c[n].reshape(bh // N_HEADS, N_HEADS, s, -1)
                          .detach().requires_grad_() for n in "qkv")
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                o4 = F.scaled_dot_product_attention(q4, k4, v4,
                                                    is_causal=causal)
                sdpa = [g.reshape(bh, s, -1) for g in torch.autograd.grad(
                    o4, (q4, k4, v4), c["do"].reshape(o4.shape))]

            def err(got, want):
                return [(g.double() - w).abs().max().item()
                        for g, w in zip(got, want)]
            row = {"max_abs_dq_dk_dv": [w.abs().max().item() for w in exact],
                   "kernels": err(port, exact), "plain": err(plain, exact),
                   "sdpa_efficient": err(sdpa, exact),
                   "kernels_given_lse_delta": err(port, given),
                   "plain_given_lse_delta": err(plain, given)}
            key = f"BH={bh} S={s} {'causal' if causal else 'full'}"
            out[key] = row
            log(f"  vs float64, {key}: max abs err dQ/dK/dV "
                + json.dumps(row))
            del c, exact, given, port, plain, sdpa, o4
    torch.cuda.empty_cache()
    return out


def train_kernels_phase(torch):
    """K1, K2, K3a and K3b against their plain versions on the card
    (max abs error <= TOL at unit-scale inputs), K3a/K3b launched twice
    for bitwise-equal outputs and read against float64, then timed with
    their plain versions and one library call at the train phase's
    shapes, and the whole flash backward beside SDPA's in turns."""
    phase("train kernels")
    import numpy as np
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import layer_norm as ln

    rng = np.random.RandomState(2025)
    errs = {fa.FWD: 0.0, fa.BWD_DKDV: 0.0, fa.BWD_DQ: 0.0, ln.KERNEL: 0.0}

    def hold(kernel, what, got, want):
        err = (got - want).abs().max().item()
        if not torch.isfinite(got).all() or err > TOL:
            raise RuntimeError(f"{kernel} {what}: max abs err {err:.3g} > "
                               f"{TOL} (or not finite)")
        errs[kernel] = max(errs[kernel], err)
        return err

    # K1: the train shape, and rows/width that fit no tile
    for n, f in ((TRAIN_ROWS, D_MODEL), (37, 24), (5, 1000)):
        x = _randn(torch, rng, n, f)
        s, b = _randn(torch, rng, f), _randn(torch, rng, f)
        got = ln._layer_norm_cuda(x, s, b, 1e-5)
        want = ln.layer_norm_reference(x, s, b, 1e-5)
        torch.cuda.synchronize()
        e = [hold(ln.KERNEL, name, g, w)
             for name, g, w in zip(("y", "mean", "rstd"), got, want)]
        log(f"  layer_norm [{n}, {f}]: max abs err y/mean/rstd "
            + " / ".join(f"{x:.3g}" for x in e))

    # K2, K3a, K3b: causal and not; S not a multiple of the tiles;
    # Sq != Sk both ways (causal with Sq > Sk too); head_dim 64 (the
    # model's), 16, 20 (zero-padded k slice and head_dim tail) and 128
    # (the largest bucket)
    cases = [(128, SEQ, SEQ, 64, False), (128, SEQ, SEQ, 64, True),
             (6, 40, 40, 64, True), (6, 40, 72, 64, False),
             (6, 40, 72, 64, True), (6, 100, 33, 16, True),
             (6, 100, 33, 16, False), (6, 77, 50, 20, True),
             (6, 50, 77, 20, False), (4, 200, 130, 128, True),
             (4, 130, 200, 128, False), (8, 300, 170, 64, True)]
    for bh, sq, sk, d, causal in cases:
        c = _flash_case(torch, rng, bh, sq, sk, d, causal)
        args = (c["q"], c["k"], c["v"])
        o, lse = fa._fwd_cuda(*args, causal, c["scale"])
        bargs = args + (c["do"], c["lse"], c["delta"], causal, c["scale"])
        dk, dv = fa._bwd_dkdv_cuda(*bargs)
        dq = fa._bwd_dq_cuda(*bargs)
        rq, rk, rv = fa.flash_attention_bwd_reference(*bargs)
        torch.cuda.synchronize()
        e = [hold(fa.FWD, "O", o, c["o"]), hold(fa.FWD, "LSE", lse, c["lse"]),
             hold(fa.BWD_DKDV, "dK", dk, rk), hold(fa.BWD_DKDV, "dV", dv, rv),
             hold(fa.BWD_DQ, "dQ", dq, rq)]
        log(f"  flash bh={bh} sq={sq} sk={sk} d={d} causal={causal}: max "
            f"abs err O/LSE/dK/dV/dQ " + " / ".join(f"{x:.3g}" for x in e))

    # no atomics: two launches on the training shape's inputs give
    # bitwise-equal dK, dV and dQ
    for causal in (False, True):
        c = _flash_case(torch, rng, 16 * N_HEADS, SEQ, SEQ, 64, causal)
        bargs = (c["q"], c["k"], c["v"], c["do"], c["lse"], c["delta"],
                 causal, c["scale"])
        first = fa._bwd_dkdv_cuda(*bargs) + (fa._bwd_dq_cuda(*bargs),)
        second = fa._bwd_dkdv_cuda(*bargs) + (fa._bwd_dq_cuda(*bargs),)
        if not all(torch.equal(x, y) for x, y in zip(first, second)):
            raise RuntimeError(f"K3a/K3b causal={causal}: two launches on "
                               f"the same inputs differ")
    log("  flash backward: two launches bitwise equal (full and causal)")
    vs_float64 = _backward_vs_float64(torch, fa, rng)

    # timings at the train phase's shapes
    flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")
    rows = {}
    x = _randn(torch, rng, TRAIN_ROWS, D_MODEL)
    s, b = _randn(torch, rng, D_MODEL), _randn(torch, rng, D_MODEL)
    n, f = x.shape
    rows[ln.KERNEL] = {
        "ms": _time_ms(torch, lambda: ln._layer_norm_cuda(x, s, b, 1e-5),
                       flush),
        "plain_ms": _time_ms(torch, lambda: ln.layer_norm_reference(
            x, s, b, 1e-5), flush),
        "library_ms": _time_ms(torch, lambda: F.layer_norm(
            x, (f,), s, b, 1e-5), flush),
        "shape": f"x [{n}, {f}] f32",
    }
    # ~8 flops an element; x read and y written, scale/bias read, two
    # row statistics written
    rows[ln.KERNEL]["bound_ms"], rows[ln.KERNEL]["bound_by"] = _bound_of(
        (2 * n * f + 2 * f + 2 * n) * 4, 8 * n * f)

    bh, d = 16 * N_HEADS, D_MODEL // N_HEADS
    backward = {}
    for causal in (False, True):
        c = _flash_case(torch, rng, bh, SEQ, SEQ, d, causal)
        args = (c["q"], c["k"], c["v"], causal, c["scale"])
        bargs = (c["q"], c["k"], c["v"], c["do"], c["lse"], c["delta"],
                 causal, c["scale"])
        sdpa, sdpa_bwd = _sdpa(torch, c, causal)
        bounds = _flash_bounds(bh, SEQ, SEQ, d, causal)
        timed = {
            fa.FWD: (lambda: fa._fwd_cuda(*args),
                     lambda: fa.flash_attention_fwd_reference(*args), sdpa),
            fa.BWD_DKDV: (lambda: fa._bwd_dkdv_cuda(*bargs),
                          lambda: fa.flash_attention_bwd_reference(*bargs),
                          sdpa_bwd),
            fa.BWD_DQ: (lambda: fa._bwd_dq_cuda(*bargs),
                        lambda: fa.flash_attention_bwd_reference(*bargs),
                        None),
        }
        for name, (kern, plain, lib) in timed.items():
            row = {
                "ms": _time_ms(torch, kern, flush),
                "plain_ms": _time_ms(torch, plain, flush),
                "library_ms": _time_ms(torch, lib, flush) if lib else None,
                **bounds[name],
                "shape": f"[BH={bh}, S={SEQ}, D={d}] f32 causal={causal}",
            }
            if lib:
                row["library"] = SDPA_LIBRARY
            if name == fa.BWD_DKDV:
                row["library_note"] = ("SDPA backward alone: computes dQ, "
                                       "dK and dV (K3a + K3b together)")
            if name == fa.BWD_DQ:
                row["library_note"] = "counted with flash_bwd_dkdv_f32"
                row["plain_note"] = ("the plain backward computes dQ, dK "
                                     "and dV (K3a + K3b together)")
            rows.setdefault(name, {})["causal" if causal else "full"] = row
        backward["causal" if causal else "full"] = _backward_in_turns(
            torch, fa, c, causal, sdpa_bwd, flush)
        del sdpa, sdpa_bwd
    del flush
    rows[fa.BWD_DKDV]["whole_backward"] = backward
    rows[fa.BWD_DKDV]["vs_float64"] = vs_float64
    for name, row in rows.items():
        log(f"  time {name}: " + json.dumps(row))
    return errs, rows


# --- serve ---------------------------------------------------------------

def serve_phase(torch):
    phase("serve")
    import numpy as np

    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.observability import metrics, tracing
    from paddle_tpu_torch.serving import ServingClient, ServingServer

    steps_c = metrics.counter("serving.decode.target_steps")
    torch.cuda.reset_peak_memory_stats()
    srv = ServingServer()
    addr = srv.serve()
    clients = [ServingClient(addr, timeout=900.0) for _ in range(8)]
    try:
        # the main path's window: counters to 0, load + warm + traffic
        pa.counts.reset()
        steps0 = steps_c.value()
        t0 = time.perf_counter()
        st = clients[0].load_decoder("gpt2m", GPT2_MEDIUM, **SERVE)
        load_s = time.perf_counter() - t0
        log(f"  load+warm {load_s:.2f} s; slots {st['slots']} widths "
            f"{st['table_widths']} chunks {st['chunk_ladder']}; "
            f"{len(st['compiled_shapes'])} step shapes")

        rng = np.random.RandomState(7)
        lens = [int(x) for x in rng.randint(32, 901, size=8)]
        prompts = [[int(t) for t in rng.randint(0, 50257, size=n)]
                   for n in lens]
        results = [None] * 8
        errors = []
        tracing.trace_reset()
        tracing.trace_enable()

        def one(i):
            try:
                results[i] = clients[i].generate("gpt2m", prompts[i],
                                                 max_new_tokens=32)
            except Exception as e:  # reported below, fails the phase
                errors.append(f"request {i}: {type(e).__name__}: {e}")

        t0 = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(900)
        wall = time.perf_counter() - t0
        tracing.trace_disable()
        if errors or any(r is None for r in results):
            raise RuntimeError(f"concurrent generate failed: {errors}")
        for r, n in zip(results, lens):
            toks = r["tokens"]
            if len(toks) != 32 or r["prompt_len"] != n or \
                    not all(0 <= t < 50257 for t in toks):
                raise RuntimeError(f"bad generate result {r}")
        gen = sum(len(r["tokens"]) for r in results)

        rep = clients[0].generate("gpt2m", prompts[3], max_new_tokens=32)
        if rep["tokens"] != results[3]["tokens"] or \
                rep["cached_tokens"] <= 0:
            raise RuntimeError(
                f"repeated prompt: tokens equal "
                f"{rep['tokens'] == results[3]['tokens']}, cached_tokens "
                f"{rep['cached_tokens']}")
        stream = clients[1].generate("gpt2m", prompts[5],
                                     max_new_tokens=32, stream=True)
        streamed = list(stream)
        if streamed != results[5]["tokens"]:
            raise RuntimeError("streamed tokens differ from the buffered "
                               "twin")
        models = clients[0].list_models()
        pages_used = models["gpt2m"]["kv"]["pages_used"]
        launches = pa.counts.kernel_launches[pa.KERNEL]
        plain = pa.counts.plain_calls[pa.KERNEL]
        steps = steps_c.value() - steps0
        # the window ends here: the counts belong to the main path
        if pages_used != 0:
            raise RuntimeError(f"pages_used {pages_used} != 0 after drain")
        if launches != 24 * steps or launches == 0:
            raise RuntimeError(f"kernel launches {launches} != 24 x "
                               f"{steps} target steps")
        if plain != 0:
            raise RuntimeError(f"plain version ran {plain} times on the "
                               "card's main path")

        spans = [ev for ev in tracing.trace_events()
                 if ev.get("name") == "serving.decode.step"]
        dec = [ev["dur"] / 1e3 for ev in spans
               if ev["args"].get("prefill_tokens") == 0]
        mix = [ev["dur"] / 1e3 for ev in spans
               if ev["args"].get("prefill_tokens", 0) > 0]
        serve = {
            "load_warm_s": load_s,
            "prompt_lens": lens,
            "batch_wall_s": wall,
            "batch_tokens_per_s": gen / wall,
            "batch_steps": len(spans),
            "decode_steps": len(dec),
            "mixed_steps": len(mix),
            "p50_decode_step_ms": statistics.median(dec) if dec else None,
            "p50_mixed_step_ms": statistics.median(mix) if mix else None,
            "target_steps_total": steps,
            "kernel_launches": launches,
            "plain_calls": plain,
            "requests_answered": 10,
            "repeat_cached_tokens": rep["cached_tokens"],
            "peak_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9,
        }
        log("  serve " + json.dumps(serve))
        serve["profile"] = profile_decode(torch, clients[2], rng)
        return launches, serve
    finally:
        for c in clients:
            c.close()
        srv.shutdown()


def profile_decode(torch, client, rng):
    """One more request (a 512-token prompt, 16 new tokens) under
    torch.profiler, after the main path's counts were read: device time
    by kernel, and the device's busy share of the request's wall time.
    Reporting only — a profiler that sees no device time says so."""
    from torch.profiler import ProfilerActivity, profile

    prompt = [int(t) for t in rng.randint(0, 50257, size=512)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        client.generate("gpt2m", prompt, max_new_tokens=16)
        wall_ms = (time.perf_counter() - t0) * 1e3
    return _device_summary(prof.key_averages(), wall_ms, "decode request")


def host_read_ms(torch):
    """The engine's one host read per step: [8, 50257] float32 logits."""
    x = torch.randn(8, 50257, device="cuda")
    times = []
    for _ in range(25):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x.cpu()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# --- check against the plain path ----------------------------------------

def check_phase(torch):
    phase("check")
    import numpy as np

    from paddle_tpu_torch.serving import decode as td

    # one mixed step at full width (2 layers): card (kernel) vs CPU
    # (plain version) on the same seeded parameters and inputs
    spec = td.DecoderSpec(**dict(GPT2_MEDIUM, n_layers=2))
    rng = np.random.RandomState(11)
    B, C, ps, W, P = 2, 16, 16, 4, 12
    tokens = rng.randint(0, spec.vocab, size=(B, C)).astype(np.int32)
    positions = np.stack([np.arange(20, 20 + C), np.arange(C)]).astype(
        np.int32)
    q_lens = np.array([C, 9], np.int32)
    kv_lens = np.array([20 + C, 9], np.int32)
    tables = np.array([[1, 2, 3, 0], [4, 0, 0, 0]], np.int32)
    pool = (spec.n_layers, P, ps, spec.n_kv_heads, spec.head_dim)
    k0 = rng.randn(*pool).astype(np.float32)
    v0 = rng.randn(*pool).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        params = td.build_decoder_params(spec, device=dev)
        with torch.no_grad():
            _, _, logits = td.decoder_step_chunked(
                params, spec, *(torch.from_numpy(a).to(dev) for a in
                                (tokens, positions, q_lens)),
                torch.from_numpy(k0.copy()).to(dev),
                torch.from_numpy(v0.copy()).to(dev),
                torch.from_numpy(tables).to(dev),
                torch.from_numpy(kv_lens).to(dev))
        out[dev] = logits.cpu().numpy()
    lg = out["cuda"]
    if lg.shape != (B, spec.vocab) or not np.isfinite(lg).all():
        raise RuntimeError(f"full-width step logits {lg.shape} not finite "
                           f"or of the wrong shape")
    err = float(np.abs(lg - out["cpu"]).max())
    if err > 1e-3 or not np.array_equal(lg.argmax(-1),
                                        out["cpu"].argmax(-1)):
        raise RuntimeError(f"full-width step: card vs CPU logits max abs "
                           f"err {err:.3g}")
    log(f"  full-width step (2 layers) card vs CPU logits max abs err "
        f"{err:.3g}")

    # a small engine: the same greedy tokens through the kernel and the
    # plain version
    small = td.DecoderSpec(vocab=64, d_model=32, n_layers=2, n_heads=4,
                           n_kv_heads=2, seed=11)
    prompts = [[int(t) for t in rng.randint(0, 64, size=n)]
               for n in (5, 13, 20)]
    toks = {}
    for dev in ("cuda", "cpu"):
        eng = td.DecodeEngine(small, slots=[1, 2], page_size=4,
                              num_pages=40, max_seq_len=32,
                              prefill_chunk=8, device=dev)
        try:
            toks[dev] = [eng.generate(p, max_new_tokens=8)["tokens"]
                         for p in prompts]
        finally:
            eng.stop()
    if toks["cuda"] != toks["cpu"]:
        raise RuntimeError(f"small engine tokens differ: {toks}")
    log(f"  small engine: card and CPU tokens equal ({toks['cuda'][0]})")


# --- train: the Fluid training main path ---------------------------------

TRANSFORMER_BASE = dict(src_vocab=32000, trg_vocab=32000, max_len=SEQ,
                        d_model=D_MODEL, n_heads=N_HEADS, d_ff=2048,
                        n_layers=6, dropout=0.1, seq_parallel=True)
TRAIN_BATCH, TRAIN_STEPS = 16, 5


def build_transformer(cfg_kw, lr):
    """Main and startup programs of the Transformer with Adam(lr), built
    with the port's fluid layers (seeded)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import layers, unique_name
    from paddle_tpu_torch.models import transformer

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with unique_name.guard(), fluid.program_guard(main, startup):
        cfg = transformer.TransformerConfig(**cfg_kw)
        src = layers.data(name="src", shape=[cfg.max_len], dtype="int64")
        trg = layers.data(name="trg", shape=[cfg.max_len], dtype="int64")
        lbl = layers.data(name="lbl", shape=[cfg.max_len, 1], dtype="int64")
        cost, _ = transformer.build_train(cfg, src, trg, lbl)
        _, params_grads = fluid.optimizer.Adam(lr).minimize(cost)
    return main, startup, cost, params_grads


def copy_task_batch(batch, cfg_kw):
    """transformer_bench.py's batch: seeded source ids, the target the
    source shifted right by one, the labels the source."""
    import numpy as np

    rng = np.random.RandomState(0)
    s = rng.randint(3, cfg_kw["src_vocab"],
                    (batch, cfg_kw["max_len"])).astype(np.int64)
    t = np.concatenate([np.zeros((batch, 1), np.int64), s[:, :-1]], axis=1)
    return {"src": s, "trg": t, "lbl": s[:, :, None]}


def _kernel_counts():
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import layer_norm as ln

    launches = {**ln.counts.kernel_launches, **fa.counts.kernel_launches}
    plain = {**ln.counts.plain_calls, **fa.counts.plain_calls}
    return launches, plain


def _reset_kernel_counts():
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import layer_norm as ln

    ln.counts.reset()
    fa.counts.reset()


def train_phase(torch):
    phase("train")
    import numpy as np

    import paddle_tpu_torch.fluid as fluid

    t0 = time.perf_counter()
    main, startup, cost, pg = build_transformer(TRANSFORMER_BASE, 1e-4)
    build_s = time.perf_counter() - t0
    exe, scope = fluid.Executor(), fluid.Scope()
    if exe.device.type != "cuda":
        raise RuntimeError(f"Executor() chose {exe.device}, not the card")
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    n_params = sum(int(np.prod(p.shape)) for p in
                   main.global_block().all_parameters())
    log(f"  built {len(main.global_block().ops)} ops in {build_s:.2f} s; "
        f"startup ({len(startup.global_block().ops)} ops) on the card in "
        f"{startup_s:.2f} s; {n_params} parameter values, "
        f"{len(pg)} trained")
    feed = copy_task_batch(TRAIN_BATCH, TRANSFORMER_BASE)

    # the main path's window: counters to 0, the steps, counters read
    torch.cuda.reset_peak_memory_stats()
    _reset_kernel_counts()
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        (loss,) = exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(np.asarray(loss).reshape(-1)[0]))
    launches, plain = _kernel_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the window ends here
    want = {"layer_norm_f32": 30, "flash_fwd_f32": 18,
            "flash_bwd_dkdv_f32": 18, "flash_bwd_dq_f32": 18}
    for k, per_step in want.items():
        if launches[k] != per_step * TRAIN_STEPS:
            raise RuntimeError(f"{k}: {launches[k]} launches in "
                               f"{TRAIN_STEPS} steps, want {per_step} a "
                               f"step")
    if any(plain.values()):
        raise RuntimeError(f"plain versions ran on the card's main path: "
                           f"{plain}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"losses not finite or not falling: {losses}")
    p50 = statistics.median(step_ms[1:])
    train = {
        "config": "transformer-base 6+6L d512 h8 ff2048 vocab32000 "
                  "len512 dropout0.1 adam1e-4 f32",
        "batch": TRAIN_BATCH, "steps": TRAIN_STEPS,
        "losses": losses, "step_ms": step_ms,
        "p50_step_ms_after_first": p50,
        "tokens_per_s": TRAIN_BATCH * SEQ / (p50 / 1e3),
        "peak_memory_allocated_gb": peak_gb,
        "build_s": build_s, "startup_s": startup_s,
        "kernel_launches": launches, "plain_calls": plain,
    }
    log("  train " + json.dumps(train))
    _embedding_grad_repeats(torch, feed)
    train["profile"] = profile_step(torch, exe, main, feed, cost, scope)
    return launches, train


def _embedding_grad_repeats(torch, feed):
    """The step's one scatter with repeated indices is the embedding
    gradient (every target sequence starts with id 0): two calls on the
    feed's target ids must give bitwise-equal tables, as run-to-run
    bitwise-equal losses need."""
    from paddle_tpu_torch.fluid.ops import tensor_ops

    ids = torch.from_numpy(feed["trg"]).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    dy = torch.randn(*ids.shape, D_MODEL, device="cuda", generator=gen)
    w = torch.zeros(TRANSFORMER_BASE["trg_vocab"], D_MODEL, device="cuda")
    first, second = (tensor_ops._lookup_table_grad(
        None, {"W": [w], "Ids": [ids]}, None, {"Out": [dy]}, {})["GRAD@W"]
        for _ in range(2))
    if not torch.equal(first, second):
        raise RuntimeError("embedding gradient: two calls on the same ids "
                           "differ")
    log("  embedding gradient: two calls bitwise equal")


def profile_step(torch, exe, main, feed, cost, scope):
    """One more training step under torch.profiler, after the main
    path's counts were read: device time by kernel and the device's busy
    share of the step's wall time. Reporting only."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
        wall_ms = (time.perf_counter() - t0) * 1e3
    return _device_summary(prof.key_averages(), wall_ms, "train step")


def _device_summary(events, wall_ms, what):
    """Device time by entry of a profiler's ``key_averages()``."""
    def dev_us(ev):
        return getattr(ev, "self_device_time_total",
                       getattr(ev, "self_cuda_time_total", 0.0))

    # device-side events only (kernels, memcpy/memset): an aten op's
    # device time would count its kernels a second time
    rows = [(ev.key, dev_us(ev), ev.count) for ev in events
            if str(getattr(ev, "device_type", "")).endswith("CUDA")]
    rows = [r for r in rows if r[1] > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) / 1e3
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "busy_share": busy_ms / wall_ms if wall_ms else None,
           "top": [{"name": k[:80], "device_ms": us / 1e3, "count": n}
                   for k, us, n in rows[:12]]}
    if not rows:
        out["note"] = "profiler recorded no device time"
    log(f"  profile {what} " + json.dumps(out))
    return out


def train_check_phase(torch):
    """One training step of a 2+2-layer Transformer at full width, on the
    card (kernels) and on the CPU (plain versions), from the same
    parameters: loss within 1e-5 relative; each parameter gradient's max
    abs difference within 1e-3 of its own max abs value (float32; cuBLAS
    and the CPU sum in other orders, the kernels in another order than
    the dense plain versions)."""
    phase("train check")
    import numpy as np

    import paddle_tpu_torch.fluid as fluid

    kw = dict(TRANSFORMER_BASE, n_layers=2, dropout=0.0)
    main, startup, cost, pg = build_transformer(kw, 1e-4)
    cpu_scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=cpu_scope)
    card_scope = fluid.Scope()
    for n in cpu_scope.var_names():
        card_scope.set_var(n, cpu_scope.find_var(n).cuda())
    feed = copy_task_batch(2, kw)
    fetch = [cost] + [g for _, g in pg]
    out, deltas = {}, {}
    for dev, scope in (("cuda", card_scope), ("cpu", cpu_scope)):
        _reset_kernel_counts()
        exe = fluid.Executor(fluid.CUDAPlace(0) if dev == "cuda"
                             else fluid.CPUPlace())
        out[dev] = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        deltas[dev] = _kernel_counts()
    per_step = {"layer_norm_f32": 10, "flash_fwd_f32": 6,
                "flash_bwd_dkdv_f32": 6, "flash_bwd_dq_f32": 6}
    if deltas["cuda"] != (per_step, dict.fromkeys(per_step, 0)) or \
            deltas["cpu"] != (dict.fromkeys(per_step, 0), per_step):
        raise RuntimeError(f"kernel/plain counts (card, cpu): {deltas}")
    lc, lp = float(out["cuda"][0][0]), float(out["cpu"][0][0])
    if not np.isfinite(lc) or abs(lc - lp) > 1e-5 * abs(lp):
        raise RuntimeError(f"loss card {lc} vs cpu {lp}")
    worst = 0.0
    for (p, _), gc, gp in zip(pg, out["cuda"][1:], out["cpu"][1:]):
        scale = float(np.abs(gp).max())
        ratio = float(np.abs(gc - gp).max()) / scale if scale else \
            float(np.abs(gc).max())
        if not np.isfinite(gc).all() or ratio > 1e-3:
            raise RuntimeError(f"gradient of {p.name}: card vs cpu max abs "
                               f"diff / max abs {ratio:.3g} > 1e-3")
        worst = max(worst, ratio)
    log(f"  transformer 2+2L full width, batch 2: loss card {lc:.7f} cpu "
        f"{lp:.7f}; {len(pg)} gradients agree, worst max-diff/max "
        f"{worst:.3g}")
    return {"loss_card": lc, "loss_cpu": lp, "grads": len(pg),
            "worst_grad_rel_err": worst}


# --- infer kernels: K5, the fused conv + folded-BN + relu ----------------

# the infer phase: ResNet-50 ImageNet (He et al. 2016, Table 1,
# "50-layer"; the repo's resnet_imagenet(depth=50)), 224x224x3, 1000
# classes, float32; batches padded up to this ladder
RESNET_IMAGE, RESNET_CLASSES = 224, 1000
INFER_BUCKETS = [1, 2, 4, 8, 16]
INFER_BATCH = INFER_BUCKETS[-1]
CONVS_PER_FORWARD = 53


def build_resnet50(seed):
    """The port's fused ResNet-50 inference program (+ softmax), seeded:
    (main, startup, logits, prob)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import layers, unique_name
    from paddle_tpu_torch.models import resnet

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with unique_name.guard(), fluid.program_guard(main, startup):
        img = layers.data(name="img",
                          shape=[3, RESNET_IMAGE, RESNET_IMAGE],
                          dtype="float32")
        logits = resnet.resnet_imagenet(img, class_dim=RESNET_CLASSES,
                                        depth=50, is_test=True, fused=True)
        prob = layers.softmax(logits)
    return main, startup, logits, prob


def conv_census(main, batch):
    """{(N, C, H, W, F, k, stride, padding, relu): count} over the
    program's conv2d_bn_relu ops at batch ``batch``."""
    blk = main.global_block()
    out = {}
    for op in blk.ops:
        if op.type != "conv2d_bn_relu":
            continue
        _, c, h, w = blk.var(op.input("X")[0]).shape
        f, _, k, _ = blk.var(op.input("Filter")[0]).shape
        key = (batch, c, h, w, f, k, int(op.attr("stride")),
               int(op.attr("padding")), bool(op.attr("relu")))
        out[key] = out.get(key, 0) + 1
    return out


def _conv_work(n, c, h, w, f, k, s, p, relu):
    """(bytes, flops) of one fused conv: x, w, scale and shift read once
    and y written once; 2*M*K*F flops of the product plus 3 a value for
    the affine and relu."""
    oh, ow = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    m, kk = n * oh * ow, c * k * k
    return (4 * (n * c * h * w + f * kk + 2 * f + n * f * oh * ow),
            2 * m * kk * f + 3 * m * f)


def _conv_bound(*shape):
    """Least time for one fused conv (ms, what bounds it)."""
    return _bound_of(*_conv_work(*shape))


def _conv_case(torch, rng, n, c, h, w, f, k, s, p, relu):
    """Seeded unit-scale x, w, scale, shift on the card."""
    import numpy as np

    x = _randn(torch, rng, n, c, h, w)
    wt = torch.from_numpy((rng.randn(f, c, k, k) / np.sqrt(c * k * k))
                          .astype(np.float32)).cuda()
    sc = torch.from_numpy((rng.rand(f) + 0.5).astype(np.float32)).cuda()
    sh = torch.from_numpy((rng.randn(f) * 0.1).astype(np.float32)).cuda()
    return x, wt, sc, sh, s, p, relu


def _conv_library(torch, x, w, sc, sh, s, p, relu):
    """F.conv2d (cuDNN, TF32 off) and the same affine + relu: the
    yardstick, never used by the port."""
    import torch.nn.functional as F

    sc4, sh4 = sc[None, :, None, None], sh[None, :, None, None]

    def run():
        y = F.conv2d(x, w, stride=s, padding=p) * sc4 + sh4
        return torch.relu(y) if relu else y
    return run


def infer_kernels_phase(torch):
    """K5 against its plain version on the card (max abs error within
    TOL of the output's max at unit-scale inputs: the JAX tests' four
    shapes, the stem, a 1x1/2 projection and a res5 3x3 at batch 2),
    then timed beside its plain version and F.conv2d + epilogue at three
    batch-16 shapes and summed over every convolution of one batch-16
    ResNet-50 forward."""
    phase("infer kernels")
    import numpy as np

    from paddle_tpu_torch.kernels import conv_bn_relu as k5

    rng = np.random.RandomState(2026)
    cases = {
        "jax 3x3": (2, 8, 10, 10, 16, 3, 1, 1, True),
        "jax 3x3/2 odd": (2, 8, 9, 9, 12, 3, 2, 0, True),
        "jax 1x1 no relu": (2, 16, 7, 7, 32, 1, 1, 0, False),
        "jax 5x5/2 F=7": (1, 3, 12, 12, 7, 5, 2, 2, True),
        "stem 7x7/2": (2, 3, 224, 224, 64, 7, 2, 3, True),
        "proj 1x1/2": (2, 256, 56, 56, 512, 1, 2, 0, False),
        "res5 3x3": (2, 512, 7, 7, 512, 3, 1, 1, True),
    }
    max_err = worst_rel = 0.0
    for name, shape in cases.items():
        args = _conv_case(torch, rng, *shape)
        got = k5._conv_cuda(*args)
        want = k5.fused_conv_bn_relu_reference(*args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        if got.shape != want.shape or not torch.isfinite(got).all() or \
                rel > TOL:
            raise RuntimeError(f"K5 case {name}: max abs err {err:.3g}, "
                               f"{rel:.3g} of the output's max > {TOL}")
        max_err, worst_rel = max(max_err, err), max(worst_rel, rel)
        log(f"  conv {name} {shape}: max abs err {err:.3g} ({rel:.3g} of "
            f"max)")

    # each output sums its K products in one order whatever the batch:
    # an image's rows are bitwise the same alone and inside a batch of 16
    args = _conv_case(torch, rng, INFER_BATCH, 64, 56, 56, 64, 3, 1, 1,
                      True)
    whole = k5._conv_cuda(*args)
    alone = k5._conv_cuda(args[0][5:6].contiguous(), *args[1:])
    if not torch.equal(whole[5:6], alone):
        raise RuntimeError("K5: an image's output differs between batch "
                           "16 and batch 1")
    log("  conv res2 3x3: image 5 bitwise equal at batch 16 and alone")

    flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")

    def timed(shape):
        """Times K5, its plain version and the library call on one
        shape, after holding K5 against the plain version there."""
        nonlocal max_err, worst_rel
        args = _conv_case(torch, rng, *shape)
        got = k5._conv_cuda(*args)
        want = k5.fused_conv_bn_relu_reference(*args)
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        if not torch.isfinite(got).all() or rel > TOL:
            raise RuntimeError(f"K5 at {shape}: max abs err {err:.3g}, "
                               f"{rel:.3g} of the output's max > {TOL}")
        max_err, worst_rel = max(max_err, err), max(worst_rel, rel)
        del got, want
        row = {
            "ms": _time_ms(torch, lambda: k5._conv_cuda(*args), flush),
            "plain_ms": _time_ms(torch, lambda:
                                 k5.fused_conv_bn_relu_reference(*args),
                                 flush),
            "library_ms": _time_ms(torch, _conv_library(torch, *args),
                                   flush),
        }
        row["bound_ms"], row["bound_by"] = _conv_bound(*shape)
        return row

    b = INFER_BATCH
    rows = {}
    for name, shape in (("stem 7x7/2 3->64", (b, 3, 224, 224, 64, 7, 2, 3,
                                              True)),
                        ("res2 3x3 64->64", (b, 64, 56, 56, 64, 3, 1, 1,
                                             True)),
                        ("res5 1x1 512->2048", (b, 512, 7, 7, 2048, 1, 1, 0,
                                                False))):
        rows[name] = dict(timed(shape), shape=list(shape))
        log(f"  time {name}: " + json.dumps(rows[name]))

    # every convolution of one batch-16 forward, by distinct shape
    main, _, _, _ = build_resnet50(seed=1)
    census = conv_census(main, b)
    if sum(census.values()) != CONVS_PER_FORWARD:
        raise RuntimeError(f"ResNet-50 has {sum(census.values())} fused "
                           f"convs, want {CONVS_PER_FORWARD}")
    fwd = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms"), 0.0)
    nbytes = flops = 0
    for shape, n in census.items():
        row = timed(shape)
        for key in fwd:
            fwd[key] += n * row[key]
        work = _conv_work(*shape)
        nbytes, flops = nbytes + n * work[0], flops + n * work[1]
    fwd["bound_by"] = _bound_of(nbytes, flops)[1]
    fwd["distinct_shapes"] = len(census)
    fwd["convs"] = CONVS_PER_FORWARD
    fwd["gflop"] = flops / 1e9
    log(f"  time one batch-{b} forward, {CONVS_PER_FORWARD} convs in "
        f"{len(census)} shapes: " + json.dumps(fwd))
    del flush
    return max_err, worst_rel, rows, fwd


# --- infer: ResNet-50 fused inference served on the card ----------------

def seeded_bn_fold(torch, main, scope, seed):
    """Set every conv's Scale/Shift to fold_bn of seeded numpy
    gamma/beta/mean/var, so the epilogue does real work. The last conv
    of each residual branch (a relu=False conv fed by another conv) gets
    gamma in [0.1, 0.3], the others in [0.5, 1.5] (the small-gamma
    initialisation of a residual branch, Goyal et al. 2017): without
    trained statistics the activations then stay near unit scale over
    the 16 blocks instead of growing ~2x a block."""
    import numpy as np

    from paddle_tpu_torch.kernels.conv_bn_relu import fold_bn

    rng = np.random.RandomState(seed)
    producer = {}
    n = 0
    for op in main.global_block().ops:
        for name in op.output("Out"):
            producer[name] = op.type
        if op.type != "conv2d_bn_relu":
            continue
        sname, bname = op.input("Scale")[0], op.input("Shift")[0]
        f = scope.find_var(sname).shape[0]
        branch_end = not op.attr("relu") and \
            producer.get(op.input("X")[0]) == "conv2d_bn_relu"
        gamma = (rng.rand(f) * 0.2 + 0.1 if branch_end
                 else rng.rand(f) + 0.5).astype(np.float32)
        beta = rng.randn(f).astype(np.float32) * 0.1
        mean = rng.randn(f).astype(np.float32) * 0.1
        var = rng.rand(f).astype(np.float32) + 0.5
        sc, sh = fold_bn(gamma, beta, mean, var, 1e-5)
        dev = scope.find_var(sname).device
        scope.set_var(sname, sc.to(dev))
        scope.set_var(bname, sh.to(dev))
        n += 1
    return n


def _images(rng, n):
    import numpy as np

    return rng.randn(n, 3, RESNET_IMAGE, RESNET_IMAGE).astype(np.float32)


def infer_phase(torch):
    """The main path: save_inference_model, ServingServer (the card),
    load_model with the [1, 2, 4, 8, 16] ladder, 24 concurrent infer
    requests of 1-4 seeded images over RPC. Counters zeroed just before
    the requests and read just after: 53 K5 launches per executed batch,
    0 plain calls. Every answer equals a direct exe.run of its images:
    probabilities within TOL of their max (K5 sums each output in one
    order whatever the batch, but the fc's cuBLAS product may pick
    another kernel for another row count), argmax equal."""
    phase("infer")
    import shutil
    import tempfile

    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.kernels import conv_bn_relu as k5
    from paddle_tpu_torch.observability import tracing
    from paddle_tpu_torch.serving import ServingClient, ServingServer

    t0 = time.perf_counter()
    main, startup, logits, prob = build_resnet50(seed=1)
    build_s = time.perf_counter() - t0
    exe, scope = fluid.Executor(), fluid.Scope()
    if exe.device.type != "cuda":
        raise RuntimeError(f"Executor() chose {exe.device}, not the card")
    exe.run(startup, scope=scope)
    folded = seeded_bn_fold(torch, main, scope, seed=2)
    n_params = sum(int(np.prod(p.shape)) for p in
                   main.global_block().all_parameters())
    log(f"  built {len(main.global_block().ops)} ops in {build_s:.2f} s; "
        f"{n_params} parameter values; {folded} convs' Scale/Shift set "
        f"from fold_bn")
    tmp = tempfile.mkdtemp(prefix="resnet50_")
    srv = ServingServer()
    clients = [ServingClient(srv.serve(), timeout=900.0) for _ in range(8)]
    try:
        t0 = time.perf_counter()
        with fluid.scope_guard(scope):
            fluid.save_inference_model(tmp, ["img"], [prob], exe, main)
        save_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        st = clients[0].load_model("resnet50", tmp, buckets=INFER_BUCKETS)
        load_s = time.perf_counter() - t0
        log(f"  saved in {save_s:.2f} s; load+warm {load_s:.2f} s, "
            f"buckets {st['buckets']}")

        rng = np.random.RandomState(8)
        sizes = [int(x) for x in rng.randint(1, 5, size=24)]
        feeds = [_images(rng, n) for n in sizes]
        results, errors = [None] * 24, []

        def one(i):
            try:
                results[i] = clients[i % 8].infer("resnet50",
                                                  {"img": feeds[i]})
            except Exception as e:  # reported below, fails the phase
                errors.append(f"request {i}: {type(e).__name__}: {e}")

        # the main path's window: counters to 0, the requests, counters
        # read
        batches0 = clients[0].list_models()["resnet50"]["batches"]
        tracing.trace_reset()
        tracing.trace_enable()
        k5.counts.reset()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(24)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(900)
        wall = time.perf_counter() - t0
        launches = k5.counts.kernel_launches[k5.KERNEL]
        plain = k5.counts.plain_calls[k5.KERNEL]
        batches = clients[0].list_models()["resnet50"]["batches"] - batches0
        # the window ends here
        if errors or any(r is None for r in results):
            raise RuntimeError(f"concurrent infer failed: {errors}")
        if launches != CONVS_PER_FORWARD * batches or batches == 0:
            raise RuntimeError(f"K5 launches {launches} != "
                               f"{CONVS_PER_FORWARD} x {batches} batches")
        if plain != 0:
            raise RuntimeError(f"plain version ran {plain} times on the "
                               "card's main path")

        # each answer against a direct run of the same images
        worst = 0.0
        for (out, ver), x in zip(results, feeds):
            (direct,) = exe.run(main, feed={"img": x}, fetch_list=[prob],
                                scope=scope)
            got = out[0]
            if got.shape != (x.shape[0], RESNET_CLASSES) or ver != 1 or \
                    not np.isfinite(got).all():
                raise RuntimeError(f"bad answer {got.shape} v{ver}")
            rel = float(np.abs(got - direct).max() / direct.max())
            if rel > TOL or not np.array_equal(got.argmax(-1),
                                                     direct.argmax(-1)):
                raise RuntimeError(f"served vs direct probabilities: "
                                   f"{rel:.3g} of max, argmax "
                                   f"{got.argmax(-1)} vs "
                                   f"{direct.argmax(-1)}")
            worst = max(worst, rel)
        log(f"  24 requests ({sum(sizes)} images, sizes {sizes}) in "
            f"{wall:.2f} s as {batches} batches: {launches} K5 launches, "
            f"{plain} plain calls; answers vs direct run: worst "
            f"{worst:.3g} of max, argmax equal")

        # steady state at bucket 16 (10 batches), and every bucket once
        # more so each has a compute-time sample
        x16 = _images(rng, INFER_BATCH)
        t0 = time.perf_counter()
        for _ in range(10):
            clients[0].infer("resnet50", {"img": x16})
        steady = time.perf_counter() - t0
        for b in INFER_BUCKETS:
            clients[0].infer("resnet50", {"img": x16[:b]})
        tracing.trace_disable()
        per_bucket = {}
        for ev in tracing.trace_events():
            if ev.get("name") == "serving.batch":
                per_bucket.setdefault(ev["args"]["bucket"], []).append(
                    ev["dur"] / 1e3)
        infer = {
            "config": "resnet50 imagenet fused (conv2d_bn_relu) 224x224x3 "
                      "1000 classes f32, seeded weights, fold_bn "
                      "Scale/Shift",
            "parameters": n_params,
            "build_s": build_s, "save_s": save_s, "load_warm_s": load_s,
            "requests": 24, "images": sum(sizes), "request_sizes": sizes,
            "batch_wall_s": wall, "batches": batches,
            "kernel_launches": launches, "plain_calls": plain,
            "worst_rel_vs_direct": worst,
            "images_per_s_bucket16": 10 * INFER_BATCH / steady,
            "p50_compute_ms_by_bucket": {
                str(b): statistics.median(v)
                for b, v in sorted(per_bucket.items())},
            "batches_by_bucket": {str(b): len(v)
                                  for b, v in sorted(per_bucket.items())},
            "feed_h2d_ms_bucket16": feed_copy_ms(torch, x16),
            "peak_memory_allocated_gb":
                torch.cuda.max_memory_allocated() / 1e9,
        }
        log("  infer " + json.dumps(infer))
        infer["profile"] = profile_infer(torch, clients[1], x16)
        return launches, infer, (main, logits, scope)
    finally:
        for c in clients:
            c.close()
        srv.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)


def feed_copy_ms(torch, x):
    """The executor's host->device copy of one batch's feed (pageable
    numpy -> card), median of 25."""
    times = []
    for _ in range(25):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.as_tensor(x).to("cuda")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_infer(torch, client, x16):
    """One more bucket-16 request under torch.profiler, after the main
    path's counts were read: device time by kernel and the device's busy
    share of the request's wall time. Reporting only. A first request
    runs as the profiler's warm-up step, so the tracer is already
    running when the measured request's feed copy and first K5 launch
    start."""
    from torch.profiler import ProfilerActivity, profile, schedule

    kept = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: kept.append(p.key_averages())
                 ) as prof:
        client.infer("resnet50", {"img": x16})
        prof.step()
        t0 = time.perf_counter()
        client.infer("resnet50", {"img": x16})
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    if not kept:
        raise RuntimeError("profiler kept no trace of the measured request")
    return _device_summary(kept[0], wall_ms, "bucket-16 infer request")


def infer_check_phase(torch, built):
    """ResNet-50 at batch 2, 224x224, on the card (K5) and on the CPU
    (plain version) from the same parameters: logits within TOL of the
    largest |logit|."""
    phase("infer check")
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.kernels import conv_bn_relu as k5

    main, logits, card_scope = built
    cpu_scope = fluid.Scope()
    for n in card_scope.var_names():
        cpu_scope.set_var(n, card_scope.find_var(n).cpu())
    x = _images(np.random.RandomState(9), 2)
    out, counts = {}, {}
    for dev, scope in (("cuda", card_scope), ("cpu", cpu_scope)):
        k5.counts.reset()
        exe = fluid.Executor(fluid.CUDAPlace(0) if dev == "cuda"
                             else fluid.CPUPlace())
        (out[dev],) = exe.run(main, feed={"img": x}, fetch_list=[logits],
                              scope=scope)
        counts[dev] = (k5.counts.kernel_launches[k5.KERNEL],
                       k5.counts.plain_calls[k5.KERNEL])
    if counts != {"cuda": (CONVS_PER_FORWARD, 0),
                  "cpu": (0, CONVS_PER_FORWARD)}:
        raise RuntimeError(f"K5 kernel/plain counts (card, cpu): {counts}")
    lc, lp = out["cuda"], out["cpu"]
    scale = float(np.abs(lp).max())
    rel = float(np.abs(lc - lp).max()) / scale
    if lc.shape != (2, RESNET_CLASSES) or not np.isfinite(lc).all() or \
            rel > TOL:
        raise RuntimeError(f"card vs CPU logits: {rel:.3g} of max |logit| "
                           f"> {TOL} (or not finite)")
    log(f"  resnet50 batch 2: card vs CPU logits max diff {rel:.3g} of "
        f"max |logit| {scale:.4g}; argmax card {lc.argmax(-1)} cpu "
        f"{lp.argmax(-1)}")
    return {"rel_err": rel, "max_abs_logit": scale}


def _kernel_row(name, source, replaces, launches, err, row, **extra):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], **extra}


def main():
    import torch

    name, smi = device_phase(torch)
    build_phase()
    max_err, timings = kernels_phase(torch)
    train_errs, train_rows = train_kernels_phase(torch)
    k5_err, k5_rel, k5_rows, k5_fwd = infer_kernels_phase(torch)
    launches, serve = serve_phase(torch)
    read_ms = host_read_ms(torch)
    log(f"  host logits read [8, 50257] f32: {read_ms:.4f} ms (median)")
    train_launches, train = train_phase(torch)
    check_phase(torch)
    train["check"] = train_check_phase(torch)
    infer_launches, infer, built = infer_phase(torch)
    infer["check"] = infer_check_phase(torch, built)
    del built
    dec = timings["decode"]
    fa_src = "paddle_tpu_torch/csrc/flash_attention.cu"
    fa_py = "paddle_tpu/fluid/ops/pallas_kernels/flash_attention.py"
    train_kernels = [
        _kernel_row("layer_norm_f32", "paddle_tpu_torch/csrc/layer_norm.cu",
                    "paddle_tpu/fluid/ops/pallas_kernels/layer_norm.py:42",
                    train_launches["layer_norm_f32"],
                    train_errs["layer_norm_f32"],
                    train_rows["layer_norm_f32"], train=train),
    ]
    for kname, line in (("flash_fwd_f32", 111), ("flash_bwd_dkdv_f32", 295),
                        ("flash_bwd_dq_f32", 320)):
        rows = train_rows[kname]
        row = dict(rows["full"])
        if kname == "flash_bwd_dq_f32":
            # one library call computes dQ, dK and dV: the K3a row's
            row["library_ms"] = train_rows["flash_bwd_dkdv_f32"]["full"][
                "library_ms"]
            row["library"] = SDPA_LIBRARY
        extra = {key: row[key] for key in ("bound_f32_ms", "bound_peak",
                                           "library")
                 if key in row}
        for key in ("whole_backward", "vs_float64"):
            if key in rows:
                extra[key] = rows[key]
        train_kernels.append(_kernel_row(
            kname, fa_src, f"{fa_py}:{line}", train_launches[kname],
            train_errs[kname], row, shape=row["shape"],
            causal=rows["causal"], **extra))
    infer_kernels = [_kernel_row(
        "conv_bn_relu_f32", "paddle_tpu_torch/csrc/conv_bn_relu.cu",
        "paddle_tpu/fluid/ops/pallas_kernels/conv_bn_relu.py:69",
        infer_launches, k5_err, k5_fwd,
        timed_as=f"sum over the {CONVS_PER_FORWARD} convolutions of one "
                 f"batch-{INFER_BATCH} ResNet-50 forward",
        max_rel_err=k5_rel, shapes=k5_rows, infer=infer)]
    kernels = {"kernels": [{
        "name": "paged_attention",
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/paged_attention.cu",
        "src": "paddle_tpu_torch/csrc/paged_attention.cu",
        "replaces": "paddle_tpu/fluid/ops/pallas_kernels/"
                    "paged_attention.py:268",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": dec["kernel_ms"],
        "kernel_ms": dec["kernel_ms"],
        "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"],
        "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"],
        "shape": "decode B=8 C=1 Hq=Hkv=16 D=64 ps=16 kv_lens "
                 + ",".join(str(x) for x in dec["kv_lens"]),
        "prefill": timings["prefill"],
        "serve": serve,
        "host_logits_read_ms": read_ms,
    }] + train_kernels + infer_kernels}
    print(json.dumps(kernels), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except Exception as e:
        import traceback

        traceback.print_exc()
        print(f"chip_smoke FAILED: {type(e).__name__}: {e}",
              file=sys.stderr, flush=True)
        sys.exit(1)
