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
           prints the seconds and each kernel's ptxas registers, stack
           and spills.
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
           both ways, head_dim 64, 16, 20 and 128), the backward's delta
           pass (flash_delta) within DELTA_RTOL of the largest |delta|;
           K1's bfloat16 form (y within BF16_FLASH_ULPS of the max, mean
           and rstd within 1e-4), and a Fluid program that casts to
           bfloat16 before layer_norm run on the card (one K1 bf16
           launch) and on the CPU, outputs agreeing; K2, K3a and K3b
           twice on the same inputs, bitwise equal; K3a/K3b, the plain
           backward and SDPA's against float64, then K2, the plain
           forward and SDPA's forward (O and LSE) against float64, at
           the train shape and a 4x longer sequence (max abs error,
           recorded, not held); timed at the train phase's shapes beside
           F.layer_norm (float32 and bf16), torch.linalg.vecdot (the
           delta) and SDPA pinned to its memory-efficient backend
           (forward, and its backward alone for K3a + K3b); K2 and SDPA's
           forward, and the port's whole flash backward (delta + K3a +
           K3b) and SDPA's backward, in turns, with their ratios.
  infer kernels
           the same for the fused conv + folded-BN + relu kernel (K5)
           against its plain version (max abs error within 1e-4 of the
           output's max at unit-scale inputs: the JAX tests' four
           shapes with F and K that fit no tile, the 7x7/2 stem, a 1x1/2
           projection, a res5 3x3, relu on and off); an image's output
           bitwise the same alone and at batch 16, and two launches
           bitwise equal; K5, its plain version and F.conv2d (cuDNN,
           TF32 off) + the same epilogue against float64 at three
           batch-16 shapes; timed (K5 and F.conv2d + epilogue in turns,
           the plain version once) at those shapes and summed over the
           53 convolutions of one batch-16 forward, with the ratio.
           K5's bound_ms is its 3xTF32 tensor-core bound (bound_f32_ms
           the CUDA-core one).
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
           flash-forward, 18 delta, 18 dK/dV and 18 dQ launches per step,
           no plain call; the loss finite and falling. The embedding gradient
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
  resnet train
           the Fluid training main path of the image-classification
           models: ResNet-50 ImageNet (as in infer, unfused: 53 conv2d on
           cuDNN + 53 batch_norm), resnet.build_train, Momentum(0.01,
           0.9), batch 32, the startup program run on the card, one
           seeded batch copied to the card once, 5 steps through
           Executor().run. Counters zeroed just before the steps and read
           just after: no plain version ran; the losses finite; every
           running mean and variance moved. The same step twice from the
           same state: bitwise equal loss and scope. Step ms p50,
           images/s, peak memory, the program's op census; steps with
           the deterministic and with cuDNN's default convolution
           algorithms in turns, and whether a default step repeats
           bitwise; one profiled step.
  resnet train check
           one ResNet-50 training step at batch 2 on the card, on the
           CPU and on the CPU in float64, from the same state and feed:
           card vs CPU, the loss within 1e-4 relative and every updated
           running statistic within 1e-4 of its tensor's largest
           |value|. The gradients are not continuous at a relu's kink or
           a max-pool tie, and float32 puts some values on the other
           side (the CPU's float32 gradients miss float64 by ~1-2%), so
           the card's gradients are held against float64: relative L2
           error over all parameters within 3x the CPU float32's, each
           tensor within 0.5 of its max; the largest errors recorded.
  resnet fold
           the trained network's conv filters and fold_bn of its
           batch-norm statistics set into the fused ResNet-50 (53 pairs
           onto 53 conv2d_bn_relu ops); a seeded batch of 16 through it
           (53 K5 launches, no plain call) and through the unfused
           test-mode network: logits within 1e-4 of the largest |logit|.
  amp kernels
           K5's bfloat16 form (conv_bn_relu_bf16, FLAGS['amp']) against
           its plain version (within one bfloat16 ulp of the output's
           largest |value|) at the JAX tests' four shapes, the stem, a
           projection and a res5 3x3 at batch 2, and every distinct
           convolution of a batch-16 ResNet-50 forward (each with its
           plan's body and split); an image's output bitwise the same
           alone and at batch 16, two launches bitwise equal, at res2 3x3
           and at every shape on a wgmma body or split; timed at the 20
           shapes in turns with F.conv2d in bf16 (cuDNN) + the affine and
           relu, summed over the 53 convs; the split combine
           (conv_split_combine_bf16) bitwise against its plain version
           and timed.
  infer amp
           the fused ResNet-50 artifact served over RPC at bucket 16
           under FLAGS['amp']: 53 conv_bn_relu_bf16 launches per batch,
           a conv_split_combine_bf16 launch per split convolution, no
           float32 K5 launch, no plain call; images/s; one profiled
           request (busy share, K5 bf16's device ms); the logits against
           the float32 fused forward of the same artifact.
  resnet train amp
           resnet train under FLAGS['amp'] (bf16 conv2d and fc, float32
           master weights): p50 step ms, images/s, peak memory, no plain
           version, every parameter float32, the same step twice
           bitwise equal, one profiled step; then the trained network
           folded into the fused form and run under amp (53
           conv_bn_relu_bf16 launches) against the unfused test-mode
           network under amp.
  resnet amp check
           one batch-2 ResNet-50 training step under FLAGS['amp'] on the
           card and on the CPU: the loss and every running statistic
           within AMP_CHECK_U bfloat16 steps.
  train amp
           train under FLAGS['amp']: Transformer-base, 5 Adam steps, the
           same launch counts as train (K1-K3b stay float32), the loss
           falling, every parameter float32; p50 step ms, tokens/s.

  bf16 kernels
           the bfloat16 forms of K2, K3a and K3b (flash_fwd_bf16,
           flash_bwd_dkdv_bf16, flash_bwd_dq_bf16: the TPU kernels'
           bfloat16 branch) against their plain bf16 versions: O, dQ, dK,
           dV within BF16_FLASH_ULPS ulp of the tensor's max and at most
           BF16_FLASH_SHARE of the elements differing, LSE within TOL;
           full and causal, Sq != Sk, Sk = 200 and 77, heads of 150 rows,
           head_dim 8, 64, 72, 128, 136, 256, 264 (K3a and K3b up to
           head_dim 64 are the wgmma + TMA kernels; their worst case is
           logged beside the earlier mma.sync kernels'); the delta kernel
           on every case's bf16 dO and O; two launches bitwise equal;
           timed at [BH=128, S=512,
           D=64] full and causal and [BH=8, S=2048 and 4096, D=64]
           causal beside their bounds (the delta too), K2 and the whole
           backward (delta + K3a + K3b) in turns with SDPA's flash
           backend in bf16; the backward wrappers' host time a call.
  flash bf16 bench
           the JAX flash benchmark's configuration through the port's
           flash_attention: bf16 [1, S, 8, 64], S 2048 and 4096, causal,
           forward + backward of sum(out), in turns with the float32
           kernels on the same values (one launch of each bf16 kernel).
  train bf16 attn
           the slice's Fluid path: Transformer-base's self-attention
           layer (x [16, 512, 512], three fc, cast to bf16, causal
           ring_attention, cast back, fc, squared error), Adam(1e-4), 5
           steps on the card: 5 launches of each bf16 kernel and of the
           delta, no f32 flash launch, no plain call; losses against the
           port's CPU route
           and against the same program without the casts.

  fit_a_line
           the data input stack's first path, the verify recipe:
           dataset.uci_housing.train() -> paddle_tpu_torch.batch(20) ->
           fluid.DataFeeder -> fc -> square_error_cost -> SGD(0.01), 5
           epochs on the card and, from the same initial parameters, on
           the CPU executor: losses within 1e-5 relative step by step,
           the last at most a tenth of the first; p50 step ms, steps/s.
  lstm train
           stacked_dynamic_lstm (models/stacked_lstm.py) at full width:
           emb 512, hid 512 (an LSTM of H 128), 3 stacked, imdb's
           5147-word dictionary, 2 classes, Adam(1e-3), batch 32 from
           dataset.imdb.train() through DataFeeder (T pads to 128), 8
           steps on the card and on the CPU from the same parameters:
           losses finite and within LSTM_LOSS_RTOL, the step-1 gradients
           of the LSTM weights within LSTM_GRAD_TOL of their max; p50
           step ms, real words/s, peak memory, one profiled step (busy
           share, largest entries, device launches).
  resnet recordio
           the resnet train phase's ResNet-50 fed by bench.py:583-628's
           in-graph pipeline (open_recordio_file -> multi_pass ->
           batch(32, drop_last) -> double_buffer(2) -> read_file) over a
           recordio file of uint8 images (bench.py:596-612) in the run's
           temporary directory: both passes (10 steps) in turns with
           the same batches fed as numpy dicts to a copy of the same
           state, losses and state bitwise equal; then EOFException,
           reset_reader rewinds; p50 step ms of each feed, and the
           host-to-device copy of a profiled step (its stream, time and
           overlap with kernels on the compute stream).
  No kernel of the port lies on these three paths: their counts are
  zeroed and read around each main path to show no plain version ran.

The kernels and train kernels phases also hold K4 and K2/K3a/K3b at
head_dim above 256 (257, 258, 264, 512) and time them at 264 and 512.

The last lines are the kernels JSON line, the nvidia-smi line and
{"ok": true, "device": {...}}. Every line before the last two is also
written to smoke_out/chip_smoke.log.
"""
import contextlib
import json
import math
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


# every line the script prints also goes to this file (gitignored), whose
# whole text outlives a tail of the output
LOG_PATH = os.path.join(REPO, "smoke_out", "chip_smoke.log")


def log(*a):
    print(*a, flush=True)
    with open(LOG_PATH, "a") as f:
        print(*a, file=f)


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
    ptxas = {name: ptxas_table(_build.ptxas_report(name)) for name in secs}
    for name, table in ptxas.items():
        for fn, row in table.items():
            log(f"  ptxas {name}: {fn} " + json.dumps(row))
    return ptxas


# template arguments of a mangled kernel name: an int or bool literal,
# float, or __nv_bfloat16
_TEMPLATE_ARG = r"L[ib](-?\d+)E|(f)|\d+(__nv_bfloat16)"


def _kernel_name(mangled):
    """``name<args>`` of a mangled ``..._kernel`` entry point: the
    length-prefixed name that ends in ``_kernel``, and the template
    arguments after it (``Li<n>E``, ``Lb<n>E``, ``f`` for float,
    ``13__nv_bfloat16``); the mangled name if there is none."""
    import re

    for i in range(len(mangled)):
        m = re.match(r"\d+", mangled[i:])
        if not m:
            continue
        end = i + m.end()
        name = mangled[end:end + int(m.group())]
        if name.endswith("_kernel") and name[:1].isalpha():
            rest = mangled[end + len(name):]
            # the kernel's own literal arguments, or those of the first
            # class template among its arguments (a Cfg<...> shape)
            args = re.match(rf"I((?:{_TEMPLATE_ARG})+)E", rest) or \
                re.match(rf"IN[^E]*?I((?:{_TEMPLATE_ARG})+)E", rest)
            if not args:
                return name
            vals = [n or ("float" if f else "bf16") for n, f, _ in
                    re.findall(_TEMPLATE_ARG, args.group(1))]
            return f"{name}<{','.join(vals)}>"
    return mangled


def ptxas_table(report):
    """{kernel<template args>: {registers, spill_stores, spill_loads,
    stack}} from what ``nvcc -Xptxas -v`` printed for one library."""
    import re

    out, cur = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = _kernel_name(m.group(1))
            out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[cur].update(stack=int(m.group(1)),
                            spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


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


# cycles of torch.cuda._sleep queued after the L2 flush: ~1 ms at the
# H100's clocks, longer than any wrapper's host work before its launch
QUEUE_SLEEP_CYCLES = 2_000_000


def _time_ms(torch, fn, flush, n=25, warmup=3):
    """Median device ms of one call, L2 flushed before each (the serving
    step reads a layer's pool cold: 23 other layers ran in between). A
    spin kernel queued after the flush keeps the card busy while the
    host prepares the call, so the events time the call's kernels and
    the gaps between them on the card, not the host's Python work
    before its first launch (a wrapper's host time is read apart, see
    ``_host_us``)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        flush.zero_()
        torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def _host_us(torch, fn, n=200):
    """Host microseconds of one call of a wrapper: the wall time of n
    calls queued back to back, then one synchronize, over n (the host's
    Python and launch work where it is longer than the card's)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


# what K4's bound_ms counts: its decode path runs on the CUDA cores, its
# chunk (prefill) path takes Q K^T and P V as 3xTF32 on the tensor cores
PAGED_PEAK = ("bytes over 3.35 TB/s against float32 operations over 67 "
              "TFLOP/s; bound_tf32x3_ms: the products as 3xTF32 (3 x 4D "
              "flops a pair over 495 TFLOP/s) + ~5 float32 flops a pair "
              "over 67 TFLOP/s")


def _bound(case, D):
    """Least time for the function on these inputs: bytes each input
    read once (visible K/V only) and each output written once over HBM
    bandwidth, against its float32 operations over the float32 peak
    (``bound_ms``, ``bound_by``); and the same bytes against the
    products as 3xTF32 on the tensor cores plus ~5 float32 flops a
    (query, key) pair (``bound_tf32x3_ms``, the chunk path's floor)."""
    import numpy as np

    B, Hq, Hkv = case["B"], case["Hq"], case["Hkv"]
    C = case["C"] or 1
    kv = np.asarray(case["kv_lens"], np.int64)
    ql = (np.asarray(case["q_lens"], np.int64) if case["q_lens"] is not None
          else (kv > 0).astype(np.int64))
    kv_bytes = 2 * int(kv.sum()) * Hkv * D * 4
    qo_bytes = 2 * B * C * Hq * D * 4
    idx_bytes = 4 * (B * case["W"] + 2 * B)
    pairs = Hq * sum(int(kv[b] - ql[b] + j + 1) for b in range(B)
                     for j in range(int(ql[b])))
    nbytes = kv_bytes + qo_bytes + idx_bytes
    ms, by = _bound_of(nbytes, 4 * D * pairs)
    t_tc = pairs * (3 * 4 * D / TF32_FLOP_PER_S + 5 / F32_FLOP_PER_S)
    return {"bound_ms": ms, "bound_by": by,
            "bound_tf32x3_ms": max(nbytes / HBM_BYTES_PER_S, t_tc) * 1e3,
            "bound_tf32x3_by": ("bytes" if nbytes / HBM_BYTES_PER_S >= t_tc
                                else "operations"),
            "bound_peak": PAGED_PEAK}


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


def _paged_float64(torch, args, scale=None):
    """The paged-attention function in float64 (the plain version's
    formulas on double copies): the accuracy yardstick."""
    q, kp, vp, tables, kv_lens, q_lens = args
    if q.ndim == 3:
        q, q_lens = q[:, None], (kv_lens > 0).int()
    B, C, Hq, D = q.shape
    ps, Hkv = kp.shape[1], kp.shape[2]
    T = tables.shape[1] * ps
    k = kp.double()[tables.long()].reshape(B, T, Hkv, D)
    v = vp.double()[tables.long()].reshape(B, T, Hkv, D)
    k = k.repeat_interleave(Hq // Hkv, 2)
    v = v.repeat_interleave(Hq // Hkv, 2)
    s = torch.einsum("bchd,bthd->bcht", q.double() * (scale or D ** -0.5), k)
    lane = torch.arange(C, device=q.device)[None, :]
    limit = kv_lens.long()[:, None] - q_lens.long()[:, None] + lane
    t = torch.arange(T, device=q.device)[None, None, :]
    keep = ((t <= limit[:, :, None]) & (lane < q_lens.long()[:, None])
            [:, :, None])[:, :, None, :]
    s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, -1).nan_to_num(0.0)
    o = torch.einsum("bcht,bthd->bchd", p, v)
    return o[:, 0] if args[0].ndim == 3 else o


def _paged_bitwise_checks(torch, pa, rng, base):
    """The kernels' determinism, each a hard check: two launches on the
    same inputs are bitwise equal; slot b launched alone equals slot b
    of the B=8 batch; a decode slot (q_len 1) gives the same bits in a
    C=1 launch and inside a C=64 launch beside prefilling slots (MHA and
    GQA: the per-block path follows the slot's own q_len * rep)."""
    kv8 = [1, 1024, 0, 517, 33, 800, 256, 999]
    checks = []
    for hkv in (16, 4):
        for C, ql in ((None, None), (64, [64, 1, 0, 17, 1, 64, 1, 5])):
            case = dict(base, B=8, C=C, Hq=16, Hkv=hkv,
                        kv_lens=[max(k, q or 0) for k, q in
                                 zip(kv8, ql or [0] * 8)], q_lens=ql)
            args = _paged_case(torch, rng, **case)
            first = pa.paged_attention(*args[:5], q_lens=args[5])
            second = pa.paged_attention(*args[:5], q_lens=args[5])
            if not torch.equal(first, second):
                raise RuntimeError(f"K4 Hkv={hkv} C={C}: two launches "
                                   f"differ")
            for b in range(8):
                alone = pa.paged_attention(
                    args[0][b:b + 1], args[1], args[2], args[3][b:b + 1],
                    args[4][b:b + 1],
                    q_lens=None if args[5] is None else args[5][b:b + 1])
                if not torch.equal(alone[0], first[b]):
                    raise RuntimeError(f"K4 Hkv={hkv} C={C}: slot {b} "
                                       f"alone differs from the batch")
            checks.append(f"Hkv={hkv} C={C}: repeat and 8 slots alone")
            if C is None:
                continue
            # the same slots as a C=1 decode step: q's lane 0, q_len 1
            ones = torch.ones_like(args[5])
            one = pa.paged_attention(args[0][:, :1].contiguous(),
                                     *args[1:5], q_lens=ones)
            dec = [b for b in range(8) if ql[b] == 1]
            for b in dec:
                if not torch.equal(one[b, 0], first[b, 0]):
                    raise RuntimeError(f"K4 Hkv={hkv}: decode slot {b} "
                                       f"differs between C=1 and C=64")
            checks.append(f"Hkv={hkv}: decode slots {dec} C=1 == C=64")
    torch.cuda.synchronize()
    log("  K4 bitwise: " + "; ".join(checks))
    return checks


def kernels_phase(torch):
    """K4 against its plain version on seeded cases (max abs error <=
    TOL, dead rows exactly 0; head_dim 64, 18, 100, 256, 1 and 129, and
    264, 512 and 257 above 256, page sizes 16, 5 and 3, MHA and GQA,
    decode and chunked), the bitwise determinism checks, then timed
    at the serving shapes (decode B=8, the one-slot request B=1, GQA
    decode, a C=64 prefill chunk): the kernel and SDPA on gathered K/V
    in turns, the plain version once, both bounds, and the kernel's,
    the plain version's and SDPA's error against float64."""
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
        # GQA decode at 16 and 8 rows a group (the decode path's limits)
        "gqa16_single": dict(base, B=4, C=None, Hq=16, Hkv=1,
                             kv_lens=[700, 1, 0, 1024], q_lens=None),
        "d18_chunked": dict(base, D=18, B=4, C=8, Hq=4, Hkv=2,
                            kv_lens=[300, 8, 0, 129],
                            q_lens=[8, 3, 0, 1]),
        "d18_single": dict(base, D=18, B=4, C=None, Hq=8, Hkv=8,
                           kv_lens=[300, 8, 0, 1024], q_lens=None),
        "d100_chunked": dict(base, D=100, B=4, C=33, Hq=8, Hkv=4,
                             kv_lens=[500, 33, 0, 1000],
                             q_lens=[33, 20, 0, 1]),
        "d256_chunked": dict(base, D=256, B=3, C=16, Hq=8, Hkv=2,
                             kv_lens=[400, 16, 1024],
                             q_lens=[16, 2, 1]),
        "d256_gqa8_single": dict(base, D=256, B=3, C=None, Hq=8, Hkv=1,
                                 kv_lens=[400, 0, 1024], q_lens=None),
        # head_dim 1 and 129; page sizes that divide no split or tile
        "d1_ps3_chunked": dict(base, D=1, ps=3, W=100, B=3, C=20, Hq=4,
                               Hkv=2, kv_lens=[290, 20, 1],
                               q_lens=[20, 17, 1]),
        "d129_ps5_chunked": dict(base, D=129, ps=5, W=60, B=3, C=7, Hq=6,
                                 Hkv=3, kv_lens=[300, 7, 61],
                                 q_lens=[7, 2, 1]),
        # head_dim above 256: the column-slice path, decode and chunked,
        # MHA and GQA, a head_dim that is not a multiple of 4
        "d264_chunked": dict(base, D=264, B=3, C=20, Hq=4, Hkv=2,
                             kv_lens=[600, 20, 0], q_lens=[20, 5, 0]),
        "d264_gqa4_single": dict(base, D=264, B=3, C=None, Hq=8, Hkv=2,
                                 kv_lens=[1024, 0, 77], q_lens=None),
        "d512_single": dict(base, D=512, B=4, C=None, Hq=4, Hkv=4,
                            kv_lens=[1, 700, 0, 300], q_lens=None),
        "d512_chunked": dict(base, D=512, B=2, C=9, Hq=2, Hkv=1,
                             kv_lens=[513, 9], q_lens=[9, 4]),
        "d257_ps3_chunked": dict(base, D=257, ps=3, W=100, B=2, C=5, Hq=2,
                                 Hkv=1, kv_lens=[290, 5],
                                 q_lens=[5, 1]),
    }
    max_err = 0.0
    errors = {}
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
        errors[name] = err
        log(f"  {name}: max abs err {err:.3g}, {dead.size} dead values "
            f"exactly 0")
    bitwise = _paged_bitwise_checks(torch, pa, rng, base)

    # timings at the serving phase's shapes: decode (C=1) at B=8, the
    # one-slot request (B=1, 1024 keys), GQA decode (Hkv=4) and a
    # prefill chunk (C=64); decode at head_dim 264 and 512; ragged
    # kv_lens 512..1024, all slots live.
    # The kernel and SDPA on gathered K/V in turns (the means of two
    # turns each), the plain version once.
    flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")
    lens = [int(x) for x in rng.randint(512, 1025, size=8)]
    shapes = {
        "decode": dict(base, B=8, C=None, Hq=16, Hkv=16, P=513,
                       kv_lens=lens, q_lens=None),
        "decode_b1": dict(base, B=1, C=None, Hq=16, Hkv=16, P=513,
                          kv_lens=[1024], q_lens=None),
        "decode_gqa4": dict(base, B=8, C=None, Hq=16, Hkv=4, P=513,
                            kv_lens=lens, q_lens=None),
        "prefill": dict(base, B=8, C=64, Hq=16, Hkv=16, P=513,
                        kv_lens=lens, q_lens=[64] * 8),
        # head_dim above 256 (the column-slice path): decode B=8, 4 heads
        "decode_d264": dict(base, D=264, B=8, C=None, Hq=4, Hkv=4, P=513,
                            kv_lens=lens, q_lens=None),
        "decode_d512": dict(base, D=512, B=8, C=None, Hq=4, Hkv=4, P=513,
                            kv_lens=lens, q_lens=None),
    }
    timings = {}
    for name, case in shapes.items():
        args = _paged_case(torch, rng, **case)
        kw = dict(q_lens=args[5])
        kern = lambda: pa.paged_attention(*args[:5], **kw)  # noqa: E731
        lib = _library_call(torch, args, case)
        k_ms, l_ms, turns = _in_turns(torch, kern, lib, flush)
        row = {"kernel_ms": k_ms, "library_ms": l_ms,
               "ratio_kernel_over_sdpa": k_ms / l_ms,
               "turns_ms": {"kernel": turns[0], "sdpa": turns[1]},
               "plain_ms": _time_ms(torch, lambda: pa.paged_attention_reference(
                   *args[:5], **kw), flush)}
        row.update(_bound(case, case["D"]))
        row["host_us"] = _host_us(torch, kern)
        exact = _paged_float64(torch, args)
        row["vs_float64"] = {
            "kernel": (kern() - exact).abs().max().item(),
            "plain": (pa.paged_attention_reference(*args[:5], **kw)
                      - exact).abs().max().item(),
            "sdpa": (lib().transpose(1, 2).reshape(exact.shape)
                     - exact).abs().max().item()}
        row["vs_plain"] = (kern() - pa.paged_attention_reference(
            *args[:5], **kw)).abs().max().item()
        row["kv_lens"] = case["kv_lens"]
        row["shape"] = (f"B={case['B']} C={case['C'] or 1} Hq={case['Hq']} "
                        f"Hkv={case['Hkv']} D={case['D']} ps=16 W=64")
        timings[name] = row
        log(f"  time {name}: " + json.dumps(row))
        del exact
    del flush
    timings["errors"] = errors
    timings["bitwise"] = bitwise
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


def _sdpa(torch, c, causal, heads=N_HEADS, backend="EFFICIENT_ATTENTION"):
    """(forward, backward) calls of SDPA, pinned to one backend (its
    memory-efficient one unless named), on [B, H, S, D] views of a case:
    the yardstick, never used by the port. The backward computes dQ, dK
    and dV from one retained graph."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    s, d = c["q"].shape[1], c["q"].shape[-1]
    b = c["q"].shape[0] // heads
    q4, k4, v4 = (t.reshape(b, heads, s, d).detach().requires_grad_()
                  for t in (c["q"], c["k"], c["v"]))
    do4 = c["do"].reshape(b, heads, s, d)
    pinned = getattr(SDPBackend, backend)

    def fwd():
        with sdpa_kernel(pinned):
            return F.scaled_dot_product_attention(q4, k4, v4,
                                                  is_causal=causal)
    out4 = fwd()

    def bwd():
        with sdpa_kernel(pinned):
            return torch.autograd.grad(out4, (q4, k4, v4), do4,
                                       retain_graph=True)
    return fwd, bwd


def _in_turns(torch, first, second, flush):
    """Two calls timed in turns first, second, second, first (each time
    the median of 25): (first's mean, second's mean, the four times)."""
    times = ([], [])
    for i in (0, 1, 1, 0):
        times[i].append(_time_ms(torch, (first, second)[i], flush))
    return statistics.mean(times[0]), statistics.mean(times[1]), times


def _vs_sdpa_in_turns(torch, port, sdpa, flush, what):
    """The port's call and SDPA's in turns, logged with their ratio."""
    port_ms, sdpa_ms, (tp, ts) = _in_turns(torch, port, sdpa, flush)
    times = {"port": tp, "sdpa": ts}
    log(f"  {what}: port {port_ms:.4f} ms, SDPA efficient {sdpa_ms:.4f} ms, "
        f"ratio {port_ms / sdpa_ms:.3f} (turns {json.dumps(times)})")
    return {"port_ms": port_ms, "sdpa_ms": sdpa_ms,
            "ratio_port_over_sdpa": port_ms / sdpa_ms, "turns_ms": times,
            "library": SDPA_LIBRARY}


def _forward_vs_float64(torch, fa, rng):
    """Max abs error of O and LSE against a float64 forward at the train
    shape and at a 4x longer sequence, full and causal: K2, the plain
    version and SDPA's memory-efficient forward."""
    out = {}
    for bh, s in ((16 * N_HEADS, SEQ), (2 * N_HEADS, 4 * SEQ)):
        for causal in (False, True):
            d = D_MODEL // N_HEADS
            q, k, v = (_randn(torch, rng, bh, s, d) for _ in range(3))
            scale = d ** -0.5
            sc = q.double() @ k.double().transpose(1, 2) * scale
            if causal:
                keep = (torch.arange(s, device=q.device)[:, None]
                        >= torch.arange(s, device=q.device)[None, :])
                sc = sc.masked_fill(~keep, float("-inf"))
            lse = torch.logsumexp(sc, -1)
            o = torch.exp(sc - lse[..., None]) @ v.double()
            del sc
            got = {"kernel": fa._fwd_cuda(q, k, v, causal, scale),
                   "plain": fa.flash_attention_fwd_reference(q, k, v, causal,
                                                             scale)}
            q4, k4, v4 = (x.reshape(bh // N_HEADS, N_HEADS, s, d)
                          for x in (q, k, v))
            # the op behind SDPA's efficient backend, which returns LSE
            efficient = torch.ops.aten._scaled_dot_product_efficient_attention
            o4, l4 = efficient(q4, k4, v4, None, True, 0.0, causal,
                               scale=scale)[:2]
            got["sdpa_efficient"] = (o4.reshape(bh, s, d),
                                     l4.reshape(bh, -1)[:, :s])
            row = {"max_abs_o_lse": [o.abs().max().item(),
                                     lse.abs().max().item()]}
            for who, (go, gl) in got.items():
                row[who] = [(go.double() - o).abs().max().item(),
                            (gl.double() - lse).abs().max().item()]
            key = f"BH={bh} S={s} {'causal' if causal else 'full'}"
            out[key] = row
            log(f"  forward vs float64, {key}: max abs err O/LSE "
                + json.dumps(row))
            del q, k, v, o, lse, got
    torch.cuda.empty_cache()
    return out


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


def _wide_flash_times(torch, fa, rng, dh, flush):
    """K2 and the whole flash backward at [BH=32, S=SEQ, D=dh], each in
    turns with SDPA's memory-efficient call (its time only where SDPA
    takes the head_dim), with the bounds."""
    c = _flash_case(torch, rng, 16 * 2, SEQ, SEQ, dh, False)
    args = (c["q"], c["k"], c["v"], False, c["scale"])
    row = {"shape": f"[BH=32, S={SEQ}, D={dh}] f32 causal=False",
           "bounds": _flash_bounds(32, SEQ, SEQ, dh, False)}

    def port_bwd():  # as _Flash.backward runs it
        delta = fa.flash_delta(c["do"], c["o"])
        return fa.flash_attention_bwd(c["q"], c["k"], c["v"], c["do"],
                                      c["lse"], delta, False, c["scale"])
    try:
        sdpa, sdpa_bwd = _sdpa(torch, c, False, heads=2)
        row["forward"] = _vs_sdpa_in_turns(
            torch, lambda: fa._fwd_cuda(*args), sdpa, flush,
            f"forward (K2) head_dim {dh}")
        row["whole_backward"] = _vs_sdpa_in_turns(
            torch, port_bwd, sdpa_bwd, flush,
            f"whole backward (delta + K3a + K3b) head_dim {dh}")
        del sdpa, sdpa_bwd
    except RuntimeError as e:  # a yardstick only: the port's times stand
        row["sdpa_error"] = f"{type(e).__name__}: {e}"[:300]
        row["forward"] = {"port_ms": _time_ms(
            torch, lambda: fa._fwd_cuda(*args), flush)}
        row["whole_backward"] = {"port_ms": _time_ms(torch, port_bwd,
                                                     flush)}
    # K3a and K3b alone, and the plain versions
    bargs = (c["q"], c["k"], c["v"], c["do"], c["lse"], c["delta"], False,
             c["scale"])
    row["dkdv_ms"] = _time_ms(torch, lambda: fa._bwd_dkdv_cuda(*bargs),
                              flush)
    row["dq_ms"] = _time_ms(torch, lambda: fa._bwd_dq_cuda(*bargs), flush)
    row["plain_fwd_ms"] = _time_ms(
        torch, lambda: fa.flash_attention_fwd_reference(*args), flush)
    row["plain_bwd_ms"] = _time_ms(
        torch, lambda: fa.flash_attention_bwd_reference(*bargs), flush)
    log(f"  head_dim {dh}: " + json.dumps(row))
    return row


# the delta kernel against its plain version: float32 products summed in
# another order, within DELTA_RTOL of the largest |delta|
DELTA_RTOL = 1e-6


def _hold_delta(torch, c, errs):
    """flash_delta on a case's dO and O against the plain version."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    got = fa._delta_cuda(c["do"], c["o"])
    want = fa.flash_delta_reference(c["do"], c["o"])
    err = (got - want).abs().max().item()
    rel = err / max(want.abs().max().item(), 1e-30)
    if got.dtype != torch.float32 or not torch.isfinite(got).all() or \
            rel > DELTA_RTOL:
        raise RuntimeError(f"{fa.DELTA} {tuple(c['do'].shape)} "
                           f"{c['do'].dtype}: max abs err {err:.3g} = "
                           f"{rel:.3g} of the max (> {DELTA_RTOL}?)")
    errs[fa.DELTA] = max(errs.get(fa.DELTA, 0.0), err)
    return rel


def _delta_row(torch, c, flush, what):
    """flash_delta timed beside the plain version (and, in float32, one
    library call of the same function), with its bound: dO and O read,
    delta written, one multiply-add an element."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    do, o = c["do"], c["o"]
    rows, d = do.numel() // do.shape[-1], do.shape[-1]
    row = {
        "ms": _time_ms(torch, lambda: fa._delta_cuda(do, o), flush),
        "plain_ms": _time_ms(
            torch, lambda: fa.flash_delta_reference(do, o), flush),
        "library_ms": None,
        "shape": f"dO, O {list(do.shape)} {what}",
        "host_us": _host_us(torch, lambda: fa._delta_cuda(do[:1], o[:1])),
    }
    if do.dtype == torch.float32:  # one call of the same function
        row["library_ms"] = _time_ms(
            torch, lambda: torch.linalg.vecdot(do, o), flush)
        row["library"] = "torch.linalg.vecdot (float32)"
    else:
        row["library_note"] = ("no single PyTorch call: a bf16 product "
                               "rounds to bf16 before a float32 sum")
    row["bound_ms"], row["bound_by"] = _bound_of(
        2 * rows * d * do.element_size() + 4 * rows, 2 * rows * d)
    return row


def _ln_bf16_program(torch):
    """A Fluid program that casts to bfloat16 before layer_norm (float32
    feed x [TRAIN_BATCH, SEQ, D_MODEL] -> cast -> layer_norm over the last
    axis, bf16 scale and bias -> cast back -> mean), run once on the card
    and once on the CPU from the same startup values: one K1 bf16 launch
    on the card and one plain call on the CPU; the output within
    BF16_FLASH_ULPS of its max with at most BF16_FLASH_SHARE differing,
    the mean within one bf16 ulp of the output's max."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import layers, unique_name
    from paddle_tpu_torch.kernels import layer_norm as ln

    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data(name="x", shape=[SEQ, D_MODEL], dtype="float32")
        y = layers.layer_norm(layers.cast(x, "bfloat16"), begin_norm_axis=2)
        out = layers.cast(y, "float32")
        loss = layers.mean(out)
    feed = {"x": np.random.RandomState(6).randn(
        TRAIN_BATCH, SEQ, D_MODEL).astype(np.float32)}
    got, counts = {}, {}
    for dev in ("cuda", "cpu"):
        exe, scope = fluid.Executor(dev), fluid.Scope()
        exe.run(startup, scope=scope)
        _reset_kernel_counts()
        got[dev] = exe.run(main, feed=feed, fetch_list=[out, loss],
                           scope=scope)
        counts[dev] = (dict(ln.counts.kernel_launches),
                       dict(ln.counts.plain_calls))
    if counts["cuda"][0][ln.KERNEL_BF16] != 1 or \
            any(counts["cuda"][1].values()) or \
            counts["cpu"][1][ln.KERNEL_BF16] != 1:
        raise RuntimeError(f"layer norm bf16 program: counts (card, cpu) "
                           f"{counts}")
    (oc, lc), (op, lp) = got["cuda"], got["cpu"]
    err, ulps, share = _bf16_ulps(torch.from_numpy(oc), torch.from_numpy(op))
    ulp = err / ulps if ulps else 2.0 ** (math.floor(math.log2(
        float(np.abs(op).max()))) - 7)
    loss_err = abs(float(lc[0]) - float(lp[0]))
    if not np.isfinite(oc).all() or ulps > BF16_FLASH_ULPS or \
            share > BF16_FLASH_SHARE or loss_err > ulp:
        raise RuntimeError(f"layer norm bf16 program: card vs CPU output "
                           f"{ulps:.3g} ulps of max, {share:.3g} differing, "
                           f"mean {lc} vs {lp}")
    out = {"x": [TRAIN_BATCH, SEQ, D_MODEL], "ulps_vs_cpu": ulps,
           "differing_vs_cpu": share, "mean_card": float(lc[0]),
           "mean_cpu": float(lp[0]), "launches": counts["cuda"][0]}
    log("  layer norm bf16 program (cast -> layer_norm -> cast -> mean), "
        "card vs CPU: " + json.dumps(out))
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
    errs = {fa.FWD: 0.0, fa.BWD_DKDV: 0.0, fa.BWD_DQ: 0.0, ln.KERNEL: 0.0,
            ln.KERNEL_BF16: 0.0, fa.DELTA: 0.0}

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

    # K1's bfloat16 form: y within BF16_FLASH_ULPS of the plain version's
    # max with at most BF16_FLASH_SHARE of it differing (both round the
    # same float32 value once, summed in other orders); mean and rstd
    # float32 within TOL
    for n, f in ((TRAIN_ROWS, D_MODEL), (37, 24), (5, 1000)):
        x = _randn(torch, rng, n, f).bfloat16()
        s, b = (_randn(torch, rng, f).bfloat16() for _ in range(2))
        got = ln._layer_norm_cuda(x, s, b, 1e-5)
        want = ln.layer_norm_reference(x, s, b, 1e-5)
        torch.cuda.synchronize()
        err, ulps, share = _bf16_ulps(got[0], want[0])
        if got[0].dtype != torch.bfloat16 or ulps > BF16_FLASH_ULPS or \
                share > BF16_FLASH_SHARE:
            raise RuntimeError(f"{ln.KERNEL_BF16} y [{n}, {f}]: "
                               f"{got[0].dtype}, {ulps:.3g} ulps of the "
                               f"max, {share:.3g} of elements differ")
        errs[ln.KERNEL_BF16] = max(errs[ln.KERNEL_BF16], err)
        e = [hold(ln.KERNEL_BF16, name, g, w) for name, g, w in
             zip(("mean", "rstd"), got[1:], want[1:])]
        log(f"  layer_norm bf16 [{n}, {f}]: y {ulps:.3g} ulps of max, "
            f"{share:.3g} differing; max abs err mean/rstd "
            + " / ".join(f"{x:.3g}" for x in e))
    ln_program = _ln_bf16_program(torch)

    # K2, K3a, K3b: causal and not; S not a multiple of the tiles;
    # Sq != Sk both ways (causal with Sq > Sk too); head_dim 64 (the
    # model's), 16, 20 (zero-padded k slice and head_dim tail), 128 (the
    # largest tensor-core bucket), 18 (zero-padded to 20 by the wrapper),
    # 100, 1, and 256, 132 and 129 (the CUDA-core bucket); above 256, the
    # column slices: 264 and 512, and 258 (padded to 260 by the wrapper)
    cases = [(128, SEQ, SEQ, 64, False), (128, SEQ, SEQ, 64, True),
             (6, 40, 40, 64, True), (6, 40, 72, 64, False),
             (6, 40, 72, 64, True), (6, 100, 33, 16, True),
             (6, 100, 33, 16, False), (6, 77, 50, 20, True),
             (6, 50, 77, 20, False), (4, 200, 130, 128, True),
             (4, 130, 200, 128, False), (8, 300, 170, 64, True),
             (6, 77, 50, 18, True), (6, 50, 77, 18, False),
             (4, 90, 90, 100, True), (4, 200, 130, 256, True),
             (4, 130, 200, 256, False), (3, 70, 70, 132, True),
             (4, 33, 45, 1, True), (3, 60, 60, 129, False),
             (4, 200, 130, 264, True), (3, 130, 200, 264, False),
             (3, 90, 70, 512, True), (2, 70, 90, 512, False),
             (2, 50, 50, 258, True)]
    for bh, sq, sk, d, causal in cases:
        c = _flash_case(torch, rng, bh, sq, sk, d, causal)
        args = (c["q"], c["k"], c["v"])
        o, lse = fa._fwd_cuda(*args, causal, c["scale"])
        bargs = args + (c["do"], c["lse"], c["delta"], causal, c["scale"])
        dk, dv = fa._bwd_dkdv_cuda(*bargs)
        dq = fa._bwd_dq_cuda(*bargs)
        rq, rk, rv = fa.flash_attention_bwd_reference(*bargs)
        _hold_delta(torch, c, errs)
        torch.cuda.synchronize()
        e = [hold(fa.FWD, "O", o, c["o"]), hold(fa.FWD, "LSE", lse, c["lse"]),
             hold(fa.BWD_DKDV, "dK", dk, rk), hold(fa.BWD_DKDV, "dV", dv, rv),
             hold(fa.BWD_DQ, "dQ", dq, rq)]
        log(f"  flash bh={bh} sq={sq} sk={sk} d={d} causal={causal}: max "
            f"abs err O/LSE/dK/dV/dQ " + " / ".join(f"{x:.3g}" for x in e))

    # no atomics: two launches on the training shape's inputs give
    # bitwise-equal O, LSE, dK, dV and dQ
    for causal in (False, True):
        c = _flash_case(torch, rng, 16 * N_HEADS, SEQ, SEQ, 64, causal)
        bargs = (c["q"], c["k"], c["v"], c["do"], c["lse"], c["delta"],
                 causal, c["scale"])
        first, second = (
            fa._fwd_cuda(c["q"], c["k"], c["v"], causal, c["scale"])
            + fa._bwd_dkdv_cuda(*bargs) + (fa._bwd_dq_cuda(*bargs),)
            for _ in range(2))
        if not all(torch.equal(x, y) for x, y in zip(first, second)):
            raise RuntimeError(f"K2/K3a/K3b causal={causal}: two launches "
                               f"on the same inputs differ")
    log("  flash forward and backward: two launches bitwise equal (full "
        "and causal)")
    vs_float64 = _backward_vs_float64(torch, fa, rng)
    fwd_vs_float64 = _forward_vs_float64(torch, fa, rng)

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
    xb, sb, bb = x.bfloat16(), s.bfloat16(), b.bfloat16()
    rows[ln.KERNEL_BF16] = {
        "ms": _time_ms(torch, lambda: ln._layer_norm_cuda(xb, sb, bb, 1e-5),
                       flush),
        "plain_ms": _time_ms(torch, lambda: ln.layer_norm_reference(
            xb, sb, bb, 1e-5), flush),
        "library_ms": _time_ms(torch, lambda: F.layer_norm(
            xb, (f,), sb, bb, 1e-5), flush),
        "library": "F.layer_norm on bf16 (y only)",
        "shape": f"x [{n}, {f}] bf16",
        "host_us": _host_us(torch, lambda: ln._layer_norm_cuda(
            xb[:4], sb, bb, 1e-5)),
        "program": ln_program,
    }
    rows[ln.KERNEL_BF16]["bound_ms"], rows[ln.KERNEL_BF16]["bound_by"] = \
        _bound_of((2 * n * f + 2 * f) * 2 + 2 * n * 4, 8 * n * f)

    bh, d = 16 * N_HEADS, D_MODEL // N_HEADS
    backward, forward = {}, {}
    for causal in (False, True):
        c = _flash_case(torch, rng, bh, SEQ, SEQ, d, causal)
        args = (c["q"], c["k"], c["v"], causal, c["scale"])
        bargs = (c["q"], c["k"], c["v"], c["do"], c["lse"], c["delta"],
                 causal, c["scale"])
        sdpa, sdpa_bwd = _sdpa(torch, c, causal)
        bounds = _flash_bounds(bh, SEQ, SEQ, d, causal)
        if not causal:
            rows[fa.DELTA] = _delta_row(torch, c, flush, "f32")
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
        def port_bwd():  # as _Flash.backward runs it
            delta = fa.flash_delta(c["do"], c["o"])
            return fa.flash_attention_bwd(c["q"], c["k"], c["v"], c["do"],
                                          c["lse"], delta, causal,
                                          c["scale"])
        key = "causal" if causal else "full"
        backward[key] = _vs_sdpa_in_turns(
            torch, port_bwd, sdpa_bwd, flush,
            f"whole backward (delta + K3a + K3b) causal={causal}")
        forward[key] = _vs_sdpa_in_turns(
            torch, lambda: fa._fwd_cuda(*args), sdpa, flush,
            f"forward (K2) causal={causal}")
        del sdpa, sdpa_bwd
    # head_dim 256 (d_model 512 with 2 heads): the CUDA-core bucket; 264
    # and 512 above it, in 256-column slices: forward and whole backward
    # in turns with SDPA's
    for dh in (256, 264, 512):
        rows[fa.FWD][f"head_dim_{dh}"] = _wide_flash_times(torch, fa, rng,
                                                            dh, flush)
    del flush
    rows[fa.BWD_DKDV]["whole_backward"] = backward
    rows[fa.BWD_DKDV]["vs_float64"] = vs_float64
    rows[fa.FWD]["in_turns"] = forward
    rows[fa.FWD]["vs_float64"] = fwd_vs_float64
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
    events = prof.key_averages()
    out = _device_summary(events, wall_ms, "decode request")
    # K4's share: its split and merge kernels
    k4 = [ev for ev in events
          if str(getattr(ev, "device_type", "")).endswith("CUDA")
          and ("paged_split_kernel" in ev.key
               or "paged_merge_kernel" in ev.key)]
    out["k4_device_ms"] = sum(
        getattr(ev, "self_device_time_total",
                getattr(ev, "self_cuda_time_total", 0.0))
        for ev in k4) / 1e3
    out["k4_launches"] = sum(ev.count for ev in k4)
    log(f"  profile decode request: K4 {out['k4_device_ms']:.3f} ms of "
        f"{out['device_busy_ms']:.3f} ms device busy "
        f"({out['k4_launches']} kernel launches)")
    return out


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
    """(launches, plain calls) of every kernel of the port, by name."""
    from paddle_tpu_torch.kernels import conv_bn_relu as k5
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import layer_norm as ln
    from paddle_tpu_torch.kernels import paged_attention as pa

    launches, plain = {}, {}
    for tally in (ln.counts, fa.counts, fa.counts_bf16, fa.counts_delta,
                  pa.counts, k5.counts):
        launches.update(tally.kernel_launches)
        plain.update(tally.plain_calls)
    return launches, plain


def _reset_kernel_counts():
    from paddle_tpu_torch.kernels import conv_bn_relu as k5
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import layer_norm as ln
    from paddle_tpu_torch.kernels import paged_attention as pa

    for tally in (ln.counts, fa.counts, fa.counts_bf16, fa.counts_delta,
                  pa.counts, k5.counts):
        tally.reset()


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
            "flash_bwd_dkdv_f32": 18, "flash_bwd_dq_f32": 18,
            "flash_delta": 18}
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


def _device_summary(events, wall_ms, what, part=None):
    """Device time by entry of a profiler's ``key_averages()``; with
    ``part`` (name substrings), also the device ms of the entries whose
    name holds one of them (``part_ms``)."""
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
    if part:
        out["part"] = list(part)
        out["part_ms"] = sum(us for k, us, _ in rows
                             if any(p in k for p in part)) / 1e3
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
                "flash_bwd_dkdv_f32": 6, "flash_bwd_dq_f32": 6,
                "flash_delta": 6}
    zero = dict.fromkeys(deltas["cuda"][0], 0)
    if deltas["cuda"] != ({**zero, **per_step}, zero) or \
            deltas["cpu"] != (zero, {**zero, **per_step}):
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


# --- resnet train: ResNet-50 training through the Fluid Executor --------

def logits_var(program):
    """The name of the logits of an image-classification program: the
    input of its softmax."""
    return [op for op in program.global_block().ops
            if op.type == "softmax"][-1].input("X")[0]


def fold_trained_network(trained, scope, fused, fused_scope):
    """Fill the fused inference program's parameters from a trained
    network of the same model function (resnet.py builds the two forms
    one to one): in program order, each conv2d + batch_norm pair gives one
    conv2d_bn_relu op its Filter, and fold_bn of the batch norm's scale,
    bias and running mean and variance its Scale/Shift; every other
    parameter (the fc's) copies by name. Returns the number of pairs."""
    from paddle_tpu_torch.kernels.conv_bn_relu import fold_bn

    ops = trained.global_block().ops
    bn_of = {op.input("X")[0]: op for op in ops if op.type == "batch_norm"}
    pairs = [(op, bn_of[op.output("Output")[0]]) for op in ops
             if op.type == "conv2d"]
    convs = [op for op in fused.global_block().ops
             if op.type == "conv2d_bn_relu"]
    if len(pairs) != len(convs):
        raise RuntimeError(f"{len(pairs)} conv2d + batch_norm pairs "
                           f"against {len(convs)} conv2d_bn_relu ops")

    def value(op, slot):
        return scope.find_var(op.input(slot)[0])

    def put(name, t):
        old = fused_scope.find_var(name)
        if tuple(old.shape) != tuple(t.shape):
            raise RuntimeError(f"{name}: {tuple(t.shape)} into "
                               f"{tuple(old.shape)}")
        fused_scope.set_var(name, t.to(old.device))

    folded = set()
    for (conv, bn), op in zip(pairs, convs):
        sc, sh = fold_bn(value(bn, "Scale"), value(bn, "Bias"),
                         value(bn, "Mean"), value(bn, "Variance"),
                         float(bn.attr("epsilon")))
        for slot, t in (("Filter", value(conv, "Filter")), ("Scale", sc),
                        ("Shift", sh)):
            put(op.input(slot)[0], t)
            folded.add(op.input(slot)[0])
    for p in fused.global_block().all_parameters():
        if p.name not in folded:
            put(p.name, scope.find_var(p.name))
    return len(pairs)


# the resnet train phase: ResNet-50 ImageNet as in the infer phase, with
# Momentum(0.01, 0.9) at batch 32 (bench.py:80, :625-636), 5 steps on one
# seeded batch as bench.py's --use_fake_data
RESNET_TRAIN_BATCH, RESNET_TRAIN_STEPS, RESNET_LR = 32, 5, 0.01
# resnet train check: the card's gradients against float64 may err this
# many times the CPU float32's (relative L2 over all parameters), and no
# tensor by more than GRAD_TENSOR_MAX of its max (see the phase)
GRAD_FACTOR, GRAD_TENSOR_MAX = 3, 0.5


def build_resnet50_train(seed):
    """The port's ResNet-50 training program, seeded: (main, startup,
    test, cost, acc, params_grads); ``test`` is the for_test clone taken
    before Momentum.minimize (the unfused inference network)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import layers, unique_name
    from paddle_tpu_torch.models import resnet

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with unique_name.guard(), fluid.program_guard(main, startup):
        img = layers.data(name="img",
                          shape=[3, RESNET_IMAGE, RESNET_IMAGE],
                          dtype="float32")
        label = layers.data(name="label", shape=[1], dtype="int64")
        cost, acc, _ = resnet.build_train(img, label,
                                          class_dim=RESNET_CLASSES, depth=50)
        test = main.clone(for_test=True)
        _, pg = fluid.optimizer.Momentum(
            learning_rate=RESNET_LR, momentum=0.9).minimize(cost)
    return main, startup, test, cost, acc, pg


def _bn_stats(program):
    """[(running mean, running variance)] names, in program order."""
    return [(op.output("MeanOut")[0], op.output("VarianceOut")[0])
            for op in program.global_block().ops if op.type == "batch_norm"]


def _scope_copy(fluid, scope):
    out = fluid.Scope()
    for n in scope.var_names():
        out.set_var(n, scope.find_var(n).clone())
    return out


def _same_state(torch, a, b):
    """Names whose tensors differ in any bit between two scopes."""
    return [n for n in a.var_names()
            if not torch.equal(a.find_var(n), b.find_var(n))]


def _one_step(exe, main, feed, cost, scope):
    import numpy as np

    (loss,) = exe.run(main, feed=feed, fetch_list=[cost], scope=scope)
    return float(np.asarray(loss).reshape(-1)[0])


def resnet_train_phase(torch):
    """The Fluid training main path: ResNet-50 ImageNet at full width,
    Momentum(0.01, 0.9), batch 32, the startup program run on the card,
    one seeded batch copied to the card once, 5 steps. Counters zeroed
    just before the steps and read just after: no plain version of any
    kernel ran (this path runs none of K1-K5: its convolutions are
    cuDNN's, as the JAX package leaves them to XLA). The losses finite,
    every running mean and variance moved off its initial value. Then
    from the state after the steps: the same step twice, bitwise equal
    in loss and every scope tensor; steps with the convolutions' cuDNN
    algorithms restricted to the deterministic ones (the port's choice)
    and with cuDNN's default choice, 3 each in turns, timed, and whether
    a default step repeats bitwise (recorded, not held); one step under
    torch.profiler."""
    phase("resnet train")
    import contextlib

    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.ops import nn_ops

    t0 = time.perf_counter()
    main, startup, test, cost, acc, pg = build_resnet50_train(seed=3)
    build_s = time.perf_counter() - t0
    exe, scope = fluid.Executor(), fluid.Scope()
    if exe.device.type != "cuda":
        raise RuntimeError(f"Executor() chose {exe.device}, not the card")
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    ops = [op.type for op in main.global_block().ops]
    census = {
        "ops": len(ops),
        "forward": sum(1 for t in ops[:ops.index("fill_constant")]
                       if t != "assign"),
        "grad": sum(1 for t in ops if t.endswith("_grad")),
        "grad_sums": ops.count("sum"),
        "momentum": ops.count("momentum"),
        "assign": ops.count("assign"),
        "conv2d": ops.count("conv2d"), "batch_norm": ops.count("batch_norm"),
    }
    if (census["conv2d"], census["batch_norm"], census["momentum"]) != \
            (CONVS_PER_FORWARD, CONVS_PER_FORWARD, len(pg)):
        raise RuntimeError(f"ResNet-50 train program census {census}")
    n_params = sum(int(np.prod(p.shape)) for p in
                   main.global_block().all_parameters())
    log(f"  built {len(ops)} ops in {build_s:.2f} s; startup "
        f"({len(startup.global_block().ops)} ops) on the card in "
        f"{startup_s:.2f} s; {n_params} parameter values, {len(pg)} "
        f"trained; census {json.dumps(census)}")
    stats = _bn_stats(main)
    initial = {n: scope.find_var(n).clone() for pair in stats for n in pair}

    rng = np.random.RandomState(0)
    x = rng.randn(RESNET_TRAIN_BATCH, 3, RESNET_IMAGE,
                  RESNET_IMAGE).astype(np.float32)
    y = rng.randint(0, RESNET_CLASSES, (RESNET_TRAIN_BATCH, 1))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feed = {"img": torch.from_numpy(x).cuda(),
            "label": torch.from_numpy(y.astype(np.int64)).cuda()}
    torch.cuda.synchronize()
    feed_ms = (time.perf_counter() - t0) * 1e3

    # the main path's window: counters to 0, the steps, counters read
    torch.cuda.reset_peak_memory_stats()
    _reset_kernel_counts()
    losses, accs, step_ms = [], [], []
    for _ in range(RESNET_TRAIN_STEPS):
        t0 = time.perf_counter()
        loss, a = exe.run(main, feed=feed, fetch_list=[cost, acc],
                          scope=scope)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(np.asarray(loss).reshape(-1)[0]))
        accs.append(float(np.asarray(a).reshape(-1)[0]))
    launches, plain = _kernel_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the window ends here
    if any(plain.values()):
        raise RuntimeError(f"plain versions ran on the card's main path: "
                           f"{plain}")
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"losses not finite: {losses}")
    still = [n for n, t in initial.items()
             if torch.equal(scope.find_var(n), t)]
    if still:
        raise RuntimeError(f"{len(still)} running statistics never moved, "
                           f"e.g. {still[:3]}")
    p50 = statistics.median(step_ms[1:])
    train = {
        "config": "resnet-50 imagenet 224x224x3 1000 classes f32, "
                  "momentum 0.01/0.9, fake data (one seeded batch)",
        "batch": RESNET_TRAIN_BATCH, "steps": RESNET_TRAIN_STEPS,
        "losses": losses, "accuracies": accs, "step_ms": step_ms,
        "p50_step_ms_after_first": p50,
        "images_per_s": RESNET_TRAIN_BATCH / (p50 / 1e3),
        "peak_memory_allocated_gb": peak_gb, "feed_copy_ms": feed_ms,
        "build_s": build_s, "startup_s": startup_s, "census": census,
        "kernel_launches": launches, "plain_calls": plain,
        "running_stats_moved": 2 * len(stats),
    }
    log("  resnet train " + json.dumps(train))

    # the same step from the same state, twice: bitwise equal
    after = _scope_copy(fluid, scope)
    runs = []
    for _ in range(2):
        s = _scope_copy(fluid, after)
        runs.append((_one_step(exe, main, feed, cost, s), s))
    differ = _same_state(torch, runs[0][1], runs[1][1])
    if runs[0][0] != runs[1][0] or differ:
        raise RuntimeError(f"the same step twice: losses {runs[0][0]!r} "
                           f"{runs[1][0]!r}; {len(differ)} scope tensors "
                           f"differ, e.g. {differ[:3]}")
    log(f"  the same step twice from the same state: loss "
        f"{runs[0][0]!r}, {len(after.var_names())} scope tensors bitwise "
        f"equal")
    del runs

    # the convolutions with cuDNN's default algorithm choice against the
    # deterministic ones, in turns (3 steps each), and whether a default
    # step repeats bitwise (recorded)
    saved = nn_ops._conv_algorithms

    def default_choice(x):
        return contextlib.nullcontext()

    turns = {"deterministic": [], "default": []}
    s = _scope_copy(fluid, after)
    try:
        for order in (("deterministic", "default"),
                      ("default", "deterministic"),
                      ("deterministic", "default")):
            for mode in order:
                nn_ops._conv_algorithms = saved if mode == "deterministic" \
                    else default_choice
                t0 = time.perf_counter()
                _one_step(exe, main, feed, cost, s)
                turns[mode].append((time.perf_counter() - t0) * 1e3)
        nn_ops._conv_algorithms = default_choice
        again = [_scope_copy(fluid, after) for _ in range(2)]
        free_losses = [_one_step(exe, main, feed, cost, t) for t in again]
        free_differ = _same_state(torch, *again)
    finally:
        nn_ops._conv_algorithms = saved
    del s, again
    train["cudnn_algorithms_in_turns"] = {
        "step_ms": turns,
        "p50_step_ms": {k: statistics.median(v) for k, v in turns.items()},
        "default_repeats_bitwise": free_losses[0] == free_losses[1]
        and not free_differ,
        "default_tensors_differing": len(free_differ),
    }
    log("  cuDNN algorithms, in turns " +
        json.dumps(train["cudnn_algorithms_in_turns"]))
    train["profile"] = profile_step(torch, exe, main, feed, cost,
                                    _scope_copy(fluid, after))
    del after
    return train, (main, test, cost, pg, scope)


def resnet_train_check_phase(torch, trained):
    """One ResNet-50 training step at full width, batch 2, 224x224, from
    the same state (the trained scope copied as numpy arrays) and the
    same feed, on the card, on the CPU, and on the CPU in float64. Card
    against CPU: the loss within TOL relative, every updated running mean
    and variance within TOL of its tensor's largest |value|.

    The parameter gradients cannot be held to TOL: a forward value
    within float32 rounding of a relu's kink (or a max-pool tie) takes
    the other side in another summation order, and the gradient is not
    continuous there. The CPU's own float32 gradients miss float64 by
    ~1-2% (relative L2 over all parameters) and by up to ~25% of one
    tensor's max, the last stage's most (few positions a channel). So
    they are held against float64: the card's relative L2 error over all
    parameters within GRAD_FACTOR times the CPU float32's, each tensor
    within GRAD_TENSOR_MAX of its max (a wrong gradient errs by ~100%).
    The largest errors are recorded."""
    phase("resnet train check")
    import numpy as np

    import paddle_tpu_torch.fluid as fluid

    main, _, cost, pg, card_trained = trained
    arrays = {n: card_trained.find_var(n).cpu().numpy()
              for n in card_trained.var_names()}
    rng = np.random.RandomState(4)
    feed = {"img": rng.randn(2, 3, RESNET_IMAGE,
                             RESNET_IMAGE).astype(np.float32),
            "label": rng.randint(0, RESNET_CLASSES, (2, 1)).astype(np.int64)}
    stats = [n for pair in _bn_stats(main) for n in pair]
    out, secs, scopes = {}, {}, {}
    for run, dev, dtype in (("cuda", "cuda", np.float32),
                            ("cpu", "cpu", np.float32),
                            ("cpu64", "cpu", np.float64)):
        scopes[run] = fluid.Scope()
        fluid.params_from_jax(
            {n: a.astype(dtype) if a.dtype == np.float32 else a
             for n, a in arrays.items()}, scopes[run], device=dev)
        _reset_kernel_counts()
        exe = fluid.Executor(fluid.CUDAPlace(0) if dev == "cuda"
                             else fluid.CPUPlace())
        t0 = time.perf_counter()
        out[run] = [np.asarray(v, np.float64) for v in exe.run(
            main, feed=dict(feed, img=feed["img"].astype(dtype)),
            fetch_list=[cost] + [g for _, g in pg], scope=scopes[run])]
        secs[run] = time.perf_counter() - t0
        if any(_kernel_counts()[1].values()):
            raise RuntimeError(f"a plain version ran on {run}")
    lc, lp, l64 = (float(out[r][0][0]) for r in ("cuda", "cpu", "cpu64"))
    if not np.isfinite(lc) or abs(lc - lp) > TOL * abs(lp):
        raise RuntimeError(f"loss card {lc} vs cpu {lp}")

    def rel(got, want):
        scale = float(np.abs(want).max())
        return float(np.abs(got - want).max()) / scale if scale else \
            float(np.abs(got).max())

    grads = {r: out[r][1:] for r in out}
    per = [(p.name, rel(gc, g64), rel(gp, g64), rel(gc, gp))
           for (p, _), gc, gp, g64 in zip(pg, grads["cuda"], grads["cpu"],
                                          grads["cpu64"])]

    def l2(run):
        num = sum(float(np.square(g - w).sum())
                  for g, w in zip(grads[run], grads["cpu64"]))
        den = sum(float(np.square(w).sum()) for w in grads["cpu64"])
        return (num / den) ** 0.5

    stat_err = [(n, rel(scopes["cuda"].find_var(n).cpu().numpy(),
                        scopes["cpu"].find_var(n).numpy())) for n in stats]
    worst = {key: max(((e[i], e[0]) for e in per), default=None)
             for i, key in ((1, "grad_card_vs_f64"), (2, "grad_cpu_vs_f64"),
                            (3, "grad_card_vs_cpu"))}
    worst["stat_card_vs_cpu"] = max((e, n) for n, e in stat_err)
    # the five gradients whose card error is the largest multiple of the
    # CPU float32's: (card vs f64, cpu vs f64, name)
    worst["grad_ratio_top5"] = sorted(
        ((e[1], e[2], e[0]) for e in per),
        key=lambda t: -t[0] / max(t[1], 1e-30))[:5]
    check = {"loss_card": lc, "loss_cpu": lp, "loss_cpu_f64": l64,
             "grads": len(pg), "stats": len(stats), "worst": worst,
             "grad_l2_rel_err_vs_f64": {"card": l2("cuda"), "cpu": l2("cpu")},
             "cpu_step_s": secs["cpu"], "cpu_f64_step_s": secs["cpu64"]}
    log("  resnet50 batch 2 card vs cpu " + json.dumps(check))
    l2_card, l2_cpu = (check["grad_l2_rel_err_vs_f64"][k]
                       for k in ("card", "cpu"))
    if not l2_card <= GRAD_FACTOR * l2_cpu + 1e-6:
        raise RuntimeError(f"gradients: card vs float64 {l2_card:.3g} "
                           f"(relative L2 over all parameters), more than "
                           f"{GRAD_FACTOR}x the CPU float32's {l2_cpu:.3g}")
    for name, e_card, _, _ in per:
        if not e_card <= GRAD_TENSOR_MAX:
            raise RuntimeError(f"gradient of {name}: card vs float64 "
                               f"{e_card:.3g} of max > {GRAD_TENSOR_MAX}")
    for n, r in stat_err:
        if r > TOL:
            raise RuntimeError(f"running statistic {n}: card vs cpu {r:.3g}"
                               f" of max > {TOL}")
    return check


def resnet_fold_phase(torch, trained):
    """The trained network served through K5: fold_bn of each conv2d +
    batch_norm pair's statistics into the fused program that
    resnet_imagenet(depth=50, is_test=True, fused=True) builds (53 pairs
    against 53 conv2d_bn_relu ops), then a seeded batch of 16 through the
    fused program (counters zeroed just before and read just after: 53
    K5 launches, no plain call) and through the unfused test-mode
    network (cuDNN conv + batch_norm is_test): logits within TOL of the
    largest |logit|."""
    phase("resnet fold")
    import numpy as np

    import paddle_tpu_torch.fluid as fluid

    _, test, _, _, scope = trained
    fused, fstartup, flogits, _ = build_resnet50(seed=1)
    exe, fscope = fluid.Executor(), fluid.Scope()
    exe.run(fstartup, scope=fscope)
    pairs = fold_trained_network(test, scope, fused, fscope)
    if pairs != CONVS_PER_FORWARD:
        raise RuntimeError(f"{pairs} folded pairs, want {CONVS_PER_FORWARD}")
    rng = np.random.RandomState(10)
    x = _images(rng, INFER_BATCH)
    label = np.zeros((INFER_BATCH, 1), np.int64)
    _reset_kernel_counts()
    (got,) = exe.run(fused, feed={"img": x}, fetch_list=[flogits],
                     scope=fscope)
    launches, plain = _kernel_counts()
    if launches["conv_bn_relu_f32"] != CONVS_PER_FORWARD or \
            any(plain.values()):
        raise RuntimeError(f"fused forward: launches {launches}, plain "
                           f"{plain}")
    (want,) = exe.run(test, feed={"img": x, "label": label},
                      fetch_list=[logits_var(test)], scope=scope)
    scale = float(np.abs(want).max())
    rel = float(np.abs(got - want).max()) / scale
    if got.shape != (INFER_BATCH, RESNET_CLASSES) or \
            not np.isfinite(got).all() or rel > TOL:
        raise RuntimeError(f"fused vs unfused logits: {rel:.3g} of max "
                           f"|logit| > {TOL} (or not finite)")
    fold = {"pairs": pairs, "launches": launches["conv_bn_relu_f32"],
            "rel_err": rel, "max_abs_logit": scale,
            "argmax_equal": bool((got.argmax(-1) == want.argmax(-1)).all())}
    log("  resnet fold " + json.dumps(fold))
    return fold


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
    """(bytes, product flops, epilogue flops) of one fused conv: x, w,
    scale and shift read once and y written once; 2*M*K*F flops of the
    product and 3 a value for the affine and relu."""
    oh, ow = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    m, kk = n * oh * ow, c * k * k
    return (4 * (n * c * h * w + f * kk + 2 * f + n * f * oh * ow),
            2 * m * kk * f, 3 * m * f)


# what K5's operations are timed against in ``bound_ms``: the same peak
# as the flash kernels' (FLASH_PEAK)
CONV_PEAK = ("product as 3xTF32 on the tensor cores (3 x 2MKF over 495 "
             "TFLOP/s TF32 dense) + 3MF epilogue flops over 67 TFLOP/s")


def _conv_bounds(*shape):
    """Least time for one fused conv: the bytes over HBM bandwidth
    against the product as 3xTF32 on the tensor cores (three TF32
    products over the TF32 peak, the card's fastest float32-accurate
    product) plus the epilogue over the float32 peak: ``bound_ms``.
    ``bound_f32_ms`` counts every flop over the float32 peak (the
    CUDA-core floor of a scalar kernel)."""
    nbytes, prod, epi = _conv_work(*shape)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 3 * prod / TF32_FLOP_PER_S + epi / F32_FLOP_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_f32_ms": _bound_of(nbytes, prod + epi)[0]}


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


def _conv_vs_float64(torch, k5, rng):
    """Max abs error of K5, its plain version and F.conv2d (cuDNN, TF32
    off) + the epilogue against the same function in float64, at three
    batch-16 shapes: the stem, a res2 3x3 and a res5 1x1."""
    import torch.nn.functional as F

    out = {}
    b = INFER_BATCH
    for name, shape in (("stem 7x7/2 3->64", (b, 3, 224, 224, 64, 7, 2, 3,
                                              True)),
                        ("res2 3x3 64->64", (b, 64, 56, 56, 64, 3, 1, 1,
                                             True)),
                        ("res5 1x1 512->2048", (b, 512, 7, 7, 2048, 1, 1, 0,
                                                False))):
        args = _conv_case(torch, rng, *shape)
        x, w, sc, sh, st, pd, relu = args
        exact = F.conv2d(x.double(), w.double(), stride=st, padding=pd) \
            * sc.double()[None, :, None, None] \
            + sh.double()[None, :, None, None]
        if relu:
            exact = torch.relu(exact)
        got = {"kernel": k5._conv_cuda(*args),
               "plain": k5.fused_conv_bn_relu_reference(*args),
               "cudnn_f32": _conv_library(torch, *args)()}
        row = {"max_abs_y": exact.abs().max().item()}
        row.update({who: (y.double() - exact).abs().max().item()
                    for who, y in got.items()})
        out[name] = row
        log(f"  conv vs float64, {name} batch {b}: max abs err "
            + json.dumps(row))
        del exact, got, args
    torch.cuda.empty_cache()
    return out


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
    # an image's rows are bitwise the same alone and inside a batch of
    # 16; no atomics: two launches give bitwise-equal outputs
    args = _conv_case(torch, rng, INFER_BATCH, 64, 56, 56, 64, 3, 1, 1,
                      True)
    whole = k5._conv_cuda(*args)
    alone = k5._conv_cuda(args[0][5:6].contiguous(), *args[1:])
    if not torch.equal(whole[5:6], alone):
        raise RuntimeError("K5: an image's output differs between batch "
                           "16 and batch 1")
    if not torch.equal(whole, k5._conv_cuda(*args)):
        raise RuntimeError("K5: two launches on the same inputs differ")
    log("  conv res2 3x3: image 5 bitwise equal at batch 16 and alone; "
        "two launches bitwise equal")
    vs_float64 = _conv_vs_float64(torch, k5, rng)

    flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")

    def timed(shape):
        """Times K5 and the library call in turns (K5, library, library,
        K5) and the plain version once on one shape, after holding K5
        against the plain version there."""
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
        row = dict(zip(("ms", "library_ms"), _in_turns(
            torch, lambda: k5._conv_cuda(*args),
            _conv_library(torch, *args), flush)))
        row["plain_ms"] = _time_ms(
            torch, lambda: k5.fused_conv_bn_relu_reference(*args), flush)
        row.update(_conv_bounds(*shape))
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
    fwd = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms",
                         "bound_f32_ms"), 0.0)
    nbytes = prod = epi = 0
    by_shape = []
    for shape, n in census.items():
        row = timed(shape)
        for key in fwd:
            fwd[key] += n * row[key]
        by_shape.append({"shape": list(shape), "count": n,
                         **{k: row[k] for k in ("ms", "library_ms",
                                                "bound_ms")}})
        work = _conv_work(*shape)
        nbytes, prod, epi = (nbytes + n * work[0], prod + n * work[1],
                             epi + n * work[2])
    t_ops = 3 * prod / TF32_FLOP_PER_S + epi / F32_FLOP_PER_S
    fwd["bound_by"] = ("bytes" if nbytes / HBM_BYTES_PER_S >= t_ops
                       else "operations")
    fwd["bound_peak"] = CONV_PEAK
    fwd["ratio_port_over_cudnn"] = fwd["ms"] / fwd["library_ms"]
    fwd["library"] = ("F.conv2d (cuDNN, TF32 off) + the affine and relu; "
                      "each shape timed in turns K5, library, library, K5")
    fwd["vs_float64"] = vs_float64
    fwd["by_shape"] = by_shape
    fwd["distinct_shapes"] = len(census)
    fwd["convs"] = CONVS_PER_FORWARD
    fwd["gflop"] = (prod + epi) / 1e9
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


def profile_infer(torch, client, x16, model="resnet50", part=None,
                  what="bucket-16 infer request"):
    """One more bucket-16 request under torch.profiler, after the main
    path's counts were read: device time by kernel and the device's busy
    share of the request's wall time (and the device ms of the kernels
    named by ``part``). Reporting only. A first request runs as the
    profiler's warm-up step, so the tracer is already running when the
    measured request's feed copy and first K5 launch start."""
    from torch.profiler import ProfilerActivity, profile, schedule

    kept = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: kept.append(p.key_averages())
                 ) as prof:
        client.infer(model, {"img": x16})
        prof.step()
        t0 = time.perf_counter()
        client.infer(model, {"img": x16})
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
    if not kept:
        raise RuntimeError("profiler kept no trace of the measured request")
    return _device_summary(kept[0], wall_ms, what, part)


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


# --- amp: mixed precision (FLAGS['amp']) --------------------------------

# H100 SXM dense bf16 on the tensor cores (NVIDIA data sheet)
BF16_FLOP_PER_S = 989e12
# what conv_bn_relu_bf16's operations are timed against in ``bound_ms``
AMP_CONV_PEAK = ("product in bf16 on the tensor cores (2MKF over 989 "
                 "TFLOP/s dense) + 3MF epilogue flops over 67 TFLOP/s; bf16 "
                 "x, w, y and float32 scale, shift over 3.35 TB/s")
# conv_bn_relu_bf16 against its plain version: both round one float32
# accumulator (summed in other orders) to bfloat16, so an output may land
# one bfloat16 step apart: at most one ulp of the output's largest value
AMP_ULPS = 1
# bfloat16 resolution (relative) and the limits in its units: the card
# against the CPU under amp (ResNet-50 batch 2: loss, running statistics)
U = 2.0 ** -8
AMP_CHECK_U = 8
# amp logits against float32 ones over a whole ResNet-50 (53 layers, each
# rounding its conv to bfloat16), of the largest |logit|
AMP_LOGIT_TOL = 0.1


@contextlib.contextmanager
def amp_flag():
    """FLAGS['amp'] on for the body, off again after."""
    from paddle_tpu_torch.flags import FLAGS

    saved = FLAGS["amp"]
    FLAGS["amp"] = True
    try:
        yield
    finally:
        FLAGS["amp"] = saved


def _amp_conv_work(n, c, h, w, f, k, s, p, relu):
    """(bytes, product flops, epilogue flops) of one bfloat16 fused conv:
    bfloat16 x and w read once and y written once, float32 scale and
    shift read once."""
    oh, ow = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    m, kk = n * oh * ow, c * k * k
    return (2 * (n * c * h * w + f * kk + m * f) + 4 * 2 * f,
            2 * m * kk * f, 3 * m * f)


def _amp_conv_bound(nbytes, prod, epi):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = prod / BF16_FLOP_PER_S + epi / F32_FLOP_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _amp_conv_case(torch, rng, *shape):
    """_conv_case's seeded inputs with x and w in bfloat16."""
    x, w, sc, sh, s, p, relu = _conv_case(torch, rng, *shape)
    return x.bfloat16(), w.bfloat16(), sc, sh, s, p, relu


# the seed of the amp kernels phase's batch-16 census inputs
# (amp_census_cases; k5_bf16_vs_old.py replays them)
AMP_CENSUS_SEED = 2031


def amp_census_cases(torch):
    """(shape, count, _amp_conv_case args) for every distinct fused
    convolution of a batch-16 ResNet-50 forward, in census order, drawn
    from one RandomState(AMP_CENSUS_SEED)."""
    import numpy as np

    main, _, _, _ = build_resnet50(seed=1)
    census = conv_census(main, INFER_BATCH)
    if sum(census.values()) != CONVS_PER_FORWARD:
        raise RuntimeError(f"ResNet-50 has {sum(census.values())} fused "
                           f"convs, want {CONVS_PER_FORWARD}")
    rng = np.random.RandomState(AMP_CENSUS_SEED)
    for shape, n in census.items():
        yield shape, n, _amp_conv_case(torch, rng, *shape)


def _amp_conv_library(torch, x, w, sc, sh, s, p, relu):
    """F.conv2d in bfloat16 (cuDNN) and the affine and relu in bfloat16:
    the yardstick, never used by the port (it rounds the convolution to
    bfloat16 before the affine, where K5 rounds once after it)."""
    import torch.nn.functional as F

    sc4 = sc.bfloat16()[None, :, None, None]
    sh4 = sh.bfloat16()[None, :, None, None]

    def run():
        y = torch.addcmul(sh4, F.conv2d(x, w, stride=s, padding=p), sc4)
        return torch.relu(y) if relu else y
    return run


def _bf16_ulps(got, want):
    """(max abs error, in bf16 ulps of want's largest |value|, share of
    elements that differ)."""
    vmax = want.float().abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(vmax)) - 7) if vmax else 2.0 ** -133
    err = (got.float() - want.float()).abs().max().item()
    return err, err / ulp, (got != want).float().mean().item()


def _hold_bf16(torch, k5, args, what):
    """conv_bn_relu_bf16 against its plain version on ``args``: a
    bfloat16 output of the plain version's shape, finite, within
    AMP_ULPS ulps of the plain output's largest |value|. Returns (max abs
    error, ulps, share of outputs that differ at all)."""
    got = k5._conv_cuda(*args)
    want = k5.fused_conv_bn_relu_reference(*args)
    torch.cuda.synchronize()
    err, ulps, share = _bf16_ulps(got, want)
    if got.dtype != torch.bfloat16 or got.shape != want.shape or \
            not torch.isfinite(got).all() or ulps > AMP_ULPS:
        raise RuntimeError(f"K5 bf16 {what}: {got.dtype} {tuple(got.shape)},"
                           f" max abs err {err:.3g} = {ulps:.3g} ulps "
                           f"of the output's max > {AMP_ULPS}")
    return err, ulps, share


# the device-side names of K5 bf16's kernels in a profile: the wgmma
# bodies, the mma.sync body, the split combine
K5_BF16_PROFILE_NAMES = ("conv_kernel<", "conv_bn_relu_bf16_kernel",
                         "split_combine_kernel")


def _bitwise_bf16(torch, k5, args, what):
    """An image's output bitwise the same at the args' batch and alone,
    and two launches on the same inputs bitwise equal."""
    whole = k5._conv_cuda(*args)
    img = min(5, args[0].shape[0] - 1)
    alone = k5._conv_cuda(args[0][img:img + 1].contiguous(), *args[1:])
    if not torch.equal(whole[img:img + 1], alone):
        raise RuntimeError(f"K5 bf16 {what}: image {img}'s output differs "
                           f"between batch {args[0].shape[0]} and alone")
    if not torch.equal(whole, k5._conv_cuda(*args)):
        raise RuntimeError(f"K5 bf16 {what}: two launches on the same "
                           f"inputs differ")


def _combine_row(torch, k5, rng, flush, shape):
    """conv_split_combine_bf16 held against its plain version on seeded
    float32 partials of the plan of ``shape`` (the same sums in the same
    order: bitwise equal), then timed beside it; its bound: the partials
    read once and y written once over HBM bandwidth."""
    import numpy as np

    n, c, h, w, f, k, s, p, relu = shape
    plan = k5._plan(c, h, w, f, k, k, s, p)
    oh, ow = k5.conv_out_hw(h, w, k, k, s, p)
    m = n * oh * ow
    mpad = -(-m // 4) * 4
    ws = torch.from_numpy(rng.randn(plan.splits, f, mpad)
                          .astype(np.float32)).cuda()
    sc = torch.from_numpy((rng.rand(f) + 0.5).astype(np.float32)).cuda()
    sh = torch.from_numpy((rng.randn(f) * 0.1).astype(np.float32)).cuda()
    got = k5._combine_cuda(ws, sc, sh, n, oh, ow, relu)
    want = k5.split_combine_reference(ws, sc, sh, n, oh, ow, relu)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if got.shape != want.shape or not torch.equal(got, want):
        raise RuntimeError(f"split combine at {shape}: max abs err {err:.3g}"
                           f" against its plain version (want bitwise)")
    nbytes = 4 * plan.splits * f * mpad + 2 * m * f + 8 * f
    row = {"shape": list(shape), "splits": plan.splits,
           "partials": [plan.splits, f, mpad], "max_abs_err": err,
           "ms": _time_ms(torch, lambda: k5._combine_cuda(ws, sc, sh, n, oh,
                                                          ow, relu), flush),
           "plain_ms": _time_ms(torch, lambda: k5.split_combine_reference(
               ws, sc, sh, n, oh, ow, relu), flush),
           "library_ms": None,
           "library_note": "no one PyTorch call sums the partials in order "
                           "and applies the epilogue"}
    row["bound_ms"], row["bound_by"] = _bound_of(nbytes,
                                                 (plan.splits + 2) * m * f)
    row["host_us"] = _host_us(torch, lambda: k5._combine_cuda(
        ws, sc, sh, n, oh, ow, relu))
    log("  split combine " + json.dumps(row))
    return row


def amp_kernels_phase(torch):
    """conv_bn_relu_bf16 (K5's bfloat16 form) against its plain version
    on the card (within AMP_ULPS bfloat16 ulps of the output's largest
    |value|): the JAX tests' four shapes, the stem (2-byte weight loads:
    K = 147), a 1x1/2 projection and a res5 3x3 at batch 2, then every
    distinct convolution of a batch-16 ResNet-50 forward (20 shapes, each
    with its plan's body and split); an image's output bitwise the same
    alone and at batch 16, and two launches bitwise equal, at res2 3x3
    and at every shape whose plan takes a wgmma body or splits K; timed
    at the 20 shapes in turns with F.conv2d in bfloat16 (cuDNN) + the
    affine and relu, the plain version once, and summed over the 53
    convolutions of the forward. The split combine
    (conv_split_combine_bf16) held bitwise against its plain version and
    timed at res5 3x3."""
    phase("amp kernels")
    import numpy as np

    from paddle_tpu_torch.kernels import conv_bn_relu as k5

    rng = np.random.RandomState(2027)
    worst = {"max_abs_err": 0.0, "ulps": 0.0, "differing": 0.0}

    def hold(args, what):
        err, ulps, share = _hold_bf16(torch, k5, args, what)
        for key, v in (("max_abs_err", err), ("ulps", ulps),
                       ("differing", share)):
            worst[key] = max(worst[key], v)
        log(f"  conv bf16 {what}: max abs err {err:.3g} ({ulps:.3g} ulps "
            f"of max), {share:.3g} of outputs differ")

    for name, shape in (("jax 3x3", (2, 8, 10, 10, 16, 3, 1, 1, True)),
                        ("jax 3x3/2 odd", (2, 8, 9, 9, 12, 3, 2, 0, True)),
                        ("jax 1x1 no relu", (2, 16, 7, 7, 32, 1, 1, 0,
                                             False)),
                        ("jax 5x5/2 F=7", (1, 3, 12, 12, 7, 5, 2, 2, True)),
                        ("stem 7x7/2", (2, 3, 224, 224, 64, 7, 2, 3, True)),
                        ("proj 1x1/2", (2, 256, 56, 56, 512, 1, 2, 0,
                                        False)),
                        ("res5 3x3", (2, 512, 7, 7, 512, 3, 1, 1, True))):
        hold(_amp_conv_case(torch, rng, *shape), f"{name} {shape}")

    args = _amp_conv_case(torch, rng, INFER_BATCH, 64, 56, 56, 64, 3, 1, 1,
                          True)
    _bitwise_bf16(torch, k5, args, "res2 3x3")
    log("  conv bf16 res2 3x3: image 5 bitwise equal at batch 16 and alone; "
        "two launches bitwise equal")
    del args

    flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")
    fwd = dict.fromkeys(("ms", "plain_ms", "library_ms", "bound_ms"), 0.0)
    work = [0, 0, 0]
    by_shape, bitwise = [], []
    census = {}
    for shape, n, args in amp_census_cases(torch):
        census[shape] = n
        plan = k5.plan_for(args[0].shape, args[1].shape, args[4], args[5])
        hold(args, f"{shape} {tuple(plan)}")
        if plan.body != "mma" or plan.splits > 1:
            _bitwise_bf16(torch, k5, args, f"{shape}")
            bitwise.append(list(shape))
        row = dict(zip(("ms", "library_ms"), _in_turns(
            torch, lambda: k5._conv_cuda(*args),
            _amp_conv_library(torch, *args), flush)))
        row["plain_ms"] = _time_ms(
            torch, lambda: k5.fused_conv_bn_relu_reference(*args), flush)
        w1 = _amp_conv_work(*shape)
        row.update(_amp_conv_bound(*w1))
        for key in fwd:
            fwd[key] += n * row[key]
        work = [a + n * b for a, b in zip(work, w1)]
        by_shape.append({"shape": list(shape), "count": n,
                         "body": plan.body, "splits": plan.splits,
                         "tile": [64, plan.bn],
                         **{k: row[k] for k in ("ms", "library_ms",
                                                "plain_ms", "bound_ms",
                                                "bound_by")}})
        del args
    log(f"  conv bf16: an image bitwise equal at batch {INFER_BATCH} and "
        f"alone, two launches bitwise equal, at the {len(bitwise)} shapes "
        f"on a wgmma body or split: {json.dumps(bitwise)}")
    fwd["bound_by"] = _amp_conv_bound(*work)["bound_by"]
    fwd.update({
        "bound_peak": AMP_CONV_PEAK,
        "ratio_port_over_cudnn": fwd["ms"] / fwd["library_ms"],
        "library": ("F.conv2d in bf16 (cuDNN) + the affine and relu in "
                    "bf16; each shape timed in turns K5, library, library, "
                    "K5"),
        "by_shape": by_shape, "distinct_shapes": len(census),
        "convs": CONVS_PER_FORWARD, "gflop": (work[1] + work[2]) / 1e9,
        "max_err_bf16_ulps": worst["ulps"],
        "max_share_differing": worst["differing"],
        "bitwise_shapes": bitwise,
        "split_convs_per_forward": sum(
            n for shape, n in census.items()
            if k5._plan(*shape[1:6], shape[5], *shape[6:8]).splits > 1),
    })
    log(f"  time one batch-{INFER_BATCH} forward in bf16, "
        f"{CONVS_PER_FORWARD} convs in {len(census)} shapes: "
        + json.dumps(fwd))
    combine = _combine_row(torch, k5, rng, flush,
                           (INFER_BATCH, 512, 7, 7, 512, 3, 1, 1, True))
    del flush
    return worst["max_abs_err"], fwd, combine


def infer_amp_phase(torch, split_convs):
    """The fused ResNet-50 artifact (as in infer, its logits the fetch
    target) served over RPC under FLAGS['amp'] at bucket 16: the model
    loaded and warmed under the flag, 10 requests of 16 seeded images.
    Counters zeroed just before the requests and read just after: 53
    conv_bn_relu_bf16 launches per executed batch and ``split_convs``
    conv_split_combine_bf16 launches (the convolutions whose plan splits
    K), no float32 K5 launch, no plain call. Then one more request
    profiled (reporting only: the device's busy share and K5 bf16's
    device ms). The amp logits against the float32 fused forward of the
    same artifact on the same images: finite, within AMP_LOGIT_TOL of the
    largest |logit|; argmax agreement recorded."""
    phase("infer amp")
    import shutil
    import tempfile

    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.serving import ServingClient, ServingServer

    main, startup, logits, _ = build_resnet50(seed=1)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    seeded_bn_fold(torch, main, scope, seed=2)
    tmp = tempfile.mkdtemp(prefix="resnet50_amp_")
    srv = ServingServer()
    cli = ServingClient(srv.serve(), timeout=900.0)
    try:
        with fluid.scope_guard(scope):
            fluid.save_inference_model(tmp, ["img"], [logits], exe, main)
        x16 = _images(np.random.RandomState(11), INFER_BATCH)
        with amp_flag():
            t0 = time.perf_counter()
            cli.load_model("resnet50_amp", tmp, buckets=[INFER_BATCH])
            load_s = time.perf_counter() - t0
            batches0 = cli.list_models()["resnet50_amp"]["batches"]
            # the main path's window: counters to 0, the requests,
            # counters read
            _reset_kernel_counts()
            t0 = time.perf_counter()
            for _ in range(10):
                out, ver = cli.infer("resnet50_amp", {"img": x16})
            steady = time.perf_counter() - t0
            launches, plain = _kernel_counts()
            batches = cli.list_models()["resnet50_amp"]["batches"] - batches0
            # the window ends here
            profile = profile_infer(torch, cli, x16, model="resnet50_amp",
                                    part=K5_BF16_PROFILE_NAMES,
                                    what="bucket-16 amp infer request")
    finally:
        cli.close()
        srv.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    if batches == 0 or launches["conv_bn_relu_bf16"] != \
            CONVS_PER_FORWARD * batches or \
            launches["conv_split_combine_bf16"] != split_convs * batches or \
            launches["conv_bn_relu_f32"] or any(plain.values()):
        raise RuntimeError(f"amp serving: {batches} batches, launches "
                           f"{launches}, plain {plain}")
    (want,) = exe.run(main, feed={"img": x16}, fetch_list=[logits],
                      scope=scope)
    got = out[0]
    scale = float(np.abs(want).max())
    rel = float(np.abs(got - want).max()) / scale
    if got.shape != (INFER_BATCH, RESNET_CLASSES) or ver != 1 or \
            not np.isfinite(got).all() or rel > AMP_LOGIT_TOL:
        raise RuntimeError(f"amp logits vs float32: {rel:.3g} of max "
                           f"|logit| > {AMP_LOGIT_TOL} (or not finite)")
    infer = {
        "config": "resnet50 imagenet fused 224x224x3 1000 classes, "
                  "FLAGS['amp'] (K5 bf16), seeded weights, fold_bn "
                  "Scale/Shift",
        "load_warm_s": load_s, "batches": batches,
        "kernel_launches": launches, "plain_calls": plain,
        "images_per_s_bucket16": 10 * INFER_BATCH / steady,
        "logits_rel_err_vs_f32": rel, "max_abs_logit": scale,
        "argmax_agreement": float((got.argmax(-1) == want.argmax(-1))
                                  .mean()),
        "profile": profile,
    }
    log("  infer amp " + json.dumps(infer))
    return infer


def resnet_train_amp_phase(torch):
    """The resnet train main path under FLAGS['amp']: ResNet-50 ImageNet,
    Momentum(0.01, 0.9), batch 32, 5 steps (conv2d and the fc in bf16,
    float32 master weights). Counters zeroed just before the steps and
    read just after: no plain version ran. The losses finite, every
    running statistic moved, every parameter float32; the same step twice
    from the same state bitwise equal in loss and scope; one profiled
    step. Then the trained network's statistics folded into the fused
    form and a seeded batch of 16 through it under amp: 53
    conv_bn_relu_bf16 launches, no float32 K5 launch, no plain call; its
    logits against the unfused test-mode network's under amp within
    AMP_LOGIT_TOL of the largest |logit| (the two round to bfloat16 at
    other places: the fused form after the folded affine, the unfused one
    before its batch norm)."""
    phase("resnet train amp")
    import numpy as np

    import paddle_tpu_torch.fluid as fluid

    main, startup, test, cost, acc, pg = build_resnet50_train(seed=3)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    stats = _bn_stats(main)
    initial = {n: scope.find_var(n).clone() for pair in stats for n in pair}
    rng = np.random.RandomState(0)
    feed = {"img": torch.from_numpy(rng.randn(
                RESNET_TRAIN_BATCH, 3, RESNET_IMAGE, RESNET_IMAGE)
                .astype(np.float32)).cuda(),
            "label": torch.from_numpy(rng.randint(
                0, RESNET_CLASSES, (RESNET_TRAIN_BATCH, 1))
                .astype(np.int64)).cuda()}
    with amp_flag():
        # the main path's window: counters to 0, the steps, counters read
        torch.cuda.reset_peak_memory_stats()
        _reset_kernel_counts()
        losses, step_ms = [], []
        for _ in range(RESNET_TRAIN_STEPS):
            t0 = time.perf_counter()
            losses.append(_one_step(exe, main, feed, cost, scope))
            step_ms.append((time.perf_counter() - t0) * 1e3)
        launches, plain = _kernel_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # the window ends here
        after = _scope_copy(fluid, scope)
        runs = []
        for _ in range(2):
            s = _scope_copy(fluid, after)
            runs.append((_one_step(exe, main, feed, cost, s), s))
        differ = _same_state(torch, runs[0][1], runs[1][1])
        profile = profile_step(torch, exe, main, feed, cost,
                               _scope_copy(fluid, after))
    if any(plain.values()) or not all(np.isfinite(losses)):
        raise RuntimeError(f"amp steps: plain {plain}, losses {losses}")
    still = [n for n, t in initial.items()
             if torch.equal(scope.find_var(n), t)]
    dtypes = {str(scope.find_var(p.name).dtype) for p, _ in pg}
    if still or dtypes != {"torch.float32"}:
        raise RuntimeError(f"amp steps: {len(still)} running statistics "
                           f"never moved; parameter dtypes {dtypes}")
    if runs[0][0] != runs[1][0] or differ:
        raise RuntimeError(f"amp: the same step twice: losses {runs[0][0]!r}"
                           f" {runs[1][0]!r}; {len(differ)} scope tensors "
                           f"differ, e.g. {differ[:3]}")
    del runs, after
    p50 = statistics.median(step_ms[1:])
    train = {
        "config": "resnet-50 imagenet 224x224x3 1000 classes, FLAGS['amp'] "
                  "(bf16 conv2d and fc, float32 master weights), momentum "
                  "0.01/0.9, fake data (one seeded batch)",
        "batch": RESNET_TRAIN_BATCH, "steps": RESNET_TRAIN_STEPS,
        "losses": losses, "step_ms": step_ms,
        "p50_step_ms_after_first": p50,
        "images_per_s": RESNET_TRAIN_BATCH / (p50 / 1e3),
        "peak_memory_allocated_gb": peak_gb,
        "kernel_launches": launches, "plain_calls": plain,
        "same_step_twice_bitwise": True, "profile": profile,
    }
    log("  resnet train amp " + json.dumps(train))

    fused, fstartup, flogits, _ = build_resnet50(seed=1)
    fscope = fluid.Scope()
    exe.run(fstartup, scope=fscope)
    if fold_trained_network(test, scope, fused, fscope) != CONVS_PER_FORWARD:
        raise RuntimeError("amp fold: pairs != 53")
    x = _images(np.random.RandomState(10), INFER_BATCH)
    with amp_flag():
        _reset_kernel_counts()
        (got,) = exe.run(fused, feed={"img": x}, fetch_list=[flogits],
                         scope=fscope)
        launches, plain = _kernel_counts()
        (want,) = exe.run(test, feed={"img": x, "label": np.zeros(
            (INFER_BATCH, 1), np.int64)}, fetch_list=[logits_var(test)],
            scope=scope)
    scale = float(np.abs(want).max())
    rel = float(np.abs(got - want).max()) / scale
    if launches["conv_bn_relu_bf16"] != CONVS_PER_FORWARD or \
            launches["conv_bn_relu_f32"] or any(plain.values()) or \
            not np.isfinite(got).all() or rel > AMP_LOGIT_TOL:
        raise RuntimeError(f"amp fold: launches {launches}, plain {plain}, "
                           f"fused vs unfused {rel:.3g} of max |logit|")
    train["fold"] = {
        "launches": launches["conv_bn_relu_bf16"], "rel_err": rel,
        "max_abs_logit": scale,
        "argmax_agreement": float((got.argmax(-1) == want.argmax(-1))
                                  .mean())}
    log("  resnet fold amp " + json.dumps(train["fold"]))
    return train, (main, test, cost, pg, scope)


def resnet_amp_check_phase(torch, trained):
    """One ResNet-50 training step under FLAGS['amp'] at batch 2, 224x224,
    on the card and on the CPU from the same state and feed: the loss
    within AMP_CHECK_U bfloat16 steps (relative), every updated running
    mean and variance within AMP_CHECK_U steps of its tensor's largest
    |value| (cuDNN and the CPU sum the bfloat16 products in other
    orders, and a rounding that lands one step apart spreads through
    each batch norm)."""
    phase("resnet amp check")
    import numpy as np

    import paddle_tpu_torch.fluid as fluid

    main, _, cost, _, card_trained = trained
    arrays = {n: card_trained.find_var(n).cpu().numpy()
              for n in card_trained.var_names()}
    rng = np.random.RandomState(4)
    feed = {"img": rng.randn(2, 3, RESNET_IMAGE,
                             RESNET_IMAGE).astype(np.float32),
            "label": rng.randint(0, RESNET_CLASSES, (2, 1)).astype(np.int64)}
    stats = [n for pair in _bn_stats(main) for n in pair]
    loss, scopes, secs = {}, {}, {}
    for dev in ("cuda", "cpu"):
        scopes[dev] = fluid.Scope()
        fluid.params_from_jax(arrays, scopes[dev], device=dev)
        exe = fluid.Executor(fluid.CUDAPlace(0) if dev == "cuda"
                             else fluid.CPUPlace())
        t0 = time.perf_counter()
        with amp_flag():
            loss[dev] = _one_step(exe, main, feed, cost, scopes[dev])
        secs[dev] = time.perf_counter() - t0
    lc, lp = loss["cuda"], loss["cpu"]
    loss_u = abs(lc - lp) / abs(lp) / U
    stat_u = max((float(np.abs(scopes["cuda"].find_var(n).cpu().numpy()
                              - scopes["cpu"].find_var(n).numpy()).max())
                  / float(np.abs(scopes["cpu"].find_var(n).numpy()).max())
                  / U, n) for n in stats)
    check = {"loss_card": lc, "loss_cpu": lp, "loss_units": loss_u,
             "worst_stat_units": stat_u, "stats": len(stats),
             "cpu_step_s": secs["cpu"]}
    log("  resnet50 amp batch 2 card vs cpu " + json.dumps(check))
    if not np.isfinite(lc) or loss_u > AMP_CHECK_U or \
            stat_u[0] > AMP_CHECK_U:
        raise RuntimeError(f"amp card vs cpu: loss {loss_u:.3g} U, worst "
                           f"statistic {stat_u[0]:.3g} U > {AMP_CHECK_U}")
    return check


def train_amp_phase(torch):
    """The train main path under FLAGS['amp']: Transformer-base, Adam(1e-4),
    batch 16, 5 steps on the card; the fc and attention projections in
    bf16, K1, K2, K3a and K3b float32, as in the JAX package. Counters
    zeroed just before the steps and read just after: 30 layer-norm and
    18 each flash launches (the delta's too) a step, no plain call; the loss finite and
    falling; every parameter float32."""
    phase("train amp")
    import numpy as np

    import paddle_tpu_torch.fluid as fluid

    main, startup, cost, pg = build_transformer(TRANSFORMER_BASE, 1e-4)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    feed = copy_task_batch(TRAIN_BATCH, TRANSFORMER_BASE)
    with amp_flag():
        # the main path's window: counters to 0, the steps, counters read
        torch.cuda.reset_peak_memory_stats()
        _reset_kernel_counts()
        losses, step_ms = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            losses.append(_one_step(exe, main, feed, cost, scope))
            step_ms.append((time.perf_counter() - t0) * 1e3)
        launches, plain = _kernel_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        # the window ends here
        profile = profile_step(torch, exe, main, feed, cost, scope)
    want = {"layer_norm_f32": 30, "flash_fwd_f32": 18,
            "flash_bwd_dkdv_f32": 18, "flash_bwd_dq_f32": 18,
            "flash_delta": 18}
    bad = {k: launches[k] for k, n in want.items()
           if launches[k] != n * TRAIN_STEPS}
    dtypes = {str(scope.find_var(p.name).dtype) for p, _ in pg}
    if bad or any(plain.values()) or dtypes != {"torch.float32"}:
        raise RuntimeError(f"train amp: launches {bad}, plain {plain}, "
                           f"parameter dtypes {dtypes}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"train amp: losses not finite or not falling: "
                           f"{losses}")
    p50 = statistics.median(step_ms[1:])
    train = {
        "config": "transformer-base 6+6L d512 h8 ff2048 vocab32000 len512 "
                  "dropout0.1 adam1e-4, FLAGS['amp']",
        "batch": TRAIN_BATCH, "steps": TRAIN_STEPS, "losses": losses,
        "step_ms": step_ms, "p50_step_ms_after_first": p50,
        "tokens_per_s": TRAIN_BATCH * SEQ / (p50 / 1e3),
        "peak_memory_allocated_gb": peak_gb,
        "kernel_launches": launches, "plain_calls": plain,
        "profile": profile,
    }
    log("  train amp " + json.dumps(train))
    return train


# --- bf16 attention: the bfloat16 forms of K2, K3a, K3b ----------------

# bfloat16 kernels against their plain versions on the card: both round
# the same float32 values to bfloat16 and their float32 sums run in other
# orders, so an element may land one bfloat16 step apart near a rounding
# boundary: at most BF16_FLASH_ULPS ulps of the tensor's largest |value|,
# and at most BF16_FLASH_SHARE of the elements differing at all
BF16_FLASH_ULPS = 1
BF16_FLASH_SHARE = 0.01
FLASH_BF16_PEAK = ("products in bf16 on the tensor cores (flops over 989 "
                   "TFLOP/s dense) + ~5 float32 flops a pair over 67 "
                   "TFLOP/s; bf16 q/k/v/dO/outputs and float32 lse/delta "
                   "over 3.35 TB/s")
SDPA_FLASH_LIBRARY = "sdpa flash backend, bf16"
# the ptxas name of K2 bf16's wgmma body (csrc/flash_fwd_wgmma.cuh)
WGMMA_FWD_KERNEL = "fwd_kernel<2>"
# what the earlier mma.sync forms of K3a/K3b bf16 reached against the
# plain versions at the first 13 cases: recorded beside each backward
# kernel's worst case (not a gate)
MMA_SYNC_BF16_ULPS, MMA_SYNC_BF16_SHARE = 0.5, 0.0036
# benchmarks/flash_attention_bench.py: B=1, H=8, D=64, causal, bf16
FLASH_BENCH_HEADS, FLASH_BENCH_D, FLASH_BENCH_SEQS = 8, 64, (2048, 4096)
# train bf16 attn: bf16 against the same program in float32, of the f32
# loss (q, k, v and the attention output rounded to bfloat16)
BF16_ATTN_LOSS_U = 8
# ... and the card against the port's CPU route (the same function;
# float32 sums in other orders, a bfloat16 element may round the other way)
BF16_ATTN_CPU_RTOL = 1e-4


# the bf16 kernels phase's cases (BH, Sq, Sk, head_dim, causal), drawn in
# this order from one RandomState(BF16_FLASH_SEED) by _flash_bf16_case
# (flash_bf16_bwd_vs_old.py replays them)
BF16_FLASH_SEED = 2029
BF16_FLASH_CASES = [
    (4, 256, 256, 64, False), (4, 256, 256, 64, True),
    (4, 200, 136, 8, True), (4, 136, 200, 72, False),
    (4, 256, 200, 72, True), (2, 300, 200, 128, True),
    (2, 200, 300, 128, False), (2, 200, 300, 136, False),
    (2, 150, 200, 256, True), (2, 200, 150, 264, False),
    (2, 256, 200, 264, True), (128, SEQ, SEQ, 64, False),
    (128, SEQ, SEQ, 64, True),
    # a key length that fits no tile; heads of 150 rows, the last ending
    # inside a 64-row tile (the TMA maps' edges)
    (3, 256, 77, 64, False), (5, 150, 150, 64, True)]
# the timed shapes (BH, S, causal) at head_dim 64: Transformer-base's
# attention and the flash benchmark's
BF16_FLASH_TIMED = ((128, SEQ, False), (128, SEQ, True), (8, 2048, True),
                    (8, 4096, True))


def _flash_bf16_bounds(bh, sq, sk, d, causal):
    """``_flash_bounds``' count with bf16 q, k, v, dO and outputs (2 bytes)
    and float32 lse and delta, the products over the bf16 tensor-core
    peak and ~5 float32 flops a pair over the float32 peak."""
    pairs = bh * _flash_pairs(sq, sk, causal)
    qo, kv, rows = bh * sq * d * 2, bh * sk * d * 2, bh * sq * 4
    out = {}
    for name, nbytes, products in (
            ("flash_fwd_bf16", 2 * qo + 2 * kv + rows, 4 * d),
            ("flash_bwd_dkdv_bf16", 2 * qo + 4 * kv + 2 * rows, 8 * d),
            ("flash_bwd_dq_bf16", 3 * qo + 2 * kv + 2 * rows, 6 * d)):
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = (pairs * products / BF16_FLOP_PER_S
                 + pairs * 5 / F32_FLOP_PER_S)
        out[name] = {"bound_ms": max(t_bytes, t_ops) * 1e3,
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations",
                     "bound_peak": FLASH_BF16_PEAK}
    return out


def _flash_bf16_case(torch, rng, bh, sq, sk, d, causal):
    """_flash_case in bfloat16: seeded q/k/v/dO, the plain bf16 forward's
    O and LSE, delta from the bf16 O as _Flash.backward computes it."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    q, k, v = (_randn(torch, rng, bh, s, d).bfloat16() for s in (sq, sk, sk))
    do = _randn(torch, rng, bh, sq, d).bfloat16()
    scale = d ** -0.5
    o, lse = fa.flash_attention_fwd_reference(q, k, v, causal, scale)
    delta = (do.float() * o.float()).sum(-1)
    return dict(q=q, k=k, v=v, do=do, o=o, lse=lse, delta=delta,
                causal=causal, scale=scale)


def bf16_kernels_phase(torch):
    """flash_fwd_bf16 (K2), flash_bwd_dkdv_bf16 (K3a) and flash_bwd_dq_bf16
    (K3b) against their plain bf16 versions on the card: O, dQ, dK, dV
    bfloat16 within BF16_FLASH_ULPS ulps of the tensor's max with at most
    BF16_FLASH_SHARE of the elements differing, LSE float32 within TOL;
    full and causal, Sq != Sk both ways, Sk = 200 (a partial 128-key
    softmax block), head_dim 8, 64, 72, 128 (tensor cores), 136, 256, 264
    (CUDA cores; 264 in 256-column slices); two launches bitwise equal.
    Timed at Transformer-base's attention ([BH=128, S=512, D=64], full and
    causal) and the flash benchmark's ([BH=8, S=2048, 4096, D=64],
    causal): each kernel and the plain versions, K2 and SDPA's flash
    forward in turns, the whole backward (delta + K3a + K3b) and SDPA's
    flash backward in turns, beside the bounds."""
    phase("bf16 kernels")
    import numpy as np

    from paddle_tpu_torch.kernels import flash_attention as fa

    rng = np.random.RandomState(BF16_FLASH_SEED)
    names = (fa.FWD_BF16, fa.BWD_DKDV_BF16, fa.BWD_DQ_BF16)
    worst = {n: {"max_abs_err": 0.0, "ulps": 0.0, "differing": 0.0}
             for n in names}
    delta_errs = {}

    def hold(kernel, what, got, want):
        err, ulps, share = _bf16_ulps(got, want)
        if got.dtype != torch.bfloat16 or got.shape != want.shape or \
                not torch.isfinite(got.float()).all() or \
                ulps > BF16_FLASH_ULPS or share > BF16_FLASH_SHARE:
            raise RuntimeError(
                f"{kernel} {what}: {got.dtype} {tuple(got.shape)}, max abs "
                f"err {err:.3g} = {ulps:.3g} ulps of the max (> "
                f"{BF16_FLASH_ULPS}?), {share:.3g} of elements differ (> "
                f"{BF16_FLASH_SHARE}?)")
        w = worst[kernel]
        for key, x in (("max_abs_err", err), ("ulps", ulps),
                       ("differing", share)):
            w[key] = max(w[key], x)
        return ulps, share

    for bh, sq, sk, d, causal in BF16_FLASH_CASES:
        c = _flash_bf16_case(torch, rng, bh, sq, sk, d, causal)
        _hold_delta(torch, c, delta_errs)
        o, lse = fa._fwd_cuda(c["q"], c["k"], c["v"], causal, c["scale"])
        bargs = (c["q"], c["k"], c["v"], c["do"], c["lse"], c["delta"],
                 causal, c["scale"])
        dk, dv = fa._bwd_dkdv_cuda(*bargs)
        dq = fa._bwd_dq_cuda(*bargs)
        rq, rk, rv = fa.flash_attention_bwd_reference(*bargs)
        torch.cuda.synchronize()
        lse_err = (lse - c["lse"]).abs().max().item()
        if lse.dtype != torch.float32 or lse_err > TOL:
            raise RuntimeError(f"{fa.FWD_BF16} LSE: max abs err "
                               f"{lse_err:.3g} > {TOL}")
        got = [hold(fa.FWD_BF16, "O", o, c["o"]),
               hold(fa.BWD_DQ_BF16, "dQ", dq, rq),
               hold(fa.BWD_DKDV_BF16, "dK", dk, rk),
               hold(fa.BWD_DKDV_BF16, "dV", dv, rv)]
        log(f"  flash bf16 bh={bh} sq={sq} sk={sk} d={d} causal={causal}: "
            f"LSE max abs err {lse_err:.3g}; O/dQ/dK/dV ulps of max, share "
            f"differing " + " / ".join(f"{u:.3g} {s:.3g}" for u, s in got))

    for causal in (False, True):
        c = _flash_bf16_case(torch, rng, 128, SEQ, SEQ, 64, causal)
        bargs = (c["q"], c["k"], c["v"], c["do"], c["lse"], c["delta"],
                 causal, c["scale"])
        first, second = (
            fa._fwd_cuda(c["q"], c["k"], c["v"], causal, c["scale"])
            + fa._bwd_dkdv_cuda(*bargs) + (fa._bwd_dq_cuda(*bargs),)
            for _ in range(2))
        if not all(torch.equal(x, y) for x, y in zip(first, second)):
            raise RuntimeError(f"bf16 K2/K3a/K3b causal={causal}: two "
                               f"launches on the same inputs differ")
    log("  flash bf16 forward and backward: two launches bitwise equal "
        "(full and causal)")
    for n in (fa.BWD_DKDV_BF16, fa.BWD_DQ_BF16):
        w = worst[n]
        w["within_mma_sync_marks"] = (w["ulps"] <= MMA_SYNC_BF16_ULPS and
                                      w["differing"] <= MMA_SYNC_BF16_SHARE)
        log(f"  {n}: worst {w['ulps']:.3g} ulps of the max, "
            f"{w['differing']:.3g} of elements differing (the mma.sync "
            f"kernels': {MMA_SYNC_BF16_ULPS}, {MMA_SYNC_BF16_SHARE}); "
            f"within: {w['within_mma_sync_marks']}")

    flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")
    rows = {n: {} for n in names + (fa.DELTA,)}
    # the wrappers' host time a call (encoding the TMA maps included), at
    # a shape whose kernels take less
    c = _flash_bf16_case(torch, rng, 1, 64, 64, 64, False)
    bargs = (c["q"], c["k"], c["v"], c["do"], c["lse"], c["delta"], False,
             c["scale"])
    host_us = {fa.FWD_BF16: _host_us(
        torch, lambda: fa._fwd_cuda(c["q"], c["k"], c["v"], False,
                                    c["scale"])),
               fa.BWD_DKDV_BF16: _host_us(
        torch, lambda: fa._bwd_dkdv_cuda(*bargs)), fa.BWD_DQ_BF16: _host_us(
        torch, lambda: fa._bwd_dq_cuda(*bargs))}
    for bh, s, causal in BF16_FLASH_TIMED:
        d = 64
        c = _flash_bf16_case(torch, rng, bh, s, s, d, causal)
        args = (c["q"], c["k"], c["v"], causal, c["scale"])
        bargs = (c["q"], c["k"], c["v"], c["do"], c["lse"], c["delta"],
                 causal, c["scale"])
        bounds = _flash_bf16_bounds(bh, s, s, d, causal)
        sdpa, sdpa_bwd = _sdpa(torch, c, causal, backend="FLASH_ATTENTION")

        def port_bwd():  # as _Flash.backward runs it
            delta = fa.flash_delta(c["do"], c["o"])
            return fa.flash_attention_bwd(c["q"], c["k"], c["v"], c["do"],
                                          c["lse"], delta, causal,
                                          c["scale"])
        key = f"bh{bh}_s{s}_{'causal' if causal else 'full'}"
        shape = f"[BH={bh}, S={s}, D={d}] bf16 causal={causal}"
        fwd_ms, sdpa_ms, fwd_turns = _in_turns(
            torch, lambda: fa._fwd_cuda(*args), sdpa, flush)
        bwd_ms, sdpa_bwd_ms, bwd_turns = _in_turns(torch, port_bwd,
                                                   sdpa_bwd, flush)
        plain_bwd = _time_ms(
            torch, lambda: fa.flash_attention_bwd_reference(*bargs), flush)
        timed = {
            fa.FWD_BF16: (fwd_ms, _time_ms(
                torch, lambda: fa.flash_attention_fwd_reference(*args),
                flush), sdpa_ms),
            fa.BWD_DKDV_BF16: (_time_ms(
                torch, lambda: fa._bwd_dkdv_cuda(*bargs), flush),
                plain_bwd, sdpa_bwd_ms),
            fa.BWD_DQ_BF16: (_time_ms(
                torch, lambda: fa._bwd_dq_cuda(*bargs), flush), plain_bwd,
                sdpa_bwd_ms),
        }
        for name, (ms, plain_ms, lib_ms) in timed.items():
            rows[name][key] = {
                "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                "library": SDPA_FLASH_LIBRARY, **bounds[name],
                "shape": shape}
        rows[fa.FWD_BF16][key]["in_turns"] = {
            "port_ms": fwd_ms, "sdpa_ms": sdpa_ms,
            "ratio_port_over_sdpa": fwd_ms / sdpa_ms, "turns_ms": fwd_turns}
        rows[fa.FWD_BF16][key]["host_us"] = host_us[fa.FWD_BF16]
        rows[fa.BWD_DKDV_BF16][key]["whole_backward"] = {
            "port_ms": bwd_ms, "sdpa_ms": sdpa_bwd_ms,
            "ratio_port_over_sdpa": bwd_ms / sdpa_bwd_ms,
            "turns_ms": bwd_turns,
            "note": "delta + K3a + K3b against SDPA's flash backward "
                    "(dQ, dK, dV), in turns"}
        rows[fa.BWD_DKDV_BF16][key]["library_note"] = \
            "SDPA backward: computes dQ, dK and dV (K3a + K3b together)"
        rows[fa.BWD_DQ_BF16][key]["library_note"] = \
            "counted with flash_bwd_dkdv_bf16"
        for name in (fa.BWD_DKDV_BF16, fa.BWD_DQ_BF16):
            rows[name][key]["plain_note"] = ("the plain backward computes "
                                             "dQ, dK and dV together")
            rows[name][key]["host_us"] = host_us[name]
        rows[fa.DELTA][key] = _delta_row(torch, c, flush, "bf16")
        log(f"  time {shape}: K2 {fwd_ms:.4f} ms vs SDPA flash "
            f"{sdpa_ms:.4f} (ratio {fwd_ms / sdpa_ms:.3f}); whole backward "
            f"{bwd_ms:.4f} vs {sdpa_bwd_ms:.4f} (ratio "
            f"{bwd_ms / sdpa_bwd_ms:.3f}); K3a "
            f"{timed[fa.BWD_DKDV_BF16][0]:.4f}, K3b "
            f"{timed[fa.BWD_DQ_BF16][0]:.4f}, delta "
            f"{rows[fa.DELTA][key]['ms']:.4f}; bounds "
            + " / ".join(f"{bounds[n]['bound_ms']:.4f}" for n in names)
            + f" / {rows[fa.DELTA][key]['bound_ms']:.4f}")
        del sdpa, sdpa_bwd, c
    del flush
    for name in names:
        rows[name]["worst_vs_plain"] = worst[name]
    for name in rows:
        log(f"  time {name}: " + json.dumps(rows[name]))
    errs = {n: worst[n]["max_abs_err"] for n in names}
    errs[fa.DELTA] = delta_errs[fa.DELTA]
    return errs, rows


def flash_bf16_bench_phase(torch):
    """The JAX flash benchmark's configuration (flash_attention_bench.py:
    B=1, H=8, D=64, causal, bf16, q = k = v from seed 0) through the
    port's entry point flash_attention: forward + backward of
    sum(out.float()), timed with CUDA events (L2 flushed), in turns with
    the float32 kernels on the same values widened. The bf16 kernels'
    launch counts show the entry point went through them."""
    phase("flash bf16 bench")
    import numpy as np

    from paddle_tpu_torch.kernels import flash_attention as fa

    flush = torch.empty(256 << 20, dtype=torch.int8, device="cuda")
    out = {}
    for s in FLASH_BENCH_SEQS:
        x = np.random.RandomState(0).randn(1, s, FLASH_BENCH_HEADS,
                                           FLASH_BENCH_D)
        base = torch.from_numpy(x.astype(np.float32)).cuda()
        by_dtype = {}
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = (base.to(dt).requires_grad_() for _ in range(3))

            def step(q=q, k=k, v=v):
                o = fa.flash_attention(q, k, v, causal=True)
                return torch.autograd.grad(o.float().sum(), (q, k, v))
            by_dtype[dt] = step
        _reset_kernel_counts()
        grads = by_dtype[torch.bfloat16]()
        torch.cuda.synchronize()
        launches, plain = _kernel_counts()
        want = {fa.FWD_BF16: 1, fa.BWD_DKDV_BF16: 1, fa.BWD_DQ_BF16: 1,
                fa.DELTA: 1}
        if {n: launches[n] for n in want} != want or any(plain.values()) \
                or any(launches[n] for n in (fa.FWD, fa.BWD_DKDV,
                                              fa.BWD_DQ)):
            raise RuntimeError(f"flash bf16 bench S={s}: launches "
                               f"{launches}, plain {plain}")
        if not all(g.dtype == torch.bfloat16 and torch.isfinite(
                g.float()).all() for g in grads):
            raise RuntimeError(f"flash bf16 bench S={s}: gradients not "
                               f"finite bf16")
        bf_ms, f32_ms, turns = _in_turns(torch, by_dtype[torch.bfloat16],
                                         by_dtype[torch.float32], flush)
        out[s] = {"shape": f"[1, {s}, {FLASH_BENCH_HEADS}, "
                           f"{FLASH_BENCH_D}] causal",
                  "fwd_bwd_ms_bf16": bf_ms, "fwd_bwd_ms_f32": f32_ms,
                  "ratio_bf16_over_f32": bf_ms / f32_ms, "turns_ms": turns}
        log(f"  flash bf16 bench S={s}: forward + backward bf16 "
            f"{bf_ms:.4f} ms, f32 kernels {f32_ms:.4f} ms (in turns)")
    del flush
    return out


def build_bf16_attention(heads, seq, dh, bf16, lr):
    """Transformer-base's self-attention layer as a Fluid program
    (models/transformer.py _mha, seq_parallel form): q, k, v fc
    projections without bias (num_flatten_dims=2) reshaped to [B, S, H,
    dh], cast to bfloat16 (unless ``bf16`` is False), causal
    ring_attention, cast back, reshape, the output fc, a squared-error
    loss against a target, Adam(lr). Returns (main, startup, cost)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import layers, unique_name

    d = heads * dh
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data(name="x", shape=[seq, d], dtype="float32")
        y = layers.data(name="y", shape=[seq, d], dtype="float32")

        def proj(inp, pname):
            return layers.fc(input=inp, size=d, num_flatten_dims=2,
                             bias_attr=False, param_attr=fluid.ParamAttr(
                                 name=f"attn.{pname}.w"))
        qkv = [layers.reshape(proj(x, n), shape=[0, 0, heads, dh])
               for n in "qkv"]
        if bf16:
            qkv = [layers.cast(t, "bfloat16") for t in qkv]
        ctx = layers.ring_attention(*qkv, causal=True)
        if bf16:
            ctx = layers.cast(ctx, "float32")
        out = proj(layers.reshape(ctx, shape=[0, 0, d]), "out")
        cost = layers.mean(layers.square_error_cost(input=out, label=y))
        fluid.optimizer.Adam(lr).minimize(cost)
    return main, startup, cost


def train_bf16_attn_phase(torch):
    """The slice's Fluid path: Transformer-base's self-attention layer at
    full width (x [16, 512, 512], 8 heads of 64, causal) with its
    attention core cast to bfloat16, Adam(1e-4), 5 steps on the card on
    one seeded batch. Counters zeroed just before the steps and read just
    after: 5 launches of each bf16 flash kernel, no float32 flash launch,
    no plain call; one more step profiled. Then the same 5 steps from the
    same state on the port's CPU route (losses within BF16_ATTN_CPU_RTOL) and of the same
    program without the casts on the card (float32 attention; losses
    within BF16_ATTN_LOSS_U bf16 steps, U = 2^-8, relative)."""
    phase("train bf16 attn")
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.kernels import flash_attention as fa

    heads, dh = N_HEADS, D_MODEL // N_HEADS
    main, startup, cost = build_bf16_attention(heads, SEQ, dh, True, 1e-4)
    exe, scope = fluid.Executor(), fluid.Scope()
    exe.run(startup, scope=scope)
    cpu_scope, f32_scope = fluid.Scope(), _scope_copy(fluid, scope)
    for n in scope.var_names():
        cpu_scope.set_var(n, scope.find_var(n).cpu())
    rng = np.random.RandomState(4)
    feed = {k: rng.randn(TRAIN_BATCH, SEQ, D_MODEL).astype(np.float32)
            for k in ("x", "y")}
    dfeed = {k: torch.from_numpy(v).cuda() for k, v in feed.items()}

    # the main path's window: counters to 0, the steps, counters read
    torch.cuda.reset_peak_memory_stats()
    _reset_kernel_counts()
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(_one_step(exe, main, dfeed, cost, scope))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches, plain = _kernel_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the window ends here
    want = {fa.FWD_BF16: TRAIN_STEPS, fa.BWD_DKDV_BF16: TRAIN_STEPS,
            fa.BWD_DQ_BF16: TRAIN_STEPS, fa.DELTA: TRAIN_STEPS, fa.FWD: 0,
            fa.BWD_DKDV: 0, fa.BWD_DQ: 0}
    if {n: launches[n] for n in want} != want or any(plain.values()):
        raise RuntimeError(f"train bf16 attn: launches {launches}, plain "
                           f"{plain}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"train bf16 attn: losses not finite or not "
                           f"falling: {losses}")
    profile = profile_step(torch, exe, main, dfeed, cost, scope)

    cpu_exe = fluid.Executor(fluid.CPUPlace())
    cpu_losses = [_one_step(cpu_exe, main, feed, cost, cpu_scope)
                  for _ in range(TRAIN_STEPS)]
    cpu_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses))
    main32, _, cost32 = build_bf16_attention(heads, SEQ, dh, False, 1e-4)
    f32_losses = [_one_step(exe, main32, dfeed, cost32, f32_scope)
                  for _ in range(TRAIN_STEPS)]
    f32_u = max(abs(a - b) / abs(b) for a, b in zip(losses, f32_losses)) / U
    if cpu_rel > BF16_ATTN_CPU_RTOL or f32_u > BF16_ATTN_LOSS_U:
        raise RuntimeError(
            f"train bf16 attn: losses {losses}; CPU route {cpu_losses} "
            f"(max rel {cpu_rel:.3g} > {BF16_ATTN_CPU_RTOL}?); f32 program "
            f"{f32_losses} ({f32_u:.3g} U > {BF16_ATTN_LOSS_U}?)")
    p50 = statistics.median(step_ms[1:])
    out = {
        "config": "transformer-base self-attention layer (d512 h8 dh64 "
                  "causal), q/k/v cast to bf16 around ring_attention, "
                  "fc out, squared error, adam1e-4",
        "batch": TRAIN_BATCH, "seq": SEQ, "steps": TRAIN_STEPS,
        "losses": losses, "step_ms": step_ms,
        "p50_step_ms_after_first": p50,
        "tokens_per_s": TRAIN_BATCH * SEQ / (p50 / 1e3),
        "peak_memory_allocated_gb": peak_gb,
        "kernel_launches": launches, "plain_calls": plain,
        "losses_cpu_route": cpu_losses, "max_rel_vs_cpu": cpu_rel,
        "losses_f32_program": f32_losses, "max_u_vs_f32": f32_u,
        "profile": profile,
    }
    log("  train bf16 attn " + json.dumps(out))
    return out


# --- the data input stack and the padded-sequence path -------------------

# fit_a_line: the verify recipe (uci_housing -> batch 20 -> DataFeeder ->
# SGD(0.01), 5 epochs); card vs CPU losses within FIT_RTOL, the last loss
# at most FIT_DROP of the first
FIT_BATCH, FIT_EPOCHS, FIT_LR, FIT_RTOL, FIT_DROP = 20, 5, 0.01, 1e-5, 0.1
# the stacked LSTM at paddle_tpu/models/stacked_lstm.py's full width (emb
# 512, hid 512: an LSTM of H = 128 on a 512-wide projection, 3 stacked),
# imdb's dictionary, batch 32 (benchmarks/fluid_suite_bench.py:12-14),
# Adam(1e-3), 8 steps. Tolerance, card vs CPU (float32, TF32 off): cuBLAS
# and the CPU sum each product in another order (~1e-7 relative), the
# recurrence carries the difference through 128 steps and 3 layers, and
# Adam's first steps move every weight by about lr whatever its
# gradient's size, so a near-zero gradient of the other sign moves its
# weight by 2 lr. The one-step Transformer check holds 1e-5 on the loss
# and 1e-3 of each gradient's max; over 8 steps the losses get 1e-4.
LSTM = dict(emb_dim=512, hid_dim=512, stacked_num=3, class_dim=2)
LSTM_BATCH, LSTM_STEPS, LSTM_LR = 32, 8, 1e-3
LSTM_LOSS_RTOL, LSTM_GRAD_TOL = 1e-4, 1e-3
# resnet recordio: bench.py:583-628's pipeline over a file of uint8
# images (bench.py:596-612), 5 batches of 32 a pass, 2 passes
RIO_BATCHES, RIO_PASSES = 5, 2


def _cpu_scope(fluid, scope):
    """A CPU copy of every tensor in ``scope``."""
    out = fluid.Scope()
    for n in scope.var_names():
        v = scope.find_var(n)
        if hasattr(v, "detach"):
            out.set_var(n, v.detach().cpu().clone())
    return out


def _card_executor(fluid):
    exe = fluid.Executor()
    if exe.device.type != "cuda":
        raise RuntimeError(f"Executor() chose {exe.device}, not the card")
    return exe


def _held_window(run):
    """The main path's window: every kernel count to 0, ``run()``, the
    counts read. No plain version may run on the card."""
    _reset_kernel_counts()
    out = run()
    launches, plain = _kernel_counts()
    if any(plain.values()):
        raise RuntimeError(f"plain versions ran on the card's main path: "
                           f"{plain}")
    return out, {k: v for k, v in launches.items() if v}


def _timed_steps(exe, program, feeds, fetch, scope):
    import numpy as np

    losses, ms = [], []
    for feed in feeds:
        t0 = time.perf_counter()
        out = exe.run(program, feed=feed, fetch_list=fetch, scope=scope)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(np.asarray(out[0]).reshape(-1)[0]))
    return losses, ms


def _rel_err(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def fit_a_line_phase(torch):
    """The verify recipe on the card: uci_housing.train() ->
    paddle_tpu_torch.batch(..., 20) -> fluid.DataFeeder -> fc ->
    square_error_cost -> mean -> SGD(0.01), 5 epochs; the same feeds
    through the CPU executor from the same initial parameters. Held: the
    losses step by step within FIT_RTOL relative, the last loss at most
    FIT_DROP of the first."""
    phase("fit_a_line")
    import paddle_tpu_torch
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import layers, unique_name

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data(name="x", shape=[13], dtype="float32")
        y = layers.data(name="y", shape=[1], dtype="float32")
        pred = layers.fc(input=x, size=1)
        cost = layers.mean(layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.SGD(learning_rate=FIT_LR).minimize(cost)
    exe, scope = _card_executor(fluid), fluid.Scope()
    exe.run(startup, scope=scope)
    cpu_scope = _cpu_scope(fluid, scope)
    reader = paddle_tpu_torch.batch(
        paddle_tpu_torch.dataset.uci_housing.train(), batch_size=FIT_BATCH)
    feeder = fluid.DataFeeder(place=fluid.CUDAPlace(0), feed_list=[x, y],
                              program=main)
    feeds = [feeder.feed(data) for _ in range(FIT_EPOCHS)
             for data in reader()]

    def run():
        return _timed_steps(exe, main, feeds, [cost], scope)

    (losses, ms), launches = _held_window(run)
    cpu_losses, _ = _timed_steps(fluid.Executor(fluid.CPUPlace()), main,
                                    feeds, [cost], cpu_scope)
    err = _rel_err(losses, cpu_losses)
    if err > FIT_RTOL:
        raise RuntimeError(f"fit_a_line card vs CPU losses differ by {err} "
                           f"relative (> {FIT_RTOL})")
    if not losses[-1] <= FIT_DROP * losses[0]:
        raise RuntimeError(f"fit_a_line loss {losses[0]} -> {losses[-1]}: "
                           f"not below {FIT_DROP} of the first")
    p50 = statistics.median(ms[1:])
    out = {"config": "fit_a_line: uci_housing (synthetic, 404 rows) fc 13->1"
                     f" SGD({FIT_LR}) batch {FIT_BATCH}, {FIT_EPOCHS} epochs",
           "steps": len(feeds), "loss_first": losses[0],
           "loss_last": losses[-1], "max_rel_err_vs_cpu": err,
           "p50_step_ms": p50, "steps_per_s": 1e3 / p50,
           "kernel_launches": launches}
    log("  fit_a_line " + json.dumps(out))
    return out


def _build_stacked_lstm(seed, dict_dim):
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import layers, unique_name
    from paddle_tpu_torch.models import stacked_lstm

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with unique_name.guard(), fluid.program_guard(main, startup):
        words = layers.data(name="words", shape=[1], dtype="int64",
                            lod_level=1)
        label = layers.data(name="label", shape=[1], dtype="int64")
        cost, acc, _ = stacked_lstm.build(words, label, dict_dim=dict_dim,
                                          **LSTM)
        fluid.optimizer.Adam(LSTM_LR).minimize(cost)
    weights = [op.input("Weight")[0] for op in main.global_block().ops
               if op.type == "lstm"]
    return main, startup, cost, [words, label], weights


def _device_launches(events):
    """Kernel launches (and copies) in a profile: the count of its
    device-side entries."""
    return sum(ev.count for ev in events
               if str(getattr(ev, "device_type", "")).endswith("CUDA"))


def lstm_train_phase(torch):
    """stacked_dynamic_lstm at full width on the card: models/
    stacked_lstm.build (emb 512, hid 512 -> H 128, 3 stacked, imdb's
    5147-word dictionary, 2 classes), Adam(1e-3), batch 32 from
    paddle_tpu_torch.batch(dataset.imdb.train(), 32) through DataFeeder
    (lengths 8-119: T pads to 128), 8 steps; the same feeds on the CPU
    executor from the card's initial parameters. Held: losses finite and
    within LSTM_LOSS_RTOL relative, the step-1 gradients of the three
    LSTM weights within LSTM_GRAD_TOL of each one's largest |value|.
    Logged: p50 step ms (steps 2-8), words/s (real tokens: the sum of
    @LEN), one profiled step's busy share, largest entries and launches,
    peak memory."""
    phase("lstm train")
    import numpy as np

    import paddle_tpu_torch
    import paddle_tpu_torch.fluid as fluid

    imdb = paddle_tpu_torch.dataset.imdb
    main, startup, cost, feed_vars, weights = _build_stacked_lstm(
        11, imdb.VOCAB_SIZE)
    grads = [w + "@GRAD" for w in weights]
    exe, scope = _card_executor(fluid), fluid.Scope()
    exe.run(startup, scope=scope)
    cpu_scope = _cpu_scope(fluid, scope)
    feeder = fluid.DataFeeder(place=fluid.CUDAPlace(0), feed_list=feed_vars,
                              program=main)
    reader = paddle_tpu_torch.batch(imdb.train(), LSTM_BATCH)
    feeds = []
    for data in reader():
        feeds.append(feeder.feed(data))
        if len(feeds) == LSTM_STEPS + 1:
            break
    T = {f["words"].shape[1] for f in feeds}
    if T != {128}:
        raise RuntimeError(f"imdb batches padded to T = {T}, want 128")
    words = [int(f["words@LEN"].sum()) for f in feeds]

    def steps(ex, sc):
        losses, ms, step1 = [], [], None
        for i, feed in enumerate(feeds[:LSTM_STEPS]):
            t0 = time.perf_counter()
            out = ex.run(main, feed=feed, scope=sc,
                         fetch_list=[cost] + (grads if i == 0 else []))
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(np.asarray(out[0]).reshape(-1)[0]))
            if i == 0:
                step1 = [np.asarray(g) for g in out[1:]]
        return losses, ms, step1

    torch.cuda.reset_peak_memory_stats()
    (losses, ms, g_card), launches = _held_window(lambda: steps(exe, scope))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    cpu_losses, _, g_cpu = steps(fluid.Executor(fluid.CPUPlace()), cpu_scope)
    cpu_s = time.perf_counter() - t0
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"lstm losses not finite: {losses}")
    err = _rel_err(losses, cpu_losses)
    if err > LSTM_LOSS_RTOL:
        raise RuntimeError(f"lstm card vs CPU losses differ by {err} "
                           f"relative (> {LSTM_LOSS_RTOL}): {losses} vs "
                           f"{cpu_losses}")
    grad_err = {}
    for name, a, b in zip(grads, g_card, g_cpu):
        grad_err[name] = float(np.abs(a - b).max() / np.abs(b).max())
        if not grad_err[name] <= LSTM_GRAD_TOL:
            raise RuntimeError(f"{name}: card vs CPU differ by "
                               f"{grad_err[name]} of its max")
    p50 = statistics.median(ms[1:])
    mean_words = statistics.mean(words[1:LSTM_STEPS])
    out = {"config": "stacked_dynamic_lstm imdb dict 5147 emb 512 hid 512 "
                     "(H 128) x3, 2 classes, Adam(1e-3), batch 32, T 128",
           "steps": LSTM_STEPS, "losses": losses, "cpu_losses": cpu_losses,
           "max_rel_err_vs_cpu": err, "step1_grad_err_of_max": grad_err,
           "step_ms": ms, "p50_step_ms_after_first": p50,
           "real_tokens_a_step": words[:LSTM_STEPS],
           "words_per_s": mean_words / (p50 / 1e3),
           "peak_memory_allocated_gb": peak_gb,
           "cpu_8_steps_s": cpu_s, "kernel_launches": launches}
    log("  lstm train " + json.dumps(out))
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exe.run(main, feed=feeds[LSTM_STEPS], fetch_list=[cost], scope=scope)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    out["profile"] = _device_summary(events, wall_ms, "lstm train step")
    out["profile"]["device_launches_a_step"] = _device_launches(events)
    log(f"  lstm train step: {out['profile']['device_launches_a_step']} "
        "device launches (kernels and copies)")
    return out


def _write_image_records(path, n):
    """n samples of a uint8 [3*224*224] image and an int64 [1] label, from
    RandomState(0), into a recordio file: bench.py:596-612's file."""
    import numpy as np

    from paddle_tpu_torch.fluid.recordio_writer import (
        convert_reader_to_recordio_file)

    rng0 = np.random.RandomState(0)

    def samples():
        for _ in range(n):
            yield (rng0.randint(0, 256, size=(3 * RESNET_IMAGE
                                              * RESNET_IMAGE,)).astype(
                       np.uint8),
                   rng0.randint(0, RESNET_CLASSES, size=(1,)).astype(
                       np.int64))

    return convert_reader_to_recordio_file(path, samples)


def _build_resnet50_reader(seed, path):
    """resnet.build_train fed by bench.py:583-628's in-graph pipeline, or
    (``path`` None) by data vars; the same parameter names either way."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import layers, unique_name
    from paddle_tpu_torch.models import resnet

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    reader = None
    with unique_name.guard(), fluid.program_guard(main, startup):
        if path:
            reader = layers.open_recordio_file(
                path, shapes=[[3, RESNET_IMAGE, RESNET_IMAGE], [1]],
                dtypes=["float32", "int64"])
            reader = layers.multi_pass(reader, pass_num=RIO_PASSES)
            reader = layers.batch(reader, batch_size=RESNET_TRAIN_BATCH,
                                  drop_last=True)
            reader = layers.double_buffer(reader, capacity=2)
            img, label = layers.read_file(reader)
        else:
            img = layers.data(name="img",
                              shape=[3, RESNET_IMAGE, RESNET_IMAGE],
                              dtype="float32")
            label = layers.data(name="label", shape=[1], dtype="int64")
        cost, _, _ = resnet.build_train(img, label, class_dim=RESNET_CLASSES,
                                        depth=50)
        fluid.optimizer.Momentum(learning_rate=RESNET_LR,
                                 momentum=0.9).minimize(cost)
    return main, startup, cost, reader, img


def _trace_streams(path):
    """From a chrome trace: the host-to-device copies and the kernels,
    each as (start us, end us, stream)."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    copies, kernels = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        span = (float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]),
                (ev.get("args") or {}).get("stream"))
        if ev.get("cat") == "gpu_memcpy" and "HtoD" in ev.get("name", ""):
            copies.append(span)
        elif ev.get("cat") == "kernel":
            kernels.append(span)
    return copies, kernels


def _copy_overlap(copies, kernels):
    """Each copy's time, and how much of it some kernel on another stream
    ran beside."""
    total = overlap = 0.0
    for a, b, s in copies:
        total += b - a
        cuts = sorted((max(a, ka), min(b, kb)) for ka, kb, ks in kernels
                      if ks != s and kb > a and ka < b)
        end = a
        for x, y in cuts:
            x = max(x, end)
            if y > x:
                overlap += y - x
                end = y
    return {"copies": len(copies), "copy_ms": total / 1e3,
            "copy_streams": sorted({str(s) for _, _, s in copies}),
            "kernel_streams": sorted({str(s) for _, _, s in kernels}),
            "overlap_ms": overlap / 1e3,
            "overlap_share": overlap / total if total else None}


def resnet_recordio_phase(torch):
    """The resnet train phase's ResNet-50 (batch 32, Momentum(0.01, 0.9),
    deterministic cuDNN algorithms) fed by bench.py:583-628's in-graph
    pipeline: open_recordio_file(shapes [[3,224,224],[1]], float32/int64)
    -> multi_pass(2) -> batch(32, drop_last) -> double_buffer(2) ->
    read_file, over a recordio file of 5 x 32 uint8 images written as
    bench.py:596-612 does (under the run's temporary directory, removed
    at exit). Held: the same 5 batches, decoded on the host and fed as
    numpy dicts to a copy of the same initial state, in turns with the
    pipeline's steps through both passes: bitwise-equal losses, and every
    parameter, running statistic and velocity bitwise equal after them;
    then EOFException; reset_reader rewinds (the next batch is the first
    batch again). Logged: p50 step ms of each feed (steps 2-10), two
    profiled pipeline steps' host-to-device copies and how far kernels
    on another stream overlap them."""
    phase("resnet recordio")
    import pickle
    import shutil
    import tempfile

    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import core, layers
    from paddle_tpu_torch.native.recordio import read_all

    tmp = tempfile.mkdtemp(prefix="resnet_recordio_")
    scope = fluid.Scope()
    try:
        path = os.path.join(tmp, "imgs.recordio")
        n = RIO_BATCHES * RESNET_TRAIN_BATCH
        t0 = time.perf_counter()
        _write_image_records(path, n)
        write_s = time.perf_counter() - t0
        main, startup, cost, reader, img = _build_resnet50_reader(5, path)
        dmain, _, dcost, _, _ = _build_resnet50_reader(5, None)
        exe = _card_executor(fluid)
        exe.run(startup, scope=scope)
        dscope = fluid.Scope()
        for name in scope.var_names():
            v = scope.find_var(name)
            if isinstance(v, torch.Tensor):
                dscope.set_var(name, v.clone())
        state = [name for name in dscope.var_names()]
        samples = [pickle.loads(r) for r in read_all(path)]
        batches = []
        for b in range(RIO_BATCHES):
            part = samples[b * RESNET_TRAIN_BATCH:(b + 1) * RESNET_TRAIN_BATCH]
            batches.append({
                "img": np.stack([s[0] for s in part]).reshape(
                    -1, 3, RESNET_IMAGE, RESNET_IMAGE).astype(np.float32),
                "label": np.stack([s[1] for s in part])})
        del samples

        def in_turns():
            """Every pass of the file, each pipeline step beside the
            dict step of the same batch, which of the two goes first
            alternating: rows of ((pipeline ms, loss), (dict ms,
            loss))."""
            rows = []
            for i, feed in enumerate(batches * RIO_PASSES):
                pair = [(main, cost, scope, None),
                        (dmain, dcost, dscope, feed)]
                row = {}
                for k in ((0, 1) if i % 2 == 0 else (1, 0)):
                    prog, c, sc, fd = pair[k]
                    t0 = time.perf_counter()
                    (loss,) = exe.run(prog, feed=fd, fetch_list=[c],
                                      scope=sc)
                    row[k] = ((time.perf_counter() - t0) * 1e3,
                              float(np.asarray(loss).reshape(-1)[0]))
                rows.append((row[0], row[1]))
            return rows

        rows, launches = _held_window(in_turns)
        losses = [r[0][1] for r in rows]
        if [r[1][1] for r in rows] != losses:
            raise RuntimeError(f"pipeline vs dict losses differ: {rows}")
        differ = [nm for nm in state if not torch.equal(
            scope.find_var(nm), dscope.find_var(nm))]
        if differ:
            raise RuntimeError(f"after {len(rows)} steps {len(differ)} "
                               f"state tensors differ, e.g. {differ[:3]}")
        log(f"  {len(rows)} steps in turns ({RIO_PASSES} passes of "
            f"{RIO_BATCHES} batches): losses bitwise equal {losses}; "
            f"{len(state)} state tensors bitwise equal")
        try:
            exe.run(main, fetch_list=[cost], scope=scope)
        except core.EOFException:
            pass
        else:
            raise RuntimeError("the reader did not end after "
                               f"{RIO_PASSES} passes")
        layers.reset_reader(reader, scope)
        (again,) = exe.run(main, fetch_list=[img], scope=scope)
        if not np.array_equal(again, batches[0]["img"]):
            raise RuntimeError("reset_reader: the next batch is not the "
                               "first")
        log(f"  the file's {RIO_PASSES} passes read, then EOFException; "
            "after reset_reader the first batch again")
        from torch.profiler import ProfilerActivity, profile

        # the double buffer's threads finish their prefetch first; then
        # each of the two profiled steps' pops starts one transfer (the
        # profiler may drop a copy issued before the first step's
        # kernels: the second step's falls well inside the window)
        time.sleep(1.0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(2):
                exe.run(main, fetch_list=[cost], scope=scope)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        trace = os.path.join(os.path.dirname(LOG_PATH),
                             "resnet_recordio_trace.json")
        prof.export_chrome_trace(trace)
        overlap = _copy_overlap(*_trace_streams(trace))
        prof_sum = _device_summary(prof.key_averages(), wall_ms,
                                   "resnet recordio, two steps")
    finally:
        for name in scope.var_names():  # the double buffer's threads
            if isinstance(scope.find_var(name), fluid.readers.HostReader):
                scope.find_var(name).close()
        shutil.rmtree(tmp, ignore_errors=True)
    out = {"config": "resnet-50 imagenet f32 momentum 0.01/0.9 batch 32, "
                     "recordio of uint8 images -> multi_pass(2) -> batch(32)"
                     " -> double_buffer(2) -> read_file",
           "records": n, "write_s": write_s, "losses": losses,
           "pipeline_step_ms": [r[0][0] for r in rows],
           "dict_step_ms": [r[1][0] for r in rows],
           # p50 of steps 2-5 (the first picks cuDNN's algorithms)
           "p50_pipeline_ms": statistics.median(r[0][0] for r in rows[1:]),
           "p50_dict_ms": statistics.median(r[1][0] for r in rows[1:]),
           "pipeline_faster_in_pairs": sum(r[0][0] < r[1][0]
                                           for r in rows[1:]),
           "h2d_in_two_profiled_steps": overlap, "profile": prof_sum,
           "kernel_launches": launches}
    log("  resnet recordio " + json.dumps(out))
    return out


def _kernel_row(name, source, replaces, launches, err, row, **extra):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], **extra}


def main():
    import torch

    os.makedirs(os.path.dirname(LOG_PATH), exist_ok=True)
    open(LOG_PATH, "w").close()
    name, smi = device_phase(torch)
    ptxas = build_phase()
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
    resnet_train, trained = resnet_train_phase(torch)
    resnet_train["check"] = resnet_train_check_phase(torch, trained)
    fold = resnet_fold_phase(torch, trained)
    del trained
    amp_err, amp_fwd, amp_combine = amp_kernels_phase(torch)
    infer_amp = infer_amp_phase(torch, amp_fwd["split_convs_per_forward"])
    resnet_amp, trained = resnet_train_amp_phase(torch)
    resnet_amp["check"] = resnet_amp_check_phase(torch, trained)
    del trained
    train_amp = train_amp_phase(torch)
    bf16_errs, bf16_rows = bf16_kernels_phase(torch)
    bench_bf16 = flash_bf16_bench_phase(torch)
    train_bf16 = train_bf16_attn_phase(torch)
    data_paths = {"fit_a_line": fit_a_line_phase(torch),
                  "lstm_train": lstm_train_phase(torch),
                  "resnet_recordio": resnet_recordio_phase(torch)}
    log("  data input paths (no kernel of the port on them) " +
        json.dumps({k: {m: v[m] for m in v if m in (
            "p50_step_ms", "steps_per_s", "p50_step_ms_after_first",
            "words_per_s", "p50_pipeline_ms", "p50_dict_ms")}
            for k, v in data_paths.items()}))
    from paddle_tpu_torch.kernels import paged_attention as pa

    dec = timings["decode"]
    fa_src = "paddle_tpu_torch/csrc/flash_attention.cu"
    fa_py = "paddle_tpu/fluid/ops/pallas_kernels/flash_attention.py"
    ln_bf16 = train_rows["layer_norm_bf16"]
    train_kernels = [
        _kernel_row("layer_norm_f32", "paddle_tpu_torch/csrc/layer_norm.cu",
                    "paddle_tpu/fluid/ops/pallas_kernels/layer_norm.py:42",
                    train_launches["layer_norm_f32"],
                    train_errs["layer_norm_f32"],
                    train_rows["layer_norm_f32"], train=train),
        _kernel_row("layer_norm_bf16", "paddle_tpu_torch/csrc/layer_norm.cu",
                    "paddle_tpu/fluid/ops/pallas_kernels/layer_norm.py:42 "
                    "(bf16 x, widened on load at :17)",
                    ln_bf16["program"]["launches"]["layer_norm_bf16"],
                    train_errs["layer_norm_bf16"], ln_bf16,
                    launches_from="the cast -> layer_norm program",
                    shape=ln_bf16["shape"], library=ln_bf16["library"],
                    host_us=ln_bf16["host_us"], program=ln_bf16["program"]),
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
        for key in ("whole_backward", "vs_float64", "in_turns",
                    "head_dim_256", "head_dim_264", "head_dim_512"):
            if key in rows:
                extra[key] = rows[key]
        if kname == "flash_fwd_f32":  # the library's three kernels
            extra["ptxas"] = ptxas.get("flash_attention")
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
        bound_f32_ms=k5_fwd["bound_f32_ms"], bound_peak=CONV_PEAK,
        forward=k5_fwd, max_rel_err=k5_rel, shapes=k5_rows,
        ptxas=ptxas.get("conv_bn_relu"), infer=infer, resnet_fold=fold,
        resnet_train=resnet_train), _kernel_row(
        "conv_bn_relu_bf16", "paddle_tpu_torch/csrc/conv_bn_relu.cu",
        "paddle_tpu/fluid/ops/pallas_kernels/conv_bn_relu.py:69",
        infer_amp["kernel_launches"]["conv_bn_relu_bf16"], amp_err, amp_fwd,
        timed_as=f"sum over the {CONVS_PER_FORWARD} convolutions of one "
                 f"batch-{INFER_BATCH} ResNet-50 forward, FLAGS['amp']",
        bound_peak=AMP_CONV_PEAK, forward=amp_fwd, infer_amp=infer_amp,
        resnet_train_amp=resnet_amp, train_amp=train_amp,
        ptxas=ptxas.get("conv_bn_relu")), _kernel_row(
        "conv_split_combine_bf16", "paddle_tpu_torch/csrc/conv_wgmma.cuh",
        "paddle_tpu/fluid/ops/pallas_kernels/conv_bn_relu.py:69 (the "
        "epilogue of a conv_bn_relu_bf16 launch whose plan splits K)",
        infer_amp["kernel_launches"]["conv_split_combine_bf16"],
        amp_combine["max_abs_err"], amp_combine,
        shape=amp_combine["shape"], partials=amp_combine["partials"],
        library_note=amp_combine["library_note"],
        host_us=amp_combine["host_us"])]
    for kname, line in (("flash_fwd_bf16", 111), ("flash_bwd_dkdv_bf16", 295),
                        ("flash_bwd_dq_bf16", 320)):
        rows = bf16_rows[kname]
        row = dict(rows["bh128_s512_full"])
        if kname == "flash_bwd_dq_bf16":
            # one library call computes dQ, dK and dV: the K3a row's
            row["library_ms"] = bf16_rows["flash_bwd_dkdv_bf16"][
                "bh128_s512_full"]["library_ms"]
        extra = {key: rows[key] for key in rows if key != "bh128_s512_full"}
        if kname == "flash_fwd_bf16":
            extra["ptxas"] = ptxas.get("flash_attention")
            # the wgmma body that head_dim <= 64 runs
            extra["ptxas_wgmma_body"] = ptxas.get(
                "flash_attention", {}).get(WGMMA_FWD_KERNEL)
            extra["flash_bf16_bench"] = bench_bf16
            extra["train_bf16_attn"] = train_bf16
        src = ("paddle_tpu_torch/csrc/" + (
            "flash_fwd_wgmma.cuh" if kname == "flash_fwd_bf16" else
            "flash_bwd_wgmma.cuh") + " (head_dim <= 64; above, "
            "flash_attention_bf16.cuh)")
        train_kernels.append(_kernel_row(
            kname, src, f"{fa_py}:{line} (the bf16 branch)",
            train_bf16["kernel_launches"][kname], bf16_errs[kname], row,
            shape=row["shape"], library=row["library"],
            bound_peak=row["bound_peak"], **extra))
    delta = bf16_rows["flash_delta"]
    train_kernels.append(_kernel_row(
        "flash_delta", "paddle_tpu_torch/csrc/flash_delta.cuh",
        f"{fa_py}:280 (the jnp delta of _flash_bwd; no pallas_call)",
        train_bf16["kernel_launches"]["flash_delta"],
        max(bf16_errs["flash_delta"], train_errs["flash_delta"]),
        delta["bh128_s512_full"], shape=delta["bh128_s512_full"]["shape"],
        library_note=delta["bh128_s512_full"]["library_note"],
        launches_train_f32=train_launches["flash_delta"],
        f32=train_rows["flash_delta"],
        **{k: v for k, v in delta.items() if k != "bh128_s512_full"}))
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
        "library": "sdpa on K/V gathered dense (the gather untimed), in "
                   "turns with the kernel",
        "shape": "decode B=8 C=1 Hq=Hkv=16 D=64 ps=16 kv_lens "
                 + ",".join(str(x) for x in dec["kv_lens"]),
        "split_keys": pa.SPLIT_KEYS,
        "prefill": timings["prefill"],
        "decode_b1": timings["decode_b1"],
        "decode_gqa4": timings["decode_gqa4"],
        "decode_d264": timings["decode_d264"],
        "decode_d512": timings["decode_d512"],
        "decode_row": dec,
        "case_errors": timings["errors"],
        "bitwise": timings["bitwise"],
        "ptxas": ptxas.get("paged_attention"),
        "serve": serve,
        "host_logits_read_ms": read_ms,
    }] + train_kernels + infer_kernels}
    log(json.dumps(kernels))
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
