"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

  device   requires CUDA; prints the card, its capability and the
           `nvidia-smi --query-gpu=name,power.limit` line; TF32 off
           (float32 matmuls in full float32, as the JAX package's
           matmul_precision='highest').
  build    compiles every kernel in paddle_tpu_torch/csrc with nvcc for
           sm_90a, all sources at once, and prints the seconds.
  kernels  holds each kernel against its plain PyTorch version on the
           card on seeded cases (max abs error <= 1e-4; dead slots and
           dead query lanes exactly 0), then times kernel, plain version
           and one PyTorch library call at the serving phase's shapes
           (CUDA events, L2 flushed before each launch, median of 25).
  serve    the port's main path at GPT-2-medium width (24 layers,
           d_model 1024, 16 heads, vocab 50257, seeded weights): a
           ServingServer on the card, load_decoder, 8 concurrent
           generate requests, a repeated prompt (prefix-cache hit, same
           tokens), a streamed request (equals its buffered twin). The
           kernel counters are zeroed just before and read just after:
           every attention launch must have gone through the kernel
           (24 per engine step) and none through the plain version.
  check    the same decoder step at full width (2 layers) on the card
           and on the CPU (plain version): logits agree; and a small
           engine decodes the same greedy tokens on both devices.

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

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and
# float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
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
    t_bytes = (kv_bytes + qo_bytes + idx_bytes) / HBM_BYTES_PER_S
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
        launches, plain = pa.counts.kernel_launches, pa.counts.plain_calls
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

    def dev_us(ev):
        return getattr(ev, "self_device_time_total",
                       getattr(ev, "self_cuda_time_total", 0.0))

    # device-side events only (kernels, memcpy/memset): an aten op's
    # device time would count its kernels a second time
    rows = [(ev.key, dev_us(ev), ev.count) for ev in prof.key_averages()
            if str(getattr(ev, "device_type", "")).endswith("CUDA")]
    rows = [r for r in rows if r[1] > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows) / 1e3
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "busy_share": busy_ms / wall_ms if wall_ms else None,
           "top": [{"name": k[:80], "device_ms": us / 1e3, "count": n}
                   for k, us, n in rows[:10]]}
    if not rows:
        out["note"] = "profiler recorded no device time"
    log("  profile " + json.dumps(out))
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


def main():
    import torch

    name, smi = device_phase(torch)
    build_phase()
    max_err, timings = kernels_phase(torch)
    launches, serve = serve_phase(torch)
    read_ms = host_read_ms(torch)
    log(f"  host logits read [8, 50257] f32: {read_ms:.4f} ms (median)")
    check_phase(torch)
    dec = timings["decode"]
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
    }]}
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
