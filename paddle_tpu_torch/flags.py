"""Runtime flags of the port — the keys its ported paths read,
with the same cold defaults as ``paddle_tpu/fluid/flags.py``. There is
no kernel-routing flag: a kernel wrapper routes on its tensor's device
alone (a CPU tensor takes the plain PyTorch version, a CUDA tensor the
hand-written kernel). Nor are there ``donate_state`` or
``compile_stats``: XLA buffer donation and per-executable cost
accounting have no counterpart in an eager executor."""
from __future__ import annotations

import os
from typing import Any, Dict

# the recorder parses PADDLE_TPU_TRACE / PADDLE_TPU_TRACE_BUFFER once at
# import; FLAGS reads its live state rather than re-parsing the env, so
# one parser owns both views
from .observability import tracing as _tracing

__all__ = ["FLAGS", "set_flags", "get_flag", "effective_flag"]


class _Flags(dict):
    """FLAGS with read-through keys: 'trace'/'trace_buffer' always report
    the live recorder (``trace_enable()`` toggles it without going
    through set_flags, so a stored mirror would go stale), and 'faults'
    reports the live fault-injection plan the same way
    (``faults.install()``/``scoped()`` toggle it without set_flags)."""

    def __getitem__(self, k):
        if k == "trace":
            return _tracing.trace_enabled()
        if k == "trace_buffer":
            return _tracing.buffer_capacity()
        if k == "faults":
            from .distributed import faults as _faults

            return _faults.active_spec()
        return dict.__getitem__(self, k)


FLAGS: Dict[str, Any] = _Flags({
    # numeric precision of float32 matmuls and convolutions in a run of
    # the Executor, the JAX package's flag: 'highest' = full float32
    # products (TF32 off in cuBLAS and cuDNN, whatever the caller's
    # torch settings); 'high' and 'default' leave the caller's torch
    # settings as they are (TF32 where the caller allowed it)
    "matmul_precision": "highest",
    # sweep the new state and the fetches for NaN/Inf after each run
    # (reference FLAGS_check_nan_inf, executor.cc:27): one
    # torch.isfinite(...).all() per floating var, FloatingPointError on
    # the first that fails
    "check_nan_inf": False,
    # print each run's time, taken after the run's device has finished
    # its work (reference FLAGS_benchmark, executor.cc:348)
    "benchmark": False,
    # run the static program verifier (paddle_tpu_torch.analysis.verify)
    # on each program-cache miss of the Executor: structural checks
    # only (use-before-def, unknown vars and ops, block nesting — not
    # the meta-tensor shape re-check), so the cost is one O(ops) walk
    # per (program version, feed signature), never per step
    "verify_programs": False,
    # record host spans into paddle_tpu_torch.observability.tracing
    # from process start (trace_enable() also toggles it at run time).
    # Reads are live (see _Flags); the stored values here only seed
    # `k in FLAGS` / sorted(FLAGS)
    "trace": _tracing.trace_enabled(),
    # span ring-buffer capacity (oldest spans drop past it)
    "trace_buffer": _tracing.buffer_capacity(),
    # deterministic fault-injection plan (distributed/faults.py spec
    # string); None/'' = off. Seeded from PADDLE_TPU_FAULTS; reads are
    # live (see _Flags)
    "faults": None,
    # runtime sanitizers. 'guards' instruments the annotated runtime
    # classes (analysis/sanitize.py) so every access to a
    # '# guarded-by:'-declared attribute asserts its lock is held.
    # Seeded from PADDLE_TPU_SANITIZE at import; the package's
    # __init__ installs the instrumentation when set. '' = off
    "sanitize": os.environ.get("PADDLE_TPU_SANITIZE", ""),
    # the serving bucket ladder: dynamic batches pad up to the next
    # entry (serving.engine.default_buckets)
    "serving_buckets": "1,2,4,8,16",
    # admission bound: queue depth past which a request is rejected with
    # ServerOverloaded instead of queueing into unbounded latency
    "serving_max_queue": 64,
    # batching timer: the oldest queued request waits at most this long
    # for batch-mates before its (possibly underfull) batch launches
    "serving_max_wait_ms": 5.0,
    # streaming generate: a token stream nobody polls for this many
    # seconds is presumed abandoned — the server cancels the sequence
    # (KV pages free immediately) and later continuations get a typed
    # StreamExpired
    "serving_stream_ttl": 300.0,
    # decode slot ladder: the fixed-slot decode batch pads its slot
    # count up to the next ladder entry
    "decode_slots": "1,2,4",
    # KV page granularity in tokens
    "kv_page_size": 16,
    # preallocated KV pool size in pages (page 0 is the reserved garbage
    # page): pages x page_size bounds decode memory independent of
    # ragged sequence lengths — the decode admission bound
    "kv_num_pages": 128,
    # per-sequence cap on prompt + generated tokens; also sets the
    # page-table width ladder
    "decode_max_seq_len": 128,
    # prefix caching: completed prompts publish their full KV pages into
    # a refcounted radix index; a request sharing a cached prefix maps
    # them read-only and prefills only its suffix (copy-on-write for the
    # partial tail page)
    "prefix_cache": True,
    # KV reservation policy: 'demand' reserves the prompt's pages plus
    # kv_decode_headroom pages at admission and grows mid-decode,
    # preempting (spill to host, restore later) on exhaustion;
    # 'worst_case' reserves prompt + max_new up front
    "kv_reservation": "demand",
    # decode headroom (in pages) a demand-mode reservation adds past the
    # prompt
    "kv_decode_headroom": 1,
    # where preempted sequences' KV pages spill ('' = host RAM; a
    # directory = one .npz per preempted sequence)
    "kv_spill_dir": "",
    # chunked prefill: per-step prompt-token budget AND the chunk width
    # of the mixed decode step (1 = one prompt token per step)
    "prefill_chunk": 16,
    # speculative decoding proposals per slot per round; 0 = off (the
    # only value this package accepts so far)
    "spec_k": 0,
    # program build: an emitter failing meta-tensor shape inference with
    # an unexpected error raises instead of warning once per op type
    "strict_shape_inference": False,
    # mixed precision: mul, matmul, conv2d and conv2d_bn_relu cast their
    # float32 operands to bf16 (float32 accumulation, one rounding) and
    # restore the result to float32; master weights stay float32
    "amp": False,
    # tally while-loop body evaluations (fluid/ops/control_flow.py
    # step_evals): T a loop of T iterations, max_steps a bounded loop;
    # the gradient replays no iteration
    "count_while_step_evals": False,
    # default training mesh: '' = a ParallelExecutor built with no mesh=
    # runs data parallel over the process group's world (one rank a
    # device); an axes string ('dp=2,tp=2,fsdp=2') makes that executor
    # train on the named mesh. Pair with a ShardingRules plan
    # (mesh.transformer_rules gives the dp x tp x fsdp layout of the
    # Transformer)
    "mesh_axes": "",
    # default SERVING mesh for DecodeEngine/load_decoder: '' = one
    # device; an axes string makes one decode replica SPAN the process
    # group's ranks — params shard per mesh.decoder_rules and the paged
    # KV pool shards over the kv-head axis. A checkpoint that RECORDS a
    # mesh (save_decoder_checkpoint(mesh_axes=)) wins over this default;
    # an explicit load_decoder(mesh_axes=) wins over both
    "serving_mesh_axes": "",
    # cost-model-driven autotuning (paddle_tpu_torch/autotune). False =
    # every knob is exactly its hand-set FLAGS default; True = tunable
    # knobs (prefill_chunk, spec_k) read through the tuning cache per
    # DEVICE KIND (the FLAGS constants demote to cold-cache defaults),
    # and the executor logs per-shape step timings into it. "auto"
    # serving ladders resolve through the cache either way
    "autotune": False,
    # where the tuning cache persists (tuning_cache.json, atomic
    # tmp-write+rename). Seeded from PADDLE_TPU_AUTOTUNE_DIR; '' =
    # in-memory only. Read once, when the process cache is first created
    # (autotune.get_cache)
    "autotune_dir": os.environ.get("PADDLE_TPU_AUTOTUNE_DIR", ""),
    # serving fleet (paddle_tpu_torch/fleet). Replica lease TTL in
    # seconds: a replica that misses heartbeats for this long is evicted
    # from the routing table (members beat at ttl/3)
    "fleet_lease_ttl": 5.0,
    # router-side load-report cache TTL in seconds: how stale a scraped
    # per-replica load report (free KV pages, queue depths) may be
    # before the next routing decision re-scrapes
    "fleet_scrape_ttl": 0.25,
    # autoscale policy loop (fleet/policy.py): evaluation cadence in
    # seconds; a scale decision needs `fleet_policy_beats` CONSECUTIVE
    # ticks of the same verdict, and after any action the loop holds
    # still for `fleet_policy_cooldown` ticks
    "fleet_policy_interval": 0.5,
    "fleet_policy_beats": 3,
    "fleet_policy_cooldown": 8,
    # scale-UP floors: intent when fleet-wide free KV pages OR queue
    # headroom sits below these for `beats` consecutive ticks
    "fleet_free_page_floor": 8,
    "fleet_headroom_floor": 2,
    # scale-DOWN hysteresis margin: the fleet MINUS the drain victim
    # must retain margin x both scale-up floors (the dead band that
    # keeps a boundary load from flapping the fleet)
    "fleet_scale_margin": 2.0,
    # replica-count bounds the policy loop may never cross
    "fleet_min_replicas": 1,
    "fleet_max_replicas": 4,
    # replica-launcher crash-restart backoff base in seconds (doubles
    # per consecutive crash, capped launcher-side)
    "fleet_launcher_backoff": 0.25,
    # intent signing + deploy-path allowlist (fleet/auth.py). Key '' =
    # open mode (unsigned intents); the PADDLE_TPU_FLEET_KEY env var
    # wins over the flag so launcher-spawned replica subprocesses
    # inherit it. The allowlist is a ':'-separated list of absolute dir
    # prefixes every checkpoint_dir/dirname/draft_checkpoint_dir payload
    # path must resolve under (PADDLE_TPU_FLEET_ALLOW env wins; '' =
    # unrestricted)
    "fleet_intent_key": "",
    # previous fleet key, ACCEPTED (verify-only) during a key rotation
    # window (PADDLE_TPU_FLEET_KEY_PREV env wins)
    "fleet_intent_key_prev": "",
    "fleet_intent_allowlist": "",
})


def set_flags(d: Dict[str, Any]):
    for k, v in d.items():
        if k not in FLAGS:
            raise KeyError(f"unknown flag {k!r}; known: {sorted(FLAGS)}")
        FLAGS[k] = v
        # propagate to the live recorder and fault plan, so set_flags is
        # a complete control surface; each key acts on its own (resizing
        # the buffer does not flip the enable bit, and vice versa)
        if k == "trace":
            if v:
                _tracing.trace_enable(buffer_size=FLAGS["trace_buffer"])
            else:
                _tracing.trace_disable()
        elif k == "trace_buffer":
            _tracing.resize_buffer(int(v))
        elif k == "faults":
            from .distributed import faults as _faults

            if v:
                _faults.install(v)
            else:
                _faults.uninstall()


def get_flag(name: str):
    return FLAGS[name]


def effective_flag(name: str):
    """A tunable knob's EFFECTIVE value: the FLAGS entry is the
    cold-cache default; with FLAGS['autotune'] on, a measured/derived/
    override record for this device kind in the tuning cache wins (each
    resolution counts autotune.cache.hits/misses)."""
    base = FLAGS[name]
    if not FLAGS["autotune"]:
        return base
    from .autotune import tuned_value

    return tuned_value(name, default=base)
