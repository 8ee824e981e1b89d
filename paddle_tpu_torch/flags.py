"""Runtime flags of the port — the keys its ported paths read,
with the same cold defaults as ``paddle_tpu/fluid/flags.py``. There is
no kernel-routing flag: a kernel wrapper routes on its tensor's device
alone (a CPU tensor takes the plain PyTorch version, a CUDA tensor the
hand-written kernel)."""
from __future__ import annotations

from typing import Any, Dict

__all__ = ["FLAGS", "set_flags", "get_flag", "effective_flag"]

FLAGS: Dict[str, Any] = {
    # numeric precision of float32 matmuls and convolutions in a run of
    # the Executor, the JAX package's flag: 'highest' = full float32
    # products (TF32 off in cuBLAS and cuDNN, whatever the caller's
    # torch settings); 'high' and 'default' leave the caller's torch
    # settings as they are (TF32 where the caller allowed it)
    "matmul_precision": "highest",
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
}


def set_flags(d: Dict[str, Any]):
    for k, v in d.items():
        if k not in FLAGS:
            raise KeyError(f"unknown flag {k!r}; known: {sorted(FLAGS)}")
        FLAGS[k] = v


def get_flag(name: str):
    return FLAGS[name]


def effective_flag(name: str):
    """A tunable knob's effective value. The JAX package reads these
    through a per-device tuning cache; until the autotune layer is
    ported the cold FLAGS default is the answer."""
    return FLAGS[name]
