"""Autoregressive decode serving: continuous batching over a paged KV
cache, in PyTorch (the counterpart of ``paddle_tpu/serving/decode.py``).

A request is a SEQUENCE of dependent steps (one per generated token),
each step needs the sequence's whole KV history on the device, and
sequences finish at ragged, data-dependent times. This engine does
CONTINUOUS batching over FIXED batch shapes:

  - the decode batch has a fixed slot layout — slot count padded to a
    small ladder (``FLAGS['decode_slots']``), per-slot page-table width
    padded to a derived ladder, chunk width padded to ``{1, chunk}`` —
    and ``warm()`` runs every (slots, width, chunk) triple at load time.
    The step runs eagerly (the JAX package jits it per shape); the
    ladders are kept exactly, so step counts, padding and
    ``steps_to_first_token`` equal the JAX engine's, and a later CUDA
    graph per shape has its bound;
  - every step consumes up to ``prefill_chunk`` PROMPT tokens plus one
    generated token per decoding slot (chunked prefill, Sarathi-style
    mixed batches): a P-token prompt completes prefill in
    ``ceil(P / prefill_chunk)`` steps, and in-flight decodes never stall
    behind a long prompt. New sequences are admitted into free slots
    BETWEEN steps;
  - K/V live in the preallocated paged pool (kv_cache.py): device memory
    is bounded at construction, pages are reserved at admission (refusal
    is an immediate structured ``ServerOverloaded``) and recycled at
    completion, with prefix caching (copy-on-write tail pages) and
    demand reservation (grow, preempt to host, restore bitwise);
  - attention reads K/V through the page tables with the hand-written
    ragged paged-attention kernel (``kernels/paged_attention.py``) on a
    card, its plain PyTorch version on the CPU.

The model is the spec'd decoder (embedding + N pre-norm transformer
layers + tied-embedding logits, parameters drawn from numpy in
``spec.seed`` — bitwise the JAX package's draws). Parameters are a plain
dict of tensors with the JAX tree's layout; ``params_from_jax`` carries
a JAX parameter tree across.

SPECULATIVE DECODING: with a small DRAFT decoder attached
(``draft_spec``/``draft_params`` + ``spec_k > 0``) every decoding slot
advances up to ``spec_k + 1`` tokens per scheduler round for ONE target
step: the draft proposes ``spec_k`` tokens (a <= 2-lane catch-up chunk,
then single-token steps, on its own ladder), the target verifies all
``k + 1`` positions in one ``decoder_step_chunked(all_lanes=True)``
call, and the committed tokens are the target's own per-(seed,
position) choices along the longest agreeing prefix — the tokens the
non-speculative engine emits. The draft's pool MIRRORS the target's page
geometry (one allocator, the same page ids and tables), so growth,
rejected-suffix rollback (``PageAllocator.shrink``), copy-on-write,
preemption spill and restore stay one mechanism.

THE TYPED WORKLOADS: ``submit(mask=)`` constrains generation to a
``TokenMaskSpec`` language (disallowed logits to -inf before the same
per-(seed, position) choice), ``topk_first`` returns the first generated
position's token order (the beam fork point, ``workloads/beam.py``), and
the EMBEDDINGS lane (``embeddings=True``, ``submit_embed``/``embed``)
runs prompt-only requests through the chunked prefill in slots of its
own — mean-pooled final hidden states and per-token logprobs, no decode
slot taken.

MESH-SHARDED serving (``mesh="tp=2"``, or ``FLAGS['serving_mesh_axes']``):
one engine spans the process group's ranks. Parameters shard per
``mesh.decoder_rules`` (DTensors), the paged pool over the kv-head axis,
K4 runs through ``local_map`` on each rank's kv heads
(``fluid/ops/mesh_ops.paged_attention``), logits come back replicated.
Every rank builds the same engine; rank 0 takes the requests and its
scheduler drives every rank in lockstep (``lockstep.py``). Every engine
feature runs sharded: chunked prefill, prefix caching, preemption,
speculation (the draft shards under the same rules), the typed workloads
and the embed lane.

``slots="auto"`` resolves at load through the autotune layer from the
slot demand every submit records (``decode_slots``); submits and embeds
also record their prompt lengths (``prefill_chunk``), as the JAX engine
does.

Lifecycle mirrors the JAX engine so the SAME ModelRegistry hot-swaps
decoders: ``stop(drain=True)`` finishes every admitted sequence then
drops params and pools; a failed ``warm()`` stops the scheduler before
re-raising so the registry's rollback leaks nothing.
"""
from __future__ import annotations

import math
import threading
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..autotune.ladder import observe as _observe_shape
from ..device import resolve_device
from ..distributed import faults as _faults
from ..flags import FLAGS, effective_flag
from ..kernels.paged_attention import paged_attention
from ..observability import metrics as _metrics, tracing as _tracing
from ..observability.log import get_logger
from .engine import bucket_for as _bucket_for, resolve_bucket_spec
from .errors import (DeadlineExceeded, EngineRetired, RequestTooLarge,
                     ServerOverloaded, ServingError)
from .kv_cache import GARBAGE_PAGE, HostSpillStore, PagedKvCache
from .lockstep import Lockstep, lockstep_for

__all__ = ["DecoderSpec", "DecodeEngine", "build_decoder_params",
           "params_from_jax", "decoder_step", "decoder_step_chunked",
           "width_ladder", "sample_token", "sample_draw_margin",
           "validate_draft_spec"]

_log = get_logger("serving")

_m_requests = _metrics.counter("serving.decode.requests")
_m_admitted = _metrics.counter("serving.decode.admitted")
_m_completions = _metrics.counter("serving.decode.completions")
_m_steps = _metrics.counter("serving.decode.steps")
_m_tokens = _metrics.counter("serving.decode.tokens")
_m_overloads = _metrics.counter("serving.decode.overloads")
_m_deadline_miss = _metrics.counter("serving.decode.deadline_misses")
_m_cancels = _metrics.counter("serving.decode.cancels")
# one inc per DISTINCT (slots, width, chunk) shape the step runs — after
# warm() this must never move again (the name is the JAX package's,
# where each shape is one compile)
_m_compiles = _metrics.counter("serving.decode.compiles")
_m_step_ms = _metrics.histogram("serving.decode.step_ms")
_m_queue_wait = _metrics.histogram("serving.decode.queue_wait_ms")
_m_total = _metrics.histogram("serving.decode.total_ms")
# live slots / slot bucket per step
_m_occupancy = _metrics.histogram("serving.decode.occupancy")
# chunked prefill: prompt tokens consumed via prefill grants, per-step
# grant totals, and how many scheduler steps each request waited for
# its FIRST generated token
_m_prefill_tokens = _metrics.counter("serving.decode.prefill_tokens")
_m_prefill_per_step = _metrics.histogram(
    "serving.decode.prefill_tokens_per_step")
_m_first_token_steps = _metrics.histogram(
    "serving.decode.steps_to_first_token")
# preempt+restore (demand-mode reservation): preemptions spill a
# victim's pages to host and requeue it at the front; restores scatter
# them back bitwise; demotions release a QUEUED reservation
_m_preemptions = _metrics.counter("serving.kv.preemptions")
_m_restores = _metrics.counter("serving.kv.restores")
_m_demotions = _metrics.counter("serving.kv.demotions")
# target-model invocations: one per plain/prefill step AND one per
# verify chunk (warm included)
_m_target_steps = _metrics.counter("serving.decode.target_steps")
# draft-model invocations (propose + prefill shadowing, warm included)
_m_draft_steps = _metrics.counter("serving.decode.spec.draft_steps")
# proposed == accepted + rejected, always; accept_rate observes each
# finished request's ratio
_m_spec_proposed = _metrics.counter("serving.decode.spec.proposed")
_m_spec_accepted = _metrics.counter("serving.decode.spec.accepted")
_m_spec_rejected = _metrics.counter("serving.decode.spec.rejected")
_m_spec_accept_rate = _metrics.histogram(
    "serving.decode.spec.accept_rate")
# the workload layer: tokens chosen under a mask automaton; embed-lane
# requests, steps (warm included) and prompt tokens
_m_masked_tokens = _metrics.counter("serving.decode.masked_tokens")
_m_embed_requests = _metrics.counter("serving.decode.embed.requests")
_m_embed_steps = _metrics.counter("serving.decode.embed.steps")
_m_embed_tokens = _metrics.counter("serving.decode.embed.tokens")


# --- the decoder model --------------------------------------------------

class DecoderSpec:
    """Architecture + identity of a decoder the engine can serve.
    ``d_model == n_heads * head_dim`` (enforced); ``n_heads`` must be a
    multiple of ``n_kv_heads`` (GQA). Params are DETERMINISTIC in
    ``seed`` so two replicas loading the same spec serve bitwise the
    same model — and tests can reference-check outputs."""

    __slots__ = ("vocab", "d_model", "n_layers", "n_heads", "n_kv_heads",
                 "head_dim", "seed", "eos_id")

    def __init__(self, vocab: int = 64, d_model: int = 32,
                 n_layers: int = 2, n_heads: int = 4,
                 n_kv_heads: Optional[int] = None, seed: int = 0,
                 eos_id: Optional[int] = None):
        self.vocab = int(vocab)
        self.d_model = int(d_model)
        self.n_layers = int(n_layers)
        self.n_heads = int(n_heads)
        self.n_kv_heads = int(n_kv_heads if n_kv_heads is not None
                              else n_heads)
        if self.d_model % 2:
            raise ValueError(f"d_model {d_model} must be even "
                             f"(sinusoidal encoding pairs sin/cos halves)")
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {d_model} not divisible by "
                             f"n_heads {n_heads}")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"n_heads {n_heads} not a multiple of "
                             f"n_kv_heads {self.n_kv_heads}")
        self.head_dim = self.d_model // self.n_heads
        self.seed = int(seed)
        self.eos_id = None if eos_id is None else int(eos_id)

    def to_dict(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in
                ("vocab", "d_model", "n_layers", "n_heads", "n_kv_heads",
                 "seed", "eos_id")}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DecoderSpec":
        allowed = ("vocab", "d_model", "n_layers", "n_heads",
                   "n_kv_heads", "seed", "eos_id")
        # reject, don't drop: a misspelled field silently deploying a
        # default-architecture decoder is a wrong-model hot-swap
        # (head_dim is derived — accepted only if consistent)
        unknown = sorted(set(d) - set(allowed) - {"head_dim"})
        if unknown:
            raise ValueError(
                f"unknown DecoderSpec field(s) {unknown}; "
                f"valid: {sorted(allowed)}")
        spec = cls(**{k: v for k, v in d.items() if k in allowed})
        if "head_dim" in d and int(d["head_dim"]) != spec.head_dim:
            raise ValueError(
                f"head_dim {d['head_dim']} contradicts d_model "
                f"{spec.d_model} / n_heads {spec.n_heads} = "
                f"{spec.head_dim} — head_dim is derived, not free")
        return spec


def validate_draft_spec(target: DecoderSpec, draft: DecoderSpec):
    """Cross-validate a speculative DRAFT decoder against its target: a
    mismatched draft must fail at LOAD, typed and naming the field. The
    draft proposes token ids the target scores, so the vocabularies must
    be identical, and termination is decided on committed tokens, so
    eos must agree; everything architectural is free."""
    if draft.vocab != target.vocab:
        raise ValueError(
            f"draft/target DecoderSpec mismatch on field 'vocab': "
            f"draft {draft.vocab} != target {target.vocab} — the draft "
            f"proposes token ids the target must score")
    if draft.eos_id != target.eos_id:
        raise ValueError(
            f"draft/target DecoderSpec mismatch on field 'eos_id': "
            f"draft {draft.eos_id} != target {target.eos_id} — "
            f"termination is decided on committed (target-verified) "
            f"tokens, so the specs must agree on it")


def build_decoder_params(spec: DecoderSpec, device=None) -> Dict[str, Any]:
    """Deterministic parameter dict (seeded numpy draws, scaled-normal
    init) — the same draws in the same order as the JAX package, so the
    tensors are bitwise its arrays. ``device=None`` means the card."""
    dev = resolve_device(device)
    rng = np.random.RandomState(spec.seed)
    dm, dh = spec.d_model, spec.head_dim

    def mat(fan_in, *shape):
        return torch.from_numpy(
            (rng.randn(*shape) / math.sqrt(fan_in)).astype(np.float32)
        ).to(dev)

    def ln():
        return (torch.ones(dm, dtype=torch.float32, device=dev),
                torch.zeros(dm, dtype=torch.float32, device=dev))

    params: Dict[str, Any] = {"tok_emb": mat(dm, spec.vocab, dm),
                              "lnf": ln()}
    for l in range(spec.n_layers):
        params[f"layer{l}"] = {
            "ln1": ln(),
            "wq": mat(dm, dm, spec.n_heads * dh),
            "wk": mat(dm, dm, spec.n_kv_heads * dh),
            "wv": mat(dm, dm, spec.n_kv_heads * dh),
            "wo": mat(dm, spec.n_heads * dh, dm),
            "ln2": ln(),
            "w1": mat(dm, dm, 4 * dm),
            "w2": mat(4 * dm, 4 * dm, dm),
        }
    return params


def params_from_jax(tree, device=None) -> Any:
    """The JAX package's decoder parameter tree (dicts and tuples of
    arrays, as ``paddle_tpu.serving.decode.build_decoder_params`` or a
    checkpoint load returns it) as this package's parameters on
    ``device``: each leaf goes through ``np.asarray`` and lands as a
    float32-preserving torch tensor. The structure is kept as it is."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(params_from_jax(v, dev) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(dev)


def _params_to(tree, device) -> Any:
    if isinstance(tree, dict):
        return {k: _params_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_params_to(v, device) for v in tree)
    return tree.to(device)


def _ln(x, gb):
    g, b = gb
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-6) * g + b


def _pos_encoding(positions, d_model):
    """Sinusoidal [N, d_model] — unbounded positions, no learned table
    to cap sequence length. ``freq`` is computed in float32, as the JAX
    package does."""
    half = d_model // 2
    freq = torch.exp(-math.log(10000.0)
                     * torch.arange(half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions[:, None].to(torch.float32) * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def decoder_step_chunked(params, spec: DecoderSpec, tokens, positions,
                         q_lens, k_pool, v_pool, page_tables, kv_lens,
                         all_lanes: bool = False,
                         return_hidden: bool = False):
    """ONE mixed decode/prefill step for a fixed-slot batch. Each slot
    carries up to C tokens of ITS sequence — a prefill chunk, a single
    decode token at lane 0, or nothing — attending causally within the
    chunk. Writes every valid lane's K/V into the paged pools IN PLACE
    (dead lanes and dead slots write the garbage page), attends through
    the page tables, returns ``(k_pool, v_pool, logits [B, vocab])``.

    tokens/positions: [B, C] integer tensors, lane ``j`` of slot ``i``
    valid iff ``j < q_lens[i]`` (invalid lanes: 0/0 — masked to the
    garbage page, never trusted). kv_lens: [B] int32 — valid keys
    INCLUDING this step's q_len tokens. All tensors live on the pools'
    device.

    Logits come back ONLY for each slot's newest lane (``q_len - 1``) —
    the one position the scheduler ever samples from.
    ``all_lanes=True`` returns every lane's logits ``[B, C, vocab]``
    (the speculative-verify form) and ``return_hidden=True`` (requires
    ``all_lanes``) also the final-norm hidden states ``[B, C, d_model]``
    (the embedding/scoring form)."""
    mesh = _pool_mesh(k_pool)
    if mesh is None:
        return _step_body(params, spec, tokens, positions, q_lens, k_pool,
                          v_pool, page_tables, kv_lens, all_lanes,
                          return_hidden, None)
    from torch.distributed.tensor.experimental import implicit_replication

    # DTensor params and pools: the host-side index tensors join as
    # replicated operands; logits and hidden states come back whole
    with implicit_replication(), warnings.catch_warnings():
        # the one-slot batch's [1] index tensors replicate as any other
        warnings.filterwarnings("ignore", message="Found a non-scalar")
        out = _step_body(params, spec, tokens, positions, q_lens, k_pool,
                         v_pool, page_tables, kv_lens, all_lanes,
                         return_hidden, mesh)
    return out[:2] + tuple(t.full_tensor() for t in out[2:])


def _pool_mesh(pool):
    """The ``DeviceMesh`` of a sharded (DTensor) pool, else None."""
    from torch.distributed.tensor import DTensor

    return pool.device_mesh if isinstance(pool, DTensor) else None


def _step_body(params, spec, tokens, positions, q_lens, k_pool, v_pool,
               page_tables, kv_lens, all_lanes, return_hidden, mesh):
    b, c = tokens.shape
    ps = k_pool.shape[2]
    dm, dh = spec.d_model, spec.head_dim
    dev = tokens.device
    tokens = tokens.long()
    positions = positions.long()
    lane = torch.arange(c, device=dev)[None, :]            # [1, C]
    valid = lane < q_lens.long()[:, None]                  # [B, C]
    # F.embedding: the same rows as indexing, and DTensor's vocab-row
    # sharded lookup under a mesh
    x = F.embedding(tokens, params["tok_emb"]) * math.sqrt(dm) + \
        _pos_encoding(positions.reshape(-1), dm).reshape(b, c, dm)
    page_idx = positions // ps
    # each lane's physical page: its slot's table row at the token's
    # page index. Invalid lanes (j >= q_len, padded dead slots) are
    # FORCED to the garbage page — a live slot's row 0 must never be
    # clobbered by a dead lane's position-0 write
    page = torch.where(valid,
                       torch.gather(page_tables.long(), 1, page_idx),
                       torch.full_like(page_idx, GARBAGE_PAGE))  # [B, C]
    off = torch.where(valid, positions % ps, torch.zeros_like(positions))
    for l in range(spec.n_layers):
        lp = params[f"layer{l}"]
        h = _ln(x, lp["ln1"])
        q = (h @ lp["wq"]).reshape(b, c, spec.n_heads, dh)
        k = (h @ lp["wk"]).reshape(b, c, spec.n_kv_heads, dh)
        v = (h @ lp["wv"]).reshape(b, c, spec.n_kv_heads, dh)
        # write the whole chunk's K/V, THEN attend: within the chunk,
        # query j sees keys i <= j of the same chunk. In place on the
        # pool (duplicate writes only ever hit the garbage page); under
        # a mesh each rank writes and reads its own kv heads
        if mesh is None:
            attn = write_and_attend(q, k, v, k_pool, v_pool, l, page, off,
                                    page_tables, kv_lens, q_lens)
        else:
            from ..fluid.ops import mesh_ops

            attn = mesh_ops.paged_attention(
                mesh, q, k, v, k_pool, v_pool, l, page, off, page_tables,
                kv_lens, q_lens)
        x = x + attn.reshape(b, c, spec.n_heads * dh) @ lp["wo"]
        h2 = _ln(x, lp["ln2"])
        # jax.nn.gelu's default is the tanh approximation
        x = x + F.gelu(h2 @ lp["w1"], approximate="tanh") @ lp["w2"]
    if all_lanes:
        h = _ln(x, params["lnf"])
        logits = h @ params["tok_emb"].T
        if return_hidden:
            return k_pool, v_pool, logits, h
        return k_pool, v_pool, logits
    # unembed only each slot's newest lane (dead slots take lane 0 —
    # garbage the scheduler never samples)
    last = torch.clamp(q_lens.long() - 1, min=0)              # [B]
    x_last = x[torch.arange(b, device=dev), last]             # [B, dm]
    logits = _ln(x_last, params["lnf"]) @ params["tok_emb"].T
    return k_pool, v_pool, logits


def write_and_attend(q, k, v, k_pool, v_pool, layer, page, off,
                     page_tables, kv_lens, q_lens):
    """One layer's pool write and K4: the chunk's K/V rows into pages
    ``page`` at offsets ``off`` of layer ``layer`` (cast to the pool's
    dtype), then ragged paged attention of ``q`` through the tables."""
    k_pool[layer].index_put_((page, off), k.to(k_pool.dtype))
    v_pool[layer].index_put_((page, off), v.to(v_pool.dtype))
    return paged_attention(q, k_pool[layer], v_pool[layer], page_tables,
                           kv_lens, q_lens=q_lens)


def decoder_step(params, spec: DecoderSpec, tokens, positions,
                 k_pool, v_pool, page_tables, kv_lens):
    """The single-token step — the C=1 case of ``decoder_step_chunked``.
    tokens/positions: [B] (dead slots: 0/0 with an all-garbage table
    row); kv_lens: [B] int32 — valid keys INCLUDING this step's token
    (0 = dead slot -> exact-zero attention output). Returns
    ``(k_pool, v_pool, logits [B, vocab])``."""
    q_lens = (kv_lens > 0).to(torch.int32)
    return decoder_step_chunked(
        params, spec, tokens[:, None], positions[:, None], q_lens,
        k_pool, v_pool, page_tables, kv_lens)


# --- sampling -----------------------------------------------------------

def sample_token(logits_row, temperature: float = 0.0, top_k: int = 0,
                 seed: int = 0, position: int = 0) -> int:
    """Sampling policy for ONE generated token: greedy argmax at
    temperature 0 (the default), else temperature-scaled softmax over
    the ``top_k`` highest logits (0 = full vocab), drawn from a numpy
    rng derived ONLY from ``(seed, position)`` — the JAX package's draw,
    bitwise, for the same logits row. Deterministic given the request's
    seed and independent of batch composition, slot assignment, and
    admission order."""
    row = np.asarray(logits_row, np.float64)
    if temperature <= 0.0:
        return int(np.argmax(row))
    p = _sampling_probs(row, temperature, top_k)
    return int(_draw_rng(seed, position).choice(p.size, p=p))


def _sampling_probs(row, temperature, top_k):
    """The temperature-scaled, top-k-masked softmax ``sample_token``
    draws from (float64)."""
    row = row / float(temperature)
    k = int(top_k)
    if 0 < k < row.size:
        kth = np.partition(row, -k)[-k]
        row = np.where(row < kth, -np.inf, row)
    row = row - row.max()
    p = np.exp(row)
    p /= p.sum()
    return p


def _draw_rng(seed, position):
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence(
        [int(seed) & 0xFFFFFFFF, int(position)])))


def sample_draw_margin(logits_row, temperature: float, top_k: int,
                       seed: int, position: int):
    """``sample_token``'s sampled draw on one logits row, with how close
    it came to picking another token: ``(token, margin)``, the margin
    being the distance of the draw's uniform variate from the nearer
    edge of ``token``'s interval of the cumulative distribution. A
    negative margin means the variate lies outside that interval: the
    replay here no longer matches ``sample_token``'s draw."""
    if temperature <= 0.0:
        raise ValueError("sample_draw_margin needs temperature > 0")
    token = sample_token(logits_row, temperature, top_k, seed, position)
    p = _sampling_probs(np.asarray(logits_row, np.float64), temperature,
                        top_k)
    # Generator.choice(p=) draws one uniform and searches the cumsum
    cdf = np.cumsum(p)
    cdf /= cdf[-1]
    u = _draw_rng(seed, position).random()
    lo = cdf[token - 1] if token else 0.0
    return token, float(min(u - lo, cdf[token] - u))


# --- ladders ------------------------------------------------------------

def width_ladder(max_pages: int) -> List[int]:
    """Page-table width buckets: powers of two up to (and always
    including) the worst case — the second padded dimension of the
    decode step's shape."""
    if max_pages < 1:
        raise ValueError(f"max_pages must be >= 1, got {max_pages}")
    out, w = [], 1
    while w < max_pages:
        out.append(w)
        w *= 2
    out.append(max_pages)
    return sorted(set(out))




# --- requests / slots ---------------------------------------------------

class _DecodeRequest:
    __slots__ = ("prompt", "max_new", "deadline", "ev", "result", "error",
                 "t_enq", "seq_id", "trace_ctx", "temperature", "top_k",
                 "seed", "produced", "cached_tokens", "cow", "resume_pos",
                 "published", "carry_steps", "carry_fts", "needs_alloc",
                 "resume_dpos", "spec_proposed", "spec_accepted",
                 "mask", "mask_state", "want_topk", "first_topk")

    def __init__(self, prompt: np.ndarray, max_new: int,
                 deadline: Optional[float], seq_id: int,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 mask: Optional[Any] = None, want_topk: int = 0):
        self.prompt = prompt
        self.max_new = int(max_new)
        self.deadline = deadline
        self.ev = threading.Event()
        self.result: Optional[Dict[str, Any]] = None
        self.error: Optional[BaseException] = None
        self.t_enq = time.monotonic()
        self.seq_id = seq_id
        self.trace_ctx = _tracing.wire_context()
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.seed = int(seed)
        # generated tokens, appended by the answer phase UNDER the
        # engine's _cond — on the REQUEST (not the slot) so streaming
        # readers see tokens the moment they exist
        self.produced: List[int] = []
        # prefix caching + preemption state — on the REQUEST because
        # preemption round-trips a sequence through the queue:
        # cached_tokens = prompt tokens answered from the prefix index;
        # cow = the pending private copy of a shared partial page;
        # resume_pos/carry_* = where a preempted sequence continues;
        # needs_alloc = the reservation was surrendered and admission
        # must re-reserve before taking a slot
        self.cached_tokens = 0
        self.cow: Optional[Dict[str, int]] = None
        self.resume_pos: Optional[int] = None
        self.published = False
        self.carry_steps = 0
        self.carry_fts: Optional[int] = None
        self.needs_alloc = False
        # speculative decoding: the draft pool's valid-write watermark
        # carried through preemption (mirrors resume_pos), and the
        # request's propose/accept tallies
        self.resume_dpos: Optional[int] = None
        self.spec_proposed = 0
        self.spec_accepted = 0
        # constrained decode: a compiled MaskAutomaton and its state, on
        # the request so the state survives preemption; want_topk asks
        # for the FIRST generated position's top-k token order
        # (first_topk) — the beam fork point
        self.mask = mask
        self.mask_state = mask.start if mask is not None else 0
        self.want_topk = int(want_topk)
        self.first_topk: Optional[List[int]] = None

    def fail(self, err: BaseException):
        self.error = err
        self.ev.set()


class _Slot:
    __slots__ = ("req", "pos", "pages_held", "steps", "first_token_steps",
                 "pending_restore", "dpos")

    def __init__(self, req: _DecodeRequest, pages_held: int):
        self.req = req
        self.pos = 0                # tokens already written to the cache
        self.pages_held = pages_held
        self.steps = 0              # scheduler steps this slot has ridden
        self.first_token_steps: Optional[int] = None
        # a preempted sequence's spilled pages must scatter back into
        # its fresh reservation BEFORE its next step (restore-before-
        # step): set at re-admission, executed by _prepare
        self.pending_restore = False
        # positions validly written to the DRAFT pool. Invariant:
        # pos - 1 <= dpos <= pos — the draft lags by at most one
        # committed token (after a fully-accepted round it never fed its
        # own last proposal), so the next round catches up with a <= 2-
        # lane chunk before proposing
        self.dpos = 0

    def token_at(self, idx: int) -> int:
        """The sequence's token at absolute position ``idx``: a prompt
        token, or a previously generated one."""
        p = self.req.prompt
        return (int(p[idx]) if idx < len(p)
                else self.req.produced[idx - len(p)])


class _EmbedRequest:
    """A prompt-only embedding/scoring request: reserved at submit with
    ``max_new = 0`` (exactly the prompt's pages), prefilled by the same
    chunked step, and NEVER occupying a decode slot — the embed lane
    has its own slot list and gauge. Carries ``cow``/``seq_id``/``fail``
    so ``_fail_locked`` treats both request classes alike."""

    __slots__ = ("prompt", "deadline", "ev", "result", "error", "t_enq",
                 "seq_id", "trace_ctx", "cow", "hidden_sum", "logprobs")

    def __init__(self, prompt: np.ndarray, deadline: Optional[float],
                 seq_id: int, d_model: int):
        self.prompt = prompt
        self.deadline = deadline
        self.ev = threading.Event()
        self.result: Optional[Dict[str, Any]] = None
        self.error: Optional[BaseException] = None
        self.t_enq = time.monotonic()
        self.seq_id = seq_id
        self.trace_ctx = _tracing.wire_context()
        self.cow: Optional[Dict[str, int]] = None
        # float64 running sum of final-norm hidden states (mean-pooled
        # at completion) and the per-token logprobs (position p scores
        # prompt[p+1]), both appended by the embed answer phase
        self.hidden_sum = np.zeros(d_model, np.float64)
        self.logprobs: List[float] = []

    def fail(self, err: BaseException):
        self.error = err
        self.ev.set()


class _EmbedSlot:
    __slots__ = ("req", "pos", "pages_held", "steps")

    def __init__(self, req: _EmbedRequest, pages_held: int):
        self.req = req
        self.pos = 0                # prompt tokens already prefilled
        self.pages_held = pages_held
        self.steps = 0


# --- the engine ---------------------------------------------------------

class DecodeEngine:
    """Continuous-batching autoregressive decode over one loaded
    decoder. Registry/server-compatible: ``name``/``version``/``kind``/
    ``stats()``/``stop(drain=)`` mirror the JAX engine, so the same
    ModelRegistry hot-swaps decoders with the same drain guarantee.
    ``device=None`` means the card; it raises when there is none."""

    kind = "decoder"

    def __init__(self, spec: DecoderSpec, *, name: str = "decoder",
                 version: int = 1,
                 slots: Optional[Sequence[int]] = None,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 max_seq_len: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 params: Optional[Dict[str, Any]] = None,
                 prefix_cache: Optional[bool] = None,
                 reservation: Optional[str] = None,
                 spill_dir: Optional[str] = None,
                 draft_spec: Optional[Any] = None,
                 draft_params: Optional[Dict[str, Any]] = None,
                 spec_k: Optional[int] = None,
                 mesh: Optional[Any] = None,
                 mesh_rules: Optional[Any] = None,
                 embeddings: bool = False,
                 warm: bool = True,
                 device=None):
        self.device = resolve_device(device)
        self.name = str(name)
        self.version = int(version)
        self.spec = spec
        # mesh-sharded serving: one replica SPANS the process group's
        # ranks. `mesh` is a MeshSpec / axes dict / "tp=2" string (None
        # reads FLAGS['serving_mesh_axes']; '' = one device). Params
        # shard per name-matched `mesh_rules` (default
        # mesh.decoder_rules) and the paged KV pool over the kv-head axis
        # — the axis the wk/wv rules put on their column dim. Rank 0
        # leads; the other ranks replay its device operations
        mesh_arg = FLAGS["serving_mesh_axes"] if mesh is None else mesh
        self._mesh_spec = None
        self._mesh = None
        self._mesh_rules = None
        self._kv_head_axes = None
        self._lockstep: Optional[Lockstep] = None
        if mesh_arg:
            from ..fluid.parallel_executor import _rank_device
            from ..mesh import (MeshSpec, ShardingRules, decoder_rules,
                                note_mesh)

            self._mesh_spec = MeshSpec.coerce(mesh_arg)
            rules = ShardingRules.coerce(mesh_rules,
                                         default=decoder_rules)
            self._mesh_rules = rules
            self._kv_head_axes = self._kv_pool_axes(rules)
            self._check_kv_divisible("target", spec)
            if isinstance(draft_spec, dict):
                draft_spec = DecoderSpec.from_dict(draft_spec)
            if draft_spec is not None:
                self._check_kv_divisible("draft", draft_spec)
            self._lockstep = lockstep_for(self._mesh_spec, self.device)
            self._mesh = self._lockstep.mesh
            self.device = _rank_device(self.device)
            note_mesh(self._mesh, label=f"decode:{name}.v{version}")
        # shares _step_mu with the step + shape set: the lock serializes
        # every pool touch against retirement's drop
        self._params = self._place_params(
            build_decoder_params(spec, self.device) if params is None
            else params)  # guarded-by: _step_mu
        self._slot_ladder = resolve_bucket_spec(
            FLAGS["decode_slots"] if slots is None else slots,
            tunable_id="decode_slots", fallback="1,2,4")
        self._max_slots = self._slot_ladder[-1]
        ps = int(FLAGS["kv_page_size"] if page_size is None else page_size)
        npages = int(FLAGS["kv_num_pages"] if num_pages is None
                     else num_pages)
        self.max_seq_len = int(FLAGS["decode_max_seq_len"]
                               if max_seq_len is None else max_seq_len)
        self._max_queue = int(FLAGS["serving_max_queue"]
                              if max_queue is None
                              else max_queue)  # guarded-by: _cond
        # prefix caching + reservation policy: demand mode reserves the
        # prompt's pages plus kv_decode_headroom pages at admission and
        # grows mid-decode (preempting when the pool runs dry);
        # worst_case reserves everything up front
        self._prefix_on = bool(FLAGS["prefix_cache"]
                               if prefix_cache is None else prefix_cache)
        reservation = str(FLAGS["kv_reservation"]
                          if reservation is None else reservation)
        if reservation not in ("demand", "worst_case"):
            raise ValueError(
                f"reservation must be 'demand' or 'worst_case', "
                f"got {reservation!r}")
        self._reservation = reservation
        self._headroom_pages = max(0, int(FLAGS["kv_decode_headroom"]))
        self.cache = PagedKvCache(
            spec.n_layers, spec.n_kv_heads, spec.head_dim,
            page_size=ps, num_pages=npages,
            label=f"{self.name}.v{self.version}",
            prefix_cache=self._prefix_on, mesh=self._mesh,
            shard_spec=self._pool_spec(), device=self.device)
        # host refuge for preempted sequences' pages (kv_spill_dir
        # moves it to disk); cleared at retirement — leaks nothing
        self._spill = HostSpillStore(
            spill_dir=spill_dir, label=f"{self.name}.v{self.version}")
        w_max = self.cache.allocator.pages_for_tokens(self.max_seq_len)
        self._width_ladder = width_ladder(w_max)
        # chunked prefill: the per-step prompt-token budget AND the chunk
        # width, clamped to the longest admissible prompt
        # (max_seq_len - 1: max_new >= 1)
        chunk = int(effective_flag("prefill_chunk")
                    if prefill_chunk is None else prefill_chunk)
        self._prefill_chunk = max(1, min(chunk, max(1,
                                                    self.max_seq_len - 1)))
        # pure-decode steps ride the C=1 shapes, steps carrying a
        # prefill grant ride the C=chunk shapes
        self._chunk_ladder = sorted({1, self._prefill_chunk})
        # speculative decoding: spec_k resolves as the JAX engine's does
        # (explicit arg, else the flag; 0 = off). Only an EXPLICIT
        # spec_k without a draft is a caller error — a flag-sourced one
        # leaves draftless engines plain
        if isinstance(draft_spec, dict):
            draft_spec = DecoderSpec.from_dict(draft_spec)
        k_spec = int(effective_flag("spec_k")
                     if spec_k is None else spec_k)
        if k_spec < 0:
            raise ValueError(f"spec_k must be >= 0, got {k_spec}")
        if k_spec > 0 and draft_spec is None and spec_k is not None:
            raise ValueError(
                f"spec_k {k_spec} needs a draft decoder — pass "
                "draft_spec (or draft_checkpoint_dir through the "
                "server)")
        if draft_spec is not None:
            validate_draft_spec(spec, draft_spec)
        if draft_spec is None:
            k_spec = 0
        # the verify chunk writes through pos + k: never past the
        # sequence cap (k_eff clamps per slot; this bounds the ladder)
        self._spec_k = max(0, min(k_spec, self.max_seq_len - 2))
        self._draft_spec = draft_spec if self._spec_k else None
        if self._spec_k:
            self._verify_lanes = self._spec_k + 1
            # draft calls: C=1 singles, a <= 2-lane catch-up chunk after
            # a fully-accepted round, and the prefill chunks it shadows
            self._draft_chunk_ladder = sorted({1, 2, self._prefill_chunk})
            self._draft_params = self._place_params(
                build_decoder_params(draft_spec, self.device)
                if draft_params is None
                else draft_params)  # guarded-by: _step_mu
            self._draft_cache = PagedKvCache(
                draft_spec.n_layers, draft_spec.n_kv_heads,
                draft_spec.head_dim, page_size=ps, num_pages=npages,
                allocator=self.cache.allocator, mesh=self._mesh,
                shard_spec=self._pool_spec(),
                device=self.device)  # guarded-by: _step_mu
        else:
            self._verify_lanes = 0
            self._draft_chunk_ladder = []
            self._draft_params = None  # guarded-by: _step_mu
            self._draft_cache = None  # guarded-by: _step_mu
        # embeddings/scoring lane: opt-in because it warms its own
        # all-lane step family (slots x widths x chunks)
        self._embed_on = bool(embeddings)
        self._cond = threading.Condition()
        self._queue: List[_DecodeRequest] = []  # guarded-by: _cond
        self._slots: List[_Slot] = []  # guarded-by: _cond
        self._embed_queue: List[_EmbedRequest] = []  # guarded-by: _cond
        self._embed_slots: List[_EmbedSlot] = []  # guarded-by: _cond
        self._stopping = False  # guarded-by: _cond
        self._released = False  # guarded-by: _cond
        self._seq_counter = 0  # guarded-by: _cond
        self._n_requests = 0  # guarded-by: _cond
        self._n_steps = 0  # guarded-by: _cond
        self._step_shapes: set = set()  # guarded-by: _step_mu
        self._g_depth = _metrics.gauge(
            f"serving.decode.queue_depth.{self.name}.v{self.version}")
        # per-instance so a draining old version does not clobber the
        # live engine's value
        self._g_live = _metrics.gauge(
            f"serving.decode.live_slots.{self.name}.v{self.version}")
        # embed occupancy is its OWN gauge: embeddings completing with
        # live_slots untouched is the zero-decode-slot proof
        self._g_embed = _metrics.gauge(
            f"serving.decode.embed_slots.{self.name}.v{self.version}")
        # serializes warm() (caller thread) against live steps (the
        # scheduler thread): every pool read/write must be atomic with
        # respect to the other
        self._step_mu = threading.Lock()
        # the leader's spill drops not yet sent to the followers
        self._follower_drops: List[int] = []  # guarded-by: _cond
        # a follower rank: no scheduler; the mesh's replay thread runs the
        # leader's operations until its stop sets this
        self._replayed_stop = threading.Event()
        follower = self._lockstep is not None and not self._lockstep.leader
        self._eid = (self._lockstep.register(self)
                     if self._lockstep is not None else None)
        self._thread = threading.Thread(
            target=self._replayed_stop.wait if follower else self._loop,
            daemon=True, name=f"decode-{self.name}-v{self.version}")
        self._thread.start()
        if warm and not follower:
            try:
                self.warm()
            except BaseException:
                # failed warm is the registry's rollback path: the
                # scheduler thread (and the params/pools it pins) must
                # not outlive the failed deploy
                self.stop(drain=False)
                raise

    # -- public surface ---------------------------------------------------
    @property
    def spec_k(self) -> int:
        """Draft proposals per decoding slot per round (0 = speculation
        off — no draft loaded)."""
        return self._spec_k

    @property
    def draft_spec(self) -> Optional[DecoderSpec]:
        return self._draft_spec

    @property
    def embeddings_enabled(self) -> bool:
        return self._embed_on

    @property
    def prefix_cache_enabled(self) -> bool:
        return self._prefix_on

    @property
    def mesh_spec(self):
        """The MeshSpec this engine spans (None = one device)."""
        return self._mesh_spec

    @property
    def is_follower(self) -> bool:
        """True on a rank other than 0 of a sharded engine: it takes no
        requests and replays rank 0's device operations."""
        return self._lockstep is not None and not self._lockstep.leader

    def _place_params(self, tree):
        """A parameter tree on this engine's device: sharded per the
        mesh rules (each rank cuts its shards from its own copy — every
        rank builds the same tree — so no collective runs), else moved
        whole."""
        tree = _params_to(tree, self.device)
        if self._mesh is None:
            return tree
        from ..mesh import shard_param_tree

        return shard_param_tree(tree, self._mesh, self._mesh_rules,
                                src_data_rank=None)

    @staticmethod
    def _kv_pool_axes(rules):
        """The mesh axes sharding the KV-HEAD dim of the paged pool:
        whatever the rules put on the COLUMN dim of the K projection
        (wk's columns reshape to [kv_heads, head_dim], so a tp-sharded
        wk writes tp-sharded kv heads — the pool must shard the same
        way or every step pays a reshard)."""
        spec = tuple(rules.spec_for("layer0/wk", 2))
        entry = spec[1] if len(spec) > 1 else None
        if entry is None:
            return None
        return tuple(entry) if isinstance(entry, (tuple, list)) \
            else (str(entry),)

    def _kv_shard_degree(self) -> int:
        if not self._kv_head_axes:
            return 1
        for a in self._kv_head_axes:
            # typed here: axis_size would KeyError from deep inside
            # construction, breaking the ValueError discipline every
            # other load_decoder misconfiguration follows
            if a not in self._mesh_spec:
                raise ValueError(
                    f"decoder rules shard kv heads over axis {a!r}, "
                    f"which mesh {self._mesh_spec} does not have — add "
                    "the axis or pass matching mesh_rules")
        return int(np.prod([self._mesh_spec.axis_size(a)
                            for a in self._kv_head_axes]))

    def _check_kv_divisible(self, what: str, spec: DecoderSpec):
        deg = self._kv_shard_degree()
        if deg > 1 and spec.n_kv_heads % deg:
            raise ValueError(
                f"{what} decoder has {spec.n_kv_heads} kv heads, not "
                f"divisible by the mesh kv-head shard degree {deg} "
                f"(axes {self._kv_head_axes} of {self._mesh_spec}) — "
                "resize the mesh or the model's kv heads")

    def _pool_spec(self):
        """PartitionSpec of the paged pools ([layers, pages, page_size,
        kv_heads, head_dim] — kv-head axis sharded, the rest
        replicated); None when unsharded."""
        if self._mesh is None:
            return None
        from ..parallel.api import PartitionSpec

        ax = self._kv_head_axes
        return PartitionSpec(
            None, None, None,
            (ax if ax is None or len(ax) > 1 else ax[0]), None)

    def _device_op(self, op: str, payload: Any, run):
        """Run a device operation. On the leader of a sharded engine it is
        announced to every follower first, with the step count and the
        spill drops since the last message, both under the mesh's lock
        (``lockstep.py``); elsewhere it simply runs."""
        if self._lockstep is None or not self._lockstep.leader:
            return run()
        with self._cond:
            drops, self._follower_drops = self._follower_drops, []
            steps = self._n_steps
        return self._lockstep.issue(self._eid, op, payload, steps, drops,
                                    run)

    def _replay(self, op: str, payload: Any, steps: int, drops):
        """A follower's half: one operation the leader announced, run on
        this rank's shards (called by the mesh's replay thread)."""
        with self._cond:
            # the leader's scheduler-step count, so this rank's
            # serving.decode.steps tracks the leader's
            if steps > self._n_steps:
                _m_steps.inc(steps - self._n_steps)
                self._n_steps = steps
        try:
            if op == "run":
                family, arrays, step_kw = payload
                self._run(family, arrays, **step_kw)
            elif op == "pages":
                cows, restores = payload
                with self._step_mu:
                    self._move_pages(cows, [
                        (pages, self._spill.pop(seq_id))
                        for seq_id, pages in restores])
            elif op == "spill":
                seq_id, pages = payload
                self._spill.put(seq_id, *self._gather_spill(pages))
        except BaseException as e:  # the leader fails the slots
            _log.error("decode follower %s v%d: %s failed: %s: %s",
                       self.name, self.version, op, type(e).__name__, e)
        for seq_id in drops:
            self._spill.drop(seq_id)
        if op == "stop":
            self._replayed_stop.set()

    def _refuse_follower(self):
        if self.is_follower:
            raise ServingError(
                f"decoder '{self.name}' v{self.version} on rank "
                f"{self._lockstep.rank} follows rank 0's scheduler: "
                "requests go to rank 0")

    def warm(self):
        """Run EVERY (slot-count, table-width, chunk) triple once on an
        all-dead synthetic batch (writes land on the garbage page): the
        first use of each shape (cuBLAS handles and heuristics, kernel
        loads, the paged-attention library build) happens at load, not
        under traffic. With a draft attached the ``spec_k + 1`` verify
        entry and the draft's own {1, 2, chunk} ladder run too; with the
        embed lane on, its all-lane + hidden family. A follower rank
        warms by replaying the leader's warm: here it does nothing."""
        if self.is_follower:
            return
        with _tracing.span("serving.decode.warmup", model=self.name,
                           version=self.version):
            for s in self._slot_ladder:
                for w in self._width_ladder:
                    def dead(c):
                        return (np.zeros((s, c), np.int32),
                                np.zeros((s, c), np.int32),
                                np.zeros(s, np.int32),
                                np.full((s, w), GARBAGE_PAGE, np.int32),
                                np.zeros(s, np.int32))

                    for c in self._chunk_ladder:
                        self._run_step_arrays(*dead(c))
                    if self._spec_k:
                        self._run_verify_arrays(*dead(self._verify_lanes))
                        for c in self._draft_chunk_ladder:
                            self._run_draft_arrays(*dead(c))
                    if self._embed_on:
                        for c in self._chunk_ladder:
                            self._run_embed_arrays(*dead(c))

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 16,
               deadline_ms: Optional[float] = None,
               temperature: float = 0.0, top_k: int = 0,
               seed: int = 0, mask: Optional[Any] = None,
               topk_first: int = 0) -> _DecodeRequest:
        """Validate + reserve KV pages + enqueue. All refusals are
        synchronous and typed: ``ServerOverloaded`` (queue full OR page
        pool exhausted), ``RequestTooLarge`` (can't ever fit),
        ``EngineRetired``, ``ValueError`` (bad tokens / bad sampling
        params). ``temperature``/``top_k``/``seed`` select the sampling
        policy per request (``sample_token``; 0.0 = greedy).

        ``mask`` constrains generation to a ``TokenMaskSpec`` language
        (spec object, its wire dict, or a compiled ``MaskAutomaton``):
        disallowed logits go to -inf BEFORE the per-(seed, position)
        choice, and the sequence finishes when the automaton has no
        further transition. ``topk_first`` asks for the first generated
        position's top-k token order in the result (``first_topk``)."""
        self._refuse_follower()
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if int(prompt.min()) < 0 or int(prompt.max()) >= self.spec.vocab:
            raise ValueError(
                f"prompt token ids must be in [0, {self.spec.vocab})")
        max_new = int(max_new_tokens)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        total = int(prompt.size) + max_new
        if total > self.max_seq_len:
            raise RequestTooLarge(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new}) = "
                f"{total} exceeds max_seq_len {self.max_seq_len}")
        if self._reservation == "demand" and \
                self.cache.allocator.pages_for_tokens(total) > \
                self.cache.num_pages - 1:
            # demand mode admits beyond the worst case, so the ONLY hard
            # bound is "could this sequence fit even alone, with everyone
            # else preempted" — refuse up front if not (the growth
            # path's progress guarantee depends on it)
            raise RequestTooLarge(
                f"worst case {total} tokens = "
                f"{self.cache.allocator.pages_for_tokens(total)} pages "
                f"exceeds the whole pool "
                f"({self.cache.num_pages - 1} usable pages)")
        temperature = float(temperature)
        top_k = int(top_k)
        if temperature < 0.0 or not math.isfinite(temperature):
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        topk_first = int(topk_first)
        if topk_first < 0 or topk_first > self.spec.vocab:
            raise ValueError(
                f"topk_first must be in [0, {self.spec.vocab}], got "
                f"{topk_first}")
        automaton = None if mask is None else self._compile_mask(mask)
        deadline = (None if deadline_ms is None
                    else time.monotonic() + float(deadline_ms) / 1e3)
        with self._cond:
            if self._stopping:
                raise EngineRetired(
                    f"decoder '{self.name}' v{self.version} is retiring")
            if len(self._queue) >= self._max_queue:
                _m_overloads.inc()
                raise ServerOverloaded(
                    f"decoder '{self.name}' queue is full "
                    f"({self._max_queue} deep)")
            self._seq_counter += 1
            seq_id = self._seq_counter
            try:
                # reserve NOW: worst_case takes prompt+max_new, demand
                # only the prompt plus a small decode headroom (growth
                # and preemption own the tail). The refusal is typed and
                # side-effect-free either way.
                res = self._reserve_locked(seq_id, prompt, total)
            except ServerOverloaded:
                _m_overloads.inc()
                raise
            req = _DecodeRequest(prompt, max_new, deadline, seq_id,
                                 temperature=temperature, top_k=top_k,
                                 seed=seed, mask=automaton,
                                 want_topk=topk_first)
            req.cached_tokens = res["cached_tokens"]
            req.cow = res["cow"]
            self._queue.append(req)
            self._n_requests += 1
            self._g_depth.set(len(self._queue))
            # instantaneous concurrency demand — what slots="auto"
            # derives its ladder from (observed outside the lock)
            demand = len(self._queue) + len(self._slots)
            self._cond.notify()
        _observe_shape("decode_slots", demand)
        # the prompt-length histogram a prefill_chunk tuner derives its
        # crossover from
        _observe_shape("prefill_chunk", int(prompt.size))
        _m_requests.inc()
        return req

    def _compile_mask(self, mask):
        from .workloads.masks import MaskAutomaton, TokenMaskSpec

        if isinstance(mask, dict):
            mask = TokenMaskSpec.from_dict(mask)
        if isinstance(mask, TokenMaskSpec):
            automaton = mask.compile()
        elif isinstance(mask, MaskAutomaton):
            automaton = mask
        else:
            raise ValueError(
                f"mask must be a TokenMaskSpec, its wire dict, or a "
                f"MaskAutomaton, got {type(mask).__name__}")
        if automaton.max_token() >= self.spec.vocab:
            raise ValueError(
                f"mask names token id {automaton.max_token()}, outside "
                f"this decoder's vocab [0, {self.spec.vocab})")
        if not automaton.allowed(automaton.start, self.spec.vocab).any():
            raise ValueError("mask allows no first token")
        return automaton

    def generate(self, prompt: Sequence[int], max_new_tokens: int = 16,
                 deadline_ms: Optional[float] = None,
                 timeout: float = 300.0, temperature: float = 0.0,
                 top_k: int = 0, seed: int = 0,
                 mask: Optional[Any] = None,
                 topk_first: int = 0) -> Dict[str, Any]:
        """Blocking convenience: submit + wait. Returns
        ``{"tokens": [...], "prompt_len": n, "version": v,
        "steps_to_first_token": k, "cached_tokens": c, ...}``."""
        req = self.submit(prompt, max_new_tokens, deadline_ms=deadline_ms,
                          temperature=temperature, top_k=top_k, seed=seed,
                          mask=mask, topk_first=topk_first)
        return self._wait(req, timeout, "generate")

    def _wait(self, req, timeout: float, what: str) -> Dict[str, Any]:
        if not req.ev.wait(timeout):
            # withdraw before raising: an abandoned sequence must not
            # keep its page reservation or burn further steps.
            # cancel() returning False means the request finished in
            # the wait-vs-cancel window — deliver that result
            if self.cancel(req):
                raise ServingError(
                    f"{what} on '{self.name}' timed out after "
                    f"{timeout}s (decode scheduler wedged?)")
        if req.error is not None:
            raise req.error
        return req.result

    def submit_embed(self, prompt: Sequence[int],
                     deadline_ms: Optional[float] = None
                     ) -> _EmbedRequest:
        """Enqueue a prompt-only embedding/scoring request. Reservation
        is the reserve-at-admission math with ``max_new = 0``: exactly
        the prompt's pages, taken NOW, typed ``ServerOverloaded`` on
        refusal. The request rides the chunked prefill in the embed
        lane and never holds a decode slot."""
        self._refuse_follower()
        if not self._embed_on:
            raise ServingError(
                f"decoder '{self.name}' was loaded without "
                "embeddings=True — the embed lane's step shapes are not "
                "warmed")
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if int(prompt.min()) < 0 or int(prompt.max()) >= self.spec.vocab:
            raise ValueError(
                f"prompt token ids must be in [0, {self.spec.vocab})")
        if int(prompt.size) > self.max_seq_len:
            raise RequestTooLarge(
                f"prompt ({prompt.size}) exceeds max_seq_len "
                f"{self.max_seq_len}")
        deadline = (None if deadline_ms is None
                    else time.monotonic() + float(deadline_ms) / 1e3)
        with self._cond:
            if self._stopping:
                raise EngineRetired(
                    f"decoder '{self.name}' v{self.version} is retiring")
            if len(self._embed_queue) >= self._max_queue:
                _m_overloads.inc()
                raise ServerOverloaded(
                    f"decoder '{self.name}' embed queue is full "
                    f"({self._max_queue} deep)")
            self._seq_counter += 1
            seq_id = self._seq_counter
            try:
                self.cache.allocator.alloc(seq_id, int(prompt.size))
            except ServerOverloaded:
                _m_overloads.inc()
                raise
            req = _EmbedRequest(prompt, deadline, seq_id,
                                self.spec.d_model)
            self._embed_queue.append(req)
            self._n_requests += 1
            self._cond.notify()
        _observe_shape("prefill_chunk", int(prompt.size))
        _m_embed_requests.inc()
        return req

    def embed(self, prompt: Sequence[int],
              deadline_ms: Optional[float] = None,
              timeout: float = 300.0) -> Dict[str, Any]:
        """Blocking convenience: submit_embed + wait. Returns
        ``{"embedding": [d_model floats] (mean-pooled final hidden
        states), "logprobs": [P-1 floats] (position p scores
        prompt[p+1]), "prompt_len": P, "version": v, "steps": n}``."""
        return self._wait(self.submit_embed(prompt, deadline_ms=deadline_ms),
                          timeout, "embed")

    def cancel(self, req, msg: str = "abandoned by caller") -> bool:
        """Withdraw a submitted request whose waiter gave up: frees its
        KV pages now and fails it, so the scheduler drops the slot at
        the next answer phase. A step already in flight still writes
        through the page table it captured BEFORE the free — safe
        because a re-allocated page's every position is rewritten by its
        new owner in the same step that first attends to it
        (write-before-attend); the NEXT table build degrades the
        canceled row to the garbage page. Returns False if the request
        already finished."""
        with self._cond:
            if req.ev.is_set():
                return False
            if isinstance(req, _EmbedRequest):
                if req in self._embed_queue:
                    self._embed_queue.remove(req)
            elif req in self._queue:
                self._queue.remove(req)
                self._g_depth.set(len(self._queue))
            _m_cancels.inc()
            self._fail_locked(req, ServingError(
                f"generate on '{self.name}' canceled: {msg}"))
            self._cond.notify_all()
            return True

    def stream_tokens(self, req: _DecodeRequest, offset: int,
                      timeout: float = 30.0) -> Dict[str, Any]:
        """Incremental token read for streaming generate: block until
        the sequence has tokens past ``offset`` (or it finished / failed
        / the wait lapses), then return everything past it. A PURE
        FUNCTION of (request state, offset), so a retransmitted stream
        frame is safe to answer from the dedup cache OR by re-execution.

        Returns ``{"tokens", "offset", "next_offset", "done"}`` plus
        ``"result"`` once done; a failed request re-raises its typed
        error. A timeout with no new tokens returns an empty chunk with
        ``done=False`` — the caller polls again."""
        offset = int(offset)
        if offset < 0:
            raise ValueError(f"stream offset must be >= 0, got {offset}")
        deadline = time.monotonic() + float(timeout)
        with self._cond:
            while len(req.produced) <= offset and not req.ev.is_set():
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                # lint: allow-blocking — a bounded reader wait on the
                # engine's own condition; the answer phase notifies on
                # every step that produced a token
                self._cond.wait(remaining)
            toks = [int(t) for t in req.produced[offset:]]
            done = req.ev.is_set()
            err = req.error
            result = req.result
        if done and err is not None:
            raise err
        out: Dict[str, Any] = {"tokens": toks, "offset": offset,
                               "next_offset": offset + len(toks),
                               "done": done}
        if done:
            out["result"] = result
        return out

    def set_max_queue(self, n: int):
        with self._cond:
            self._max_queue = max(1, int(n))

    def stop(self, drain: bool = True, timeout: float = 300.0):
        """Refuse new work; ``drain`` completes every admitted AND
        queued sequence first (the hot-swap drain guarantee), else all
        are failed with EngineRetired. Then params and pools (the
        draft's too) are dropped so retirement releases the device
        memory. On a follower rank of a sharded engine ``stop`` waits
        (up to ``timeout``) for the leader's own stop to end the
        replay, then releases this rank's shards."""
        with self._cond:
            self._stopping = True
            if not drain:
                gone = f"decoder '{self.name}' v{self.version} unloaded"
                for r in self._queue + self._embed_queue:
                    self._fail_locked(r, EngineRetired(gone))
                self._queue.clear()
                self._embed_queue.clear()
                for s in self._slots + self._embed_slots:
                    # a slot completed mid-step may still be listed
                    # (removal happens under _cond after the step) —
                    # never overwrite a delivered result
                    if not s.req.ev.is_set():
                        self._fail_locked(s.req, EngineRetired(gone))
                    else:
                        self.cache.allocator.free(s.req.seq_id)
                self._slots = []
                self._embed_slots = []
                self._g_depth.set(0)
            self._cond.notify_all()
        self._thread.join(timeout)
        if self._thread.is_alive() and self.is_follower:
            # the replay still runs on this rank's pools: keep them
            raise ServingError(
                f"decoder '{self.name}' v{self.version}: rank 0 did not "
                f"stop its engine within {timeout:.0f} s")
        if self._thread.is_alive():  # pragma: no cover - wedged scheduler
            _log.error("decode scheduler for %s v%d did not exit in %.0fs",
                       self.name, self.version, timeout)
        with self._step_mu:
            self._params = None
            self._draft_params = None
            if self._draft_cache is not None:
                # shared allocator: retire() is idempotent; the draft
                # pool's memory frees with its own k/v drop
                self._draft_cache.release()
                self._draft_cache = None
            self.cache.release()
        # any spills that survived the drain die with the engine
        self._spill.clear()
        with self._cond:
            self._released = True
            self._g_depth.set(0)
            self._g_live.set(0)
            self._g_embed.set(0)

    def stats(self) -> Dict[str, Any]:
        with self._step_mu:
            shapes = sorted(self._step_shapes)
        with self._cond:
            return {
                "name": self.name,
                "version": self.version,
                "kind": self.kind,
                "device": str(self.device),
                "spec": self.spec.to_dict(),
                "slots": list(self._slot_ladder),
                "table_widths": list(self._width_ladder),
                "prefill_chunk": self._prefill_chunk,
                "chunk_ladder": list(self._chunk_ladder),
                "page_size": self.cache.page_size,
                "max_seq_len": self.max_seq_len,
                "reservation": self._reservation,
                "spec_k": self._spec_k,
                "draft": (self._draft_spec.to_dict()
                          if self._draft_spec is not None else None),
                "prefix_cache": self._prefix_on,
                "prefix": self.cache.allocator.prefix_stats(),
                "spilled_sequences": self._spill.count(),
                "kv": self.cache.allocator.stats(),
                "queue_depth": len(self._queue),
                "live": len(self._slots),
                "embeddings": self._embed_on,
                "embed_queue": len(self._embed_queue),
                "live_embed": len(self._embed_slots),
                "max_queue": self._max_queue,
                "requests": self._n_requests,
                "steps": self._n_steps,
                # distinct step shapes run (the JAX engine's compiled
                # shapes); never grows after warm()
                "compiled_shapes": shapes,
                "stopping": self._stopping,
                "mesh": (dict(self._mesh_spec.axes)
                         if self._mesh_spec is not None else None),
            }

    # -- scheduler --------------------------------------------------------
    def _reserve_locked(self, seq_id: int, prompt, total: int
                        ) -> Dict[str, Any]:
        """One reservation under the engine's policy: demand = prompt
        pages + decode headroom (capped at the worst case), worst_case
        = everything. Prefix caching maps the cached chain read-only
        either way. Raises ``ServerOverloaded`` side-effect-free."""
        if self._reservation == "demand":
            reserve = min(total, len(prompt)
                          + self._headroom_pages * self.cache.page_size)
        else:
            reserve = total
        if self._prefix_on:
            return self.cache.allocator.alloc_prefix(seq_id, prompt,
                                                     reserve)
        self.cache.allocator.alloc(seq_id, reserve)
        return {"cached_tokens": 0, "cow": None}

    def _fail_locked(self, req, err: BaseException):
        self.cache.allocator.free(req.seq_id)
        if req.cow is not None:
            # the COW source pin must not outlive the request
            self.cache.allocator.release_cow(req.cow["key"])
            req.cow = None
        # a preempted request's host spill dies with it (the followers'
        # shares with their next message)
        self._spill.drop(req.seq_id)
        if self._lockstep is not None:
            self._follower_drops.append(req.seq_id)
        req.fail(err)

    def _drop_expired_locked(self, now: float):
        for queue in (self._queue, self._embed_queue):
            keep = []
            for r in queue:
                if r.deadline is not None and now > r.deadline:
                    _m_deadline_miss.inc()
                    self._fail_locked(r, DeadlineExceeded(
                        f"request to decoder '{self.name}' missed its "
                        "deadline while queued"))
                else:
                    keep.append(r)
            queue[:] = keep
        self._g_depth.set(len(self._queue))

    def _admit_locked(self):
        """Move queued requests into free slots whenever a slot is free
        — INTO the in-flight batch. A request whose reservation was
        surrendered (preempted victims sit at the queue FRONT, demoted
        reservations wherever they were) must re-reserve first; a
        refusal leaves it queued. Embed requests fill the embed lane's
        own slots (reserved at submit: admission is bookkeeping)."""
        while self._queue and len(self._slots) < self._max_slots:
            req = self._queue[0]
            if req.ev.is_set():
                # canceled / expired while queued — already failed
                self._queue.pop(0)
                continue
            if req.needs_alloc:
                total = len(req.prompt) + req.max_new
                try:
                    if req.resume_pos is not None:
                        # restore-before-step: cover what was spilled
                        # plus the decode headroom; prefix matching is
                        # deliberately NOT consulted — the spill is the
                        # bitwise truth
                        reserve = min(total, max(req.resume_pos, 1)
                                      + self._headroom_pages
                                      * self.cache.page_size)
                        self.cache.allocator.alloc(req.seq_id, reserve)
                    else:
                        res = self._reserve_locked(req.seq_id,
                                                   req.prompt, total)
                        req.cached_tokens = res["cached_tokens"]
                        req.cow = res["cow"]
                except ServerOverloaded:
                    break
                req.needs_alloc = False
            self._queue.pop(0)
            slot = _Slot(req,
                         self.cache.allocator.held_pages(req.seq_id))
            if req.resume_pos is not None:
                slot.pos = req.resume_pos
                # the draft pool restores from the same spill; its
                # watermark resumes where preemption froze it
                slot.dpos = (req.resume_dpos
                             if req.resume_dpos is not None
                             else req.resume_pos)
                slot.pending_restore = True
                req.resume_pos = None
                req.resume_dpos = None
            else:
                # cached prompt pages are already written (and mapped)
                # in BOTH pools: prefill starts at the first uncached
                # token
                slot.pos = req.cached_tokens
                slot.dpos = req.cached_tokens
            slot.steps = req.carry_steps
            slot.first_token_steps = req.carry_fts
            self._slots.append(slot)
            _m_admitted.inc()
            _m_queue_wait.observe((time.monotonic() - req.t_enq) * 1e3)
        while self._embed_queue and \
                len(self._embed_slots) < self._max_slots:
            ereq = self._embed_queue.pop(0)
            if ereq.ev.is_set():
                continue
            self._embed_slots.append(_EmbedSlot(
                ereq, self.cache.allocator.held_pages(ereq.seq_id)))
            _m_admitted.inc()
            _m_queue_wait.observe((time.monotonic() - ereq.t_enq) * 1e3)
        self._g_depth.set(len(self._queue))
        self._g_live.set(len(self._slots))
        self._g_embed.set(len(self._embed_slots))

    def _next_live(self
                   ) -> Optional[Tuple[List[_Slot], List[_EmbedSlot]]]:
        # lint: allow-blocking — Condition.wait on the engine's own
        # condition is the scheduler's idle state by design
        with self._cond:
            while True:
                self._drop_expired_locked(time.monotonic())
                self._admit_locked()
                if self._slots or self._embed_slots:
                    return list(self._slots), list(self._embed_slots)
                queued = self._queue or self._embed_queue
                if self._stopping and not queued:
                    return None
                # idle blocks untimed on submit()/stop() notifies; the
                # timed wait survives only for a non-empty queue, whose
                # deadlines need the poll
                self._cond.wait(0.05 if queued else None)

    def _loop(self):
        while True:
            nxt = self._next_live()
            if nxt is None:
                # drained (or failed by stop(drain=False)): release the
                # followers' replay
                self._device_op("stop", None, lambda: None)
                return
            live, elive = nxt
            try:
                if live:
                    self._step(live)
                if elive:
                    # the embed lane runs AFTER the decode step each
                    # round: decode tokens never stall behind scoring
                    self._embed_step(elive)
            except BaseException as e:  # a broken step fails ITS slots
                _log.error("decode step on %s v%d failed: %s: %s",
                           self.name, self.version, type(e).__name__, e)
                err = (e if isinstance(e, ServingError) else
                       ServingError(f"{type(e).__name__}: {e}"))
                with self._cond:
                    for s in live + elive:
                        if not s.req.ev.is_set():
                            self._fail_locked(s.req, err)
                    self._slots = [s for s in self._slots
                                   if s not in live]
                    self._embed_slots = [s for s in self._embed_slots
                                         if s not in elive]
                    self._g_live.set(len(self._slots))
                    self._g_embed.set(len(self._embed_slots))
                    self._cond.notify_all()

    def _run(self, family: str, arrays, **step_kw):
        """One model call of ``family`` (target, verify, draft, embed),
        shared by warm() and live steps: announced to the followers of a
        sharded engine, then run under the step mutex (``_run_locked``).
        Returns what follows the pools: the logits, and with
        ``return_hidden`` the hidden states."""
        with self._step_mu:
            return self._device_op(
                "run", (family, arrays, step_kw),
                lambda: self._run_locked(family, arrays, step_kw))

    def _run_locked(self, family, arrays, step_kw):
        """Note a DISTINCT shape (tagged with its family whenever a second
        family exists, as the JAX engine tags its compiled shapes), move
        the host arrays to the device and run the step (it updates the
        family's pools in place). Caller holds ``_step_mu``."""
        counter = _m_draft_steps if family == "draft" else \
            _m_embed_steps if family == "embed" else _m_target_steps
        tokens, positions, q_lens, tables, lens = arrays
        if family == "draft":
            params, spec, cache = (self._draft_params, self._draft_spec,
                                   self._draft_cache)
        else:
            params, spec, cache = self._params, self.spec, self.cache
        key = (len(tokens), tables.shape[1], tokens.shape[1])
        if family != "target" or self._spec_k or self._embed_on:
            key = (family,) + key
        if key not in self._step_shapes:
            self._step_shapes.add(key)
            _m_compiles.inc()
        counter.inc()
        dev = self.device
        with torch.no_grad():
            out = decoder_step_chunked(
                params, spec, *(torch.from_numpy(a).to(dev) for a in
                                (tokens, positions, q_lens)),
                cache.k, cache.v, torch.from_numpy(tables).to(dev),
                torch.from_numpy(lens).to(dev), **step_kw)
        cache.rebind(out[0], out[1])
        return out[2] if len(out) == 3 else out[2:]

    def _run_step_arrays(self, *arrays):
        """The target's plain/prefill step: newest-lane logits [B, V]."""
        return self._run("target", arrays)

    def _run_verify_arrays(self, *arrays):
        """The speculative-verify target call: same pools, all-lane
        logits ``[B, C, vocab]`` (C = spec_k + 1). One target step
        scores every proposal plus the bonus position."""
        return self._run("verify", arrays, all_lanes=True)

    def _run_draft_arrays(self, *arrays):
        """One DRAFT step (propose singles, catch-up chunks, prefill
        shadowing) against the mirrored draft pool — the same page
        tables as the target, newest-lane logits."""
        return self._run("draft", arrays)

    def _run_embed_arrays(self, *arrays):
        """One EMBED step: the all-lane + hidden form against the target
        pool — every lane's logits ``[B, C, vocab]`` (per-token scoring)
        and final-norm hidden states ``[B, C, d_model]`` (pooling)."""
        return self._run("embed", arrays, all_lanes=True,
                         return_hidden=True)

    def _prepare(self, live: List[_Slot]
                 ) -> Tuple[List[_Slot], List[int]]:
        """Pre-step phase (scheduler thread): execute pending COW copies
        and preemption restores (device writes under ``_step_mu``, in
        both pools), then grow demand-mode reservations to cover this
        step's grants, preempting/demoting when the pool runs dry.
        Returns the (possibly shrunk) live list and its grants."""
        cows: List[Tuple[int, int]] = []
        restores = []
        restored: List[Tuple[int, List[int]]] = []
        spills: Dict[int, Any] = {}
        for s in live:
            if s.pending_restore:
                s.pending_restore = False
                # pop (disk-backed spills np.load) stays outside _cond
                spills[s.req.seq_id] = self._spill.pop(s.req.seq_id)
        with self._cond:
            # request state (cow, pages, spill ownership) is mutated by
            # cancel()/_fail_locked under _cond — read it under _cond too
            for s in live:
                if s.req.ev.is_set():
                    # canceled: pages already freed and any spill
                    # dropped; the slot rides one last garbage-table step
                    continue
                spill = spills.get(s.req.seq_id)
                if spill is not None:
                    pages = self.cache.allocator.pages_of(s.req.seq_id)
                    restores.append((pages[:spill[0].shape[1]], spill))
                    restored.append((s.req.seq_id, restores[-1][0]))
                    _m_restores.inc()
                if s.req.cow is not None:
                    cows.append((s.req.cow["src"], s.req.cow["dst"]))
                    # released before the device copy runs: safe, the
                    # scheduler thread issues every device write, so an
                    # evicted-and-reused src page cannot be rewritten
                    # before copy_pages below reads it
                    self.cache.allocator.release_cow(s.req.cow["key"])
                    s.req.cow = None
        if cows or restores:
            with self._step_mu:
                # the followers copy the same pages and restore their own
                # shares of the spills
                self._device_op("pages", (cows, restored),
                                lambda: self._move_pages(cows, restores))
        while True:
            grants = self._grants(live)
            grower = None
            for s, g in zip(live, grants):
                if s.req.ev.is_set():
                    continue  # canceled: pages gone, rides one last
                    # step through the garbage table, answered nowhere
                need = self.cache.allocator.pages_for_tokens(s.pos + g)
                if need > s.pages_held:
                    grower = (s, need - s.pages_held)
                    break
            if grower is None:
                return live, grants
            s, n = grower
            try:
                self.cache.allocator.grow(s.req.seq_id, n)
                s.pages_held += n
                continue
            except ServerOverloaded:
                pass
            if self._reclaim_for_growth(s, live):
                continue
            # nothing reclaimable: the submit-time worst-case-fits-pool
            # check makes this unreachable unless an external allocator
            # user pins pages — fail typed rather than corrupt
            with self._cond:
                if not s.req.ev.is_set():
                    _m_overloads.inc()
                    self._fail_locked(s.req, ServerOverloaded(
                        f"KV pool exhausted mid-decode for seq "
                        f"{s.req.seq_id} with nothing left to preempt "
                        "— external pages pinned?"))
                self._slots = [x for x in self._slots if x is not s]
                self._g_live.set(len(self._slots))
            live = [x for x in live if x is not s]
            if not live:
                return live, []

    def _move_pages(self, cows, restores):
        """COW copies and spill restores into both pools (caller holds
        ``_step_mu``): the draft pool mirrors every page move — a COW
        tail or restored spill must be valid in BOTH pools."""
        self.cache.copy_pages(cows)
        if self._draft_cache is not None:
            self._draft_cache.copy_pages(cows)
        for pages, spill in restores:
            if spill is None:
                continue
            self.cache.scatter_pages(pages, spill[0], spill[1])
            if self._draft_cache is not None and len(spill) == 4:
                self._draft_cache.scatter_pages(pages, spill[2], spill[3])

    def _gather_spill(self, pages):
        """A preemption's page contents (caller may not hold
        ``_step_mu``): ``(k, v)``, plus the mirrored draft pool's."""
        with self._step_mu:
            arrays = self.cache.gather_pages(pages)
            if self._draft_cache is not None:
                arrays = arrays + self._draft_cache.gather_pages(pages)
        return arrays

    def _reclaim_for_growth(self, grower: _Slot,
                            live: List[_Slot]) -> bool:
        """Make pages available for a live slot's growth: demote the
        newest QUEUED reservation first (it has no computed work to
        lose), else preempt the newest live slot other than the grower
        (spill + requeue at the front). Mutates ``live`` in place when
        it preempts. False = nothing left to take."""
        with self._cond:
            for req in reversed(self._queue):
                if req.ev.is_set() or req.needs_alloc:
                    continue
                self.cache.allocator.free(req.seq_id)
                if req.cow is not None:
                    self.cache.allocator.release_cow(req.cow["key"])
                    req.cow = None
                req.cached_tokens = 0
                req.needs_alloc = True
                _m_demotions.inc()
                return True
        victim = None
        for s in reversed(live):
            if s is grower or s.req.ev.is_set():
                continue
            victim = s
            break
        if victim is None:
            return False
        self._preempt(victim)
        live.remove(victim)
        return True

    def _preempt(self, victim: _Slot):
        """Spill the victim's written pages to host (bitwise, the
        mirrored draft pool's with them in one put), free its
        reservation, and requeue it at the FRONT so preemption cannot
        become starvation. Restore scatters the spill into a fresh
        reservation and the page table rebinds — the sequence's K/V
        round-trips exactly."""
        _faults.fire("serving.decode.preempt")
        req = victim.req
        with _tracing.span("serving.decode.preempt", model=self.name,
                           version=self.version, seq=req.seq_id,
                           tokens=victim.pos):
            pages = self.cache.allocator.pages_of(req.seq_id)
            # only committed tokens spill: victim.pos is the post-
            # rollback watermark, so a speculative round's rejected
            # writes never reach the host
            n_keep = (self.cache.allocator.pages_for_tokens(victim.pos)
                      if victim.pos else 0)
            if n_keep:
                # every follower spills its share of the same pages
                arrays = self._device_op(
                    "spill", (req.seq_id, pages[:n_keep]),
                    lambda: self._gather_spill(pages[:n_keep]))
                # put (disk-backed spills savez) stays outside the
                # step mutex, same as the pop side in _prepare
                self._spill.put(req.seq_id, *arrays)
            self.cache.allocator.free(req.seq_id)
            _m_preemptions.inc()
            with self._cond:
                self._slots = [x for x in self._slots if x is not victim]
                if req.ev.is_set():
                    # canceled/stopped while we spilled: nothing will
                    # resume — drop the spill, leak nothing
                    self._spill.drop(req.seq_id)
                    if self._lockstep is not None:
                        self._follower_drops.append(req.seq_id)
                else:
                    req.resume_pos = victim.pos
                    req.resume_dpos = victim.dpos
                    req.carry_steps = victim.steps
                    req.carry_fts = victim.first_token_steps
                    req.needs_alloc = True
                    self._queue.insert(0, req)
                    self._g_depth.set(len(self._queue))
                self._g_live.set(len(self._slots))

    def _k_eff(self, s: _Slot) -> int:
        """Draft proposals this slot can use THIS round: capped by
        spec_k and by how many tokens the sequence may still commit (a
        verify round commits up to k_eff + 1, which must not overshoot
        max_new). Masked requests never ride speculation: the draft
        proposes from unmasked logits."""
        if not self._spec_k or s.req.ev.is_set() or \
                s.pos < len(s.req.prompt) or s.req.mask is not None:
            return 0
        total = len(s.req.prompt) + s.req.max_new
        return max(0, min(self._spec_k, total - s.pos - 2))

    def _grants(self, live: List[_Slot]) -> List[int]:
        """Token-budget scheduling (Sarathi-style): every slot past its
        prompt gets its one decode token unconditionally — in-flight
        decodes NEVER stall behind a prompt — while slots still in
        prefill share a per-step budget of ``prefill_chunk`` prompt
        tokens, granted in slot order. Every prefill slot is guaranteed
        at least one token per step, so the budget caps the CHUNKS, not
        progress. With speculation on a decoding slot's grant is the
        positions its VERIFY chunk writes, ``1 + k_eff``, so demand-
        mode growth covers the whole speculative write range first."""
        budget = self._prefill_chunk
        grants = []
        for s in live:
            remaining_prompt = len(s.req.prompt) - s.pos
            if remaining_prompt > 0:
                g = max(1, min(remaining_prompt, budget))
                budget = max(0, budget - g)
            else:
                g = 1 + self._k_eff(s)
            grants.append(g)
        return grants

    def _choose(self, row, req: _DecodeRequest, position: int) -> int:
        """THE deterministic per-(seed, position) token choice on one
        logits row: greedy argmax at temperature 0, else the seeded
        ``sample_token`` draw. Draft proposals AND the verify acceptance
        walk both use it, so a committed token is always what the
        non-speculative engine would emit at that position from those
        logits."""
        if req.temperature <= 0.0:
            return int(np.argmax(row))
        return sample_token(row, req.temperature, req.top_k, req.seed,
                            position)

    def _masked_choice(self, req: _DecodeRequest, row,
                       position: int) -> Tuple[int, bool]:
        """Constrained decode's per-token core: disallowed lanes to
        -inf, THE SAME per-(seed, position) choice the unconstrained
        path makes, then advance the automaton. Returns ``(token,
        exhausted)``; exhausted = no further transition — the sequence
        finishes regardless of max_new."""
        allowed = req.mask.allowed(req.mask_state, self.spec.vocab)
        masked = np.where(allowed, np.asarray(row, np.float64), -np.inf)
        tok = self._choose(masked, req, position)
        ns = req.mask.step(req.mask_state, tok)
        # an allowed token always has a transition; a dead step of a
        # buggy automaton counts as exhaustion
        if ns is None:
            return tok, True
        req.mask_state = ns
        _m_masked_tokens.inc()
        return tok, not req.mask.allowed(ns, self.spec.vocab).any()

    def _check_reservation(self, s: _Slot, end_tokens: int):
        """The reservation (grown by _prepare in demand mode) must cover
        every write a step performs. A real raise, not an assert:
        writing through a page index past the reservation would corrupt
        another sequence's pages. Canceled slots are exempt — their
        table row is all-garbage, so their writes land on the garbage
        page by construction."""
        if not s.req.ev.is_set() and \
                end_tokens > s.pages_held * self.cache.page_size:
            raise ServingError(
                f"chunk grant escaped seq {s.req.seq_id}'s page "
                f"reservation ({end_tokens} tokens > "
                f"{s.pages_held} pages x {self.cache.page_size})")

    @staticmethod
    def _batch(s_bucket: int, c: int):
        return (np.zeros((s_bucket, c), np.int32),
                np.zeros((s_bucket, c), np.int32),
                np.zeros(s_bucket, np.int32), np.zeros(s_bucket, np.int32))

    def _spec_substep(self, slots: List[_Slot], w_bucket: int
                      ) -> Dict[int, Tuple[List[int], int, int]]:
        """Propose-then-verify for this round's DECODING slots. The
        draft runs ``k`` batched steps on its own ladder — one catch-up
        chunk (the committed tokens it hasn't ingested, <= 2 lanes,
        ending with the pending token) that yields proposal d_1, then
        k-1 singles — and the target verifies all k+1 positions in ONE
        all-lane chunked call. Acceptance is the deterministic walk:
        lane j's target choice either equals proposal d_{j+1} (accept,
        continue) or replaces it (the bonus/correction token, stop).
        Returns {id(slot): (committed tokens, k_eff, accepted)} for the
        answer phase; nothing here touches request/slot state."""
        _faults.fire("serving.decode.spec")
        s_bucket = _bucket_for(self._slot_ladder, len(slots))
        keff = [self._k_eff(s) for s in slots]
        for s, ke in zip(slots, keff):
            # the verify chunk writes positions pos .. pos+ke
            self._check_reservation(s, s.pos + ke + 1)
        tables = self.cache.table_array(
            [s.req.seq_id for s in slots], w_bucket, rows=s_bucket)
        proposals: List[List[int]] = [[] for _ in slots]
        with _tracing.span("serving.decode.spec.draft", model=self.name,
                           version=self.version, slots=s_bucket,
                           k=self._spec_k):
            # catch-up + first proposal: feed each slot the committed
            # tokens its draft pool lacks (positions dpos..pos — the
            # last is the pending token), newest-lane logits -> d_1
            gaps = [s.pos - s.dpos for s in slots]
            c1 = _bucket_for(self._draft_chunk_ladder,
                             max(g + 1 for g in gaps))
            tokens, positions, q_lens, lens = self._batch(s_bucket, c1)
            for i, s in enumerate(slots):
                if keff[i] < 1:
                    continue  # bonus-only slot: no proposals needed
                g = gaps[i] + 1
                for j in range(g):
                    tokens[i, j] = s.token_at(s.dpos + j)
                    positions[i, j] = s.dpos + j
                q_lens[i] = g
                lens[i] = s.dpos + g        # == s.pos + 1
            if int(q_lens.max(initial=0)) > 0:
                lg = self._run_draft_arrays(
                    tokens, positions, q_lens, tables, lens).cpu().numpy()
                for i, s in enumerate(slots):
                    if keff[i] >= 1:
                        proposals[i].append(self._choose(
                            lg[i], s.req, s.pos + 1))
                # singles: feed d_{j-1}, propose d_j
                for j in range(2, self._spec_k + 1):
                    if not any(ke >= j for ke in keff):
                        break
                    tokens, positions, q_lens, lens = self._batch(
                        s_bucket, 1)
                    for i, s in enumerate(slots):
                        if keff[i] >= j:
                            tokens[i, 0] = proposals[i][j - 2]
                            positions[i, 0] = s.pos + j - 1
                            q_lens[i] = 1
                            lens[i] = s.pos + j
                    lg = self._run_draft_arrays(
                        tokens, positions, q_lens, tables,
                        lens).cpu().numpy()
                    for i, s in enumerate(slots):
                        if keff[i] >= j:
                            proposals[i].append(self._choose(
                                lg[i], s.req, s.pos + j))
        # verify: ONE target call over [pending, d_1..d_k] at the FIXED
        # spec_k+1 chunk entry; lane j's logits are the target's
        # distribution for position pos+1+j
        with _tracing.span("serving.decode.spec.verify",
                           model=self.name, version=self.version,
                           slots=s_bucket, lanes=self._verify_lanes):
            tokens, positions, q_lens, lens = self._batch(
                s_bucket, self._verify_lanes)
            for i, s in enumerate(slots):
                tokens[i, 0] = s.token_at(s.pos)
                positions[i, 0] = s.pos
                for j, d in enumerate(proposals[i]):
                    tokens[i, 1 + j] = d
                    positions[i, 1 + j] = s.pos + 1 + j
                q_lens[i] = 1 + keff[i]
                lens[i] = s.pos + 1 + keff[i]
            lg = self._run_verify_arrays(
                tokens, positions, q_lens, tables,
                lens).cpu().numpy()                      # [B, C, V]
        out: Dict[int, Tuple[List[int], int, int]] = {}
        for i, s in enumerate(slots):
            committed: List[int] = []
            accepted = 0
            for j in range(keff[i] + 1):
                choice = self._choose(lg[i, j], s.req, s.pos + 1 + j)
                committed.append(choice)
                if j < keff[i] and proposals[i][j] == choice:
                    accepted += 1      # d_{j+1} accepted — keep going
                else:
                    break              # bonus/correction token: stop
            out[id(s)] = (committed, keff[i], accepted)
        return out

    def _step(self, live: List[_Slot]):
        # named chaos seam for the scheduler cadence (a
        # `delay@serving.decode.step:*=0.004` plan simulates a slow
        # decoder; `error@` fails the step's slots)
        _faults.fire("serving.decode.step")
        # restore-before-step, COW copies, demand-mode growth (may
        # preempt/demote — the returned live list is authoritative)
        live, grants = self._prepare(live)
        if not live:
            return
        # split the round: decoding slots with a draft attached ride the
        # propose/verify path; prefill chunks (and everything when
        # speculation is off) ride the chunked step
        spec_rows = [i for i, s in enumerate(live)
                     if self._spec_k and not s.req.ev.is_set()
                     and s.pos >= len(s.req.prompt)
                     and s.req.mask is None]
        spec_set = set(spec_rows)
        plain_rows = [i for i in range(len(live)) if i not in spec_set]
        w_need = max(s.pages_held for s in live)
        w_bucket = _bucket_for(self._width_ladder, w_need)
        prefill_toks = sum(grants[i] for i in plain_rows
                           if live[i].pos < len(live[i].req.prompt))
        t0 = time.perf_counter()
        logits_np = sampled = None
        plain_row_of: Dict[int, int] = {}
        spec_out: Dict[int, Tuple[List[int], int, int]] = {}
        # one decode step joins the OLDEST live request's trace (a span
        # has one parent); per-slot request spans live in the server
        with _tracing.adopt(live[0].req.trace_ctx), \
                _tracing.span("serving.decode.step", model=self.name,
                              version=self.version, width=w_bucket,
                              prefill_tokens=prefill_toks,
                              spec_slots=len(spec_rows),
                              live=len(live)):
            if plain_rows:
                ps_slots = [live[i] for i in plain_rows]
                ps_grants = [grants[i] for i in plain_rows]
                s_bucket = _bucket_for(self._slot_ladder, len(ps_slots))
                # pure-decode steps (and 1-token prefill tails) ride the
                # C=1 shapes; only steps carrying a real chunk pay the
                # chunk
                c_bucket = _bucket_for(self._chunk_ladder,
                                       max(max(ps_grants), 1))
                tokens, positions, q_lens, lens = self._batch(
                    s_bucket, c_bucket)
                for i, (s, g) in enumerate(zip(ps_slots, ps_grants)):
                    plain_row_of[id(s)] = i
                    for j in range(g):
                        tokens[i, j] = s.token_at(s.pos + j)
                        positions[i, j] = s.pos + j
                    q_lens[i] = g
                    # keys INCLUDING this chunk; within it, query j
                    # attends only keys up to its own position
                    lens[i] = s.pos + g
                    self._check_reservation(s, int(lens[i]))
                tables = self.cache.table_array(
                    [s.req.seq_id for s in ps_slots], w_bucket,
                    rows=s_bucket)
                logits = self._run_step_arrays(tokens, positions,
                                               q_lens, tables, lens)
                if self._spec_k:
                    # the draft shadows every prefill chunk so its
                    # mirrored pool tracks the committed sequence
                    # (logits discarded; its watermark advances in the
                    # answer phase with pos)
                    self._run_draft_arrays(tokens, positions, q_lens,
                                           tables, lens)
                # the one host read of the step: [B, vocab] float32 — it
                # synchronizes with the device
                logits_np = logits.cpu().numpy()
                # the greedy fast path for the whole batch; per-request
                # sampling policies resolve per slot below
                sampled = np.argmax(logits_np, axis=-1)
            if spec_rows:
                spec_out = self._spec_substep(
                    [live[i] for i in spec_rows], w_bucket)
        _m_step_ms.observe((time.perf_counter() - t0) * 1e3)
        _m_steps.inc()
        _m_occupancy.observe(
            len(live) / float(_bucket_for(self._slot_ladder, len(live))))
        _m_prefill_per_step.observe(prefill_toks)
        if prefill_toks:
            _m_prefill_tokens.inc(prefill_toks)
        with self._cond:
            self._n_steps += 1
        now = time.monotonic()
        done: List[_Slot] = []
        # the whole answer phase holds _cond: stop(drain=False) fails
        # requests under _cond, so check-ev-then-answer must be atomic
        # with it or the two sides can each answer the same request
        notes: Dict[int, int] = {}
        produced_any = False
        n_proposed = n_accepted = 0
        with self._cond:
            for i, s in enumerate(live):
                if s.req.ev.is_set():
                    # already answered (stop(drain=False) or cancel
                    # raced this step) — don't double-answer
                    done.append(s)
                    continue
                s.steps += 1
                finished = False
                if id(s) in spec_out:
                    committed, ke, acc = spec_out[id(s)]
                    pos_old = s.pos
                    s.req.spec_proposed += ke
                    s.req.spec_accepted += acc
                    n_proposed += ke
                    n_accepted += acc
                    for tok in committed:
                        s.pos += 1
                        s.req.produced.append(tok)
                        produced_any = True
                        _m_tokens.inc()
                        if s.first_token_steps is None:
                            s.first_token_steps = s.steps
                            _m_first_token_steps.observe(s.steps)
                        if (len(s.req.produced) >= s.req.max_new
                                or (self.spec.eos_id is not None
                                    and tok == self.spec.eos_id)):
                            # tokens past an accepted eos are discarded:
                            # the committed walk ends here
                            finished = True
                            break
                    if ke > 0 and not finished:
                        # draft validity watermark: the draft wrote
                        # through pos_old+ke-1 and tokens are committed
                        # through pos_old+acc — a fully-accepted round
                        # leaves it one token behind, anything else
                        # re-syncs
                        s.dpos = pos_old + min(ke - 1, acc) + 1
                    if not finished and self._reservation == "demand":
                        # ROLLBACK: any page grown for this verify chunk
                        # that now holds ONLY rejected positions goes
                        # straight back to the pool; coverage for the
                        # pending token's next write (pos itself) stays
                        need = self.cache.allocator.pages_for_tokens(
                            s.pos + 1)
                        if s.pages_held > need:
                            s.pages_held -= self.cache.allocator.shrink(
                                s.req.seq_id, s.pages_held - need)
                else:
                    g = grants[i]    # >= 1: every live slot progresses
                    s.pos += g
                    if self._prefix_on and not s.req.published and \
                            s.pos >= len(s.req.prompt):
                        # prompt K/V fully on the device as of THIS step:
                        # publish the prompt pages into the prefix index
                        # (metadata only; from here they are immutable)
                        self.cache.allocator.publish(s.req.seq_id,
                                                     s.req.prompt)
                        s.req.published = True
                    if self._spec_k:
                        # the draft shadowed this chunk lane for lane
                        s.dpos = s.pos
                    tok = None
                    mask_done = False
                    if s.pos >= len(s.req.prompt):
                        # logits_np[row] is the slot's newest lane:
                        # prompt token P-1 when the chunk just finished
                        # prefill, else the decode token. s.pos is the
                        # new token's absolute index — the (seed,
                        # position) pair
                        row = plain_row_of[id(s)]
                        if s.req.want_topk and s.req.first_topk is None:
                            # the beam fork point: the first generated
                            # position's token order by logit, stable-
                            # sorted so ties break deterministically
                            order = np.argsort(
                                -np.asarray(logits_np[row], np.float64),
                                kind="stable")
                            s.req.first_topk = [
                                int(t) for t in order[:s.req.want_topk]]
                        if s.req.mask is not None:
                            tok, mask_done = self._masked_choice(
                                s.req, logits_np[row], s.pos)
                        else:
                            tok = (int(sampled[row])
                                   if s.req.temperature <= 0.0
                                   else sample_token(
                                       logits_np[row], s.req.temperature,
                                       s.req.top_k, s.req.seed, s.pos))
                        s.req.produced.append(tok)
                        produced_any = True
                        _m_tokens.inc()
                        if s.first_token_steps is None:
                            s.first_token_steps = s.steps
                            _m_first_token_steps.observe(s.steps)
                    finished = (len(s.req.produced) >= s.req.max_new
                                or mask_done
                                or (tok is not None
                                    and self.spec.eos_id is not None
                                    and tok == self.spec.eos_id))
                notes[s.req.seq_id] = s.pos
                if finished:
                    # finished beats a lapsed deadline: the result is
                    # fully paid for — deliver it rather than discard
                    done.append(s)
                    self._complete(s)
                elif s.req.deadline is not None and now > s.req.deadline:
                    _m_deadline_miss.inc()
                    done.append(s)
                    self._fail_locked(s.req, DeadlineExceeded(
                        f"request to decoder '{self.name}' lapsed "
                        f"mid-decode after {len(s.req.produced)} tokens"))
            # one allocator-lock round-trip for the whole step; seqs
            # freed by _complete/_fail above are skipped inside
            self.cache.allocator.note_tokens_many(notes)
            if done:
                self._slots = [s for s in self._slots if s not in done]
                self._g_live.set(len(self._slots))
            if done or produced_any:
                # wake completion waiters AND streaming readers
                self._cond.notify_all()
        if n_proposed:
            _m_spec_proposed.inc(n_proposed)
            _m_spec_accepted.inc(n_accepted)
            _m_spec_rejected.inc(n_proposed - n_accepted)

    def _complete(self, s: _Slot):
        self.cache.allocator.free(s.req.seq_id)
        _m_completions.inc()
        _m_total.observe((time.monotonic() - s.req.t_enq) * 1e3)
        req = s.req
        req.result = {
            "tokens": list(req.produced),
            "prompt_len": int(len(req.prompt)),
            "version": self.version,
            # scheduler steps from admission to the first generated
            # token (ceil(P/chunk) + co-riding; for a prefix-cache hit
            # the suffix takes the prompt's place)
            "steps_to_first_token": int(s.first_token_steps or s.steps),
            # prompt tokens answered from the prefix index (0 = cold)
            "cached_tokens": int(req.cached_tokens),
            # draft proposals this request saw and the share the target
            # accepted (None = no speculative round touched it)
            "spec_proposed": int(req.spec_proposed),
            "spec_accepted": int(req.spec_accepted),
            "accept_rate": (round(req.spec_accepted / req.spec_proposed, 4)
                            if req.spec_proposed else None),
        }
        if req.want_topk:
            # the beam fork point rides the result only when asked for
            req.result["first_topk"] = list(req.first_topk or [])
        if req.spec_proposed:
            _m_spec_accept_rate.observe(req.spec_accepted
                                        / req.spec_proposed)
        req.ev.set()

    # -- the embed lane ---------------------------------------------------
    def _embed_step(self, live: List[_EmbedSlot]):
        """One chunked-prefill step for the embedding/scoring lane: the
        same token budget, page tables and ladders as generation, but
        the all-lane + hidden step form, and nothing is sampled — every
        lane feeds the pooled-hidden accumulator and the per-token
        logprobs. Decode slots are untouched (a separate slot list)."""
        _faults.fire("serving.decode.embed")
        budget = self._prefill_chunk
        grants = []
        for s in live:
            remaining = len(s.req.prompt) - s.pos
            g = max(1, min(remaining, budget))
            budget = max(0, budget - g)
            grants.append(g)
        s_bucket = _bucket_for(self._slot_ladder, len(live))
        c_bucket = _bucket_for(self._chunk_ladder, max(grants))
        w_bucket = _bucket_for(self._width_ladder,
                               max(s.pages_held for s in live))
        tokens, positions, q_lens, lens = self._batch(s_bucket, c_bucket)
        with self._cond:
            for i, (s, g) in enumerate(zip(live, grants)):
                if s.req.ev.is_set():
                    continue  # canceled: pages freed, all-garbage row
                for j in range(g):
                    tokens[i, j] = int(s.req.prompt[s.pos + j])
                    positions[i, j] = s.pos + j
                q_lens[i] = g
                lens[i] = s.pos + g
                if int(lens[i]) > s.pages_held * self.cache.page_size:
                    raise ServingError(
                        f"embed chunk grant escaped seq "
                        f"{s.req.seq_id}'s page reservation")
        tables = self.cache.table_array(
            [s.req.seq_id for s in live], w_bucket, rows=s_bucket)
        t0 = time.perf_counter()
        with _tracing.adopt(live[0].req.trace_ctx), \
                _tracing.span("serving.decode.embed", model=self.name,
                              version=self.version, width=w_bucket,
                              live=len(live)):
            logits, hidden = self._run_embed_arrays(
                tokens, positions, q_lens, tables, lens)
            logits_np = logits.cpu().numpy()  # [B, C, vocab]
            hidden_np = hidden.cpu().numpy()  # [B, C, d_model]
        _m_step_ms.observe((time.perf_counter() - t0) * 1e3)
        now = time.monotonic()
        done: List[_EmbedSlot] = []
        notes: Dict[int, int] = {}
        with self._cond:
            self._n_steps += 1
            for i, s in enumerate(live):
                if s.req.ev.is_set():
                    done.append(s)
                    continue
                s.steps += 1
                g = grants[i]
                prompt = s.req.prompt
                s.req.hidden_sum += np.asarray(
                    hidden_np[i, :g], np.float64).sum(axis=0)
                lg = np.asarray(logits_np[i, :g], np.float64)
                # float64 log-softmax per lane; lane j (absolute
                # position pos+j) scores the NEXT prompt token — the
                # final lane has no successor inside the prompt
                mx = lg.max(axis=-1)
                lse = mx + np.log(np.exp(lg - mx[:, None]).sum(axis=-1))
                for j in range(g):
                    nxt = s.pos + j + 1
                    if nxt < len(prompt):
                        s.req.logprobs.append(
                            float(lg[j, int(prompt[nxt])] - lse[j]))
                s.pos += g
                _m_embed_tokens.inc(g)
                notes[s.req.seq_id] = s.pos
                if s.pos >= len(prompt):
                    done.append(s)
                    self._complete_embed(s)
                elif s.req.deadline is not None and now > s.req.deadline:
                    _m_deadline_miss.inc()
                    done.append(s)
                    self._fail_locked(s.req, DeadlineExceeded(
                        f"embed request to decoder '{self.name}' "
                        f"lapsed mid-prefill at {s.pos} tokens"))
            self.cache.allocator.note_tokens_many(notes)
            if done:
                self._embed_slots = [s for s in self._embed_slots
                                     if s not in done]
                self._g_embed.set(len(self._embed_slots))
                self._cond.notify_all()

    def _complete_embed(self, s: _EmbedSlot):
        self.cache.allocator.free(s.req.seq_id)
        _m_completions.inc()
        _m_total.observe((time.monotonic() - s.req.t_enq) * 1e3)
        p = len(s.req.prompt)
        s.req.result = {
            "embedding": [float(x) for x in s.req.hidden_sum / p],
            "logprobs": list(s.req.logprobs),
            "prompt_len": p,
            "version": self.version,
            "steps": int(s.steps),
        }
        s.req.ev.set()
