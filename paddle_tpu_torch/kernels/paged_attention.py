"""Ragged paged attention for decode serving — single-token decode AND
multi-token prefill chunks.

K/V live in a paged pool (``serving/kv_cache.py``) and attention reads
them THROUGH per-sequence page tables, so one batch shape serves every
ragged length mix up to ``table_width * page_size`` tokens. A slot may
carry a CHUNK of ``q_len in [0, C]`` query tokens (a slice of its
prompt) attending causally within the chunk: query ``j`` of the chunk
sees keys up to absolute position ``kv_len - q_len + j``.

Layouts (the same as ``paddle_tpu/fluid/ops/pallas_kernels/
paged_attention.py``):

    q            [B, Hq, D]            single token per slot, OR
                 [B, C, Hq, D]         a chunk of C query tokens/slot
    q_lens       [B] int32             valid query tokens per slot
                                       (chunked form only; 0 = dead)
    k/v_pages    [P, page_size, Hkv, D]   the shared page pool
    page_tables  [B, W] int32          page ids per slot, GARBAGE-padded
    kv_lens      [B] int32             valid keys per slot INCLUDING
                                       this call's q_len tokens

GQA: ``Hq % Hkv == 0``; query head h attends kv head ``h // (Hq/Hkv)``.
Dead slots (q_lens == 0, or kv_lens == 0 in the single-token form)
produce exact zeros; so do dead query lanes ``j >= q_len`` of a live
slot.

Two implementations of the same function:

  - ``paged_attention_reference`` — the plain PyTorch version: gather
    ``k_pages[tables]``, repeat for GQA, mask, dense softmax. The CPU
    tests run it, and ``chip_smoke.py`` holds the kernel against it.
  - ``_paged_attention_cuda`` — the hand-written Hopper kernels in
    ``paddle_tpu_torch/csrc/paged_attention.cu`` (float32 or bfloat16
    pages, widened to float32 as they load; float32 or bfloat16 q, the
    output in q's dtype; float32 arithmetic; any head_dim; above 256 on a CUDA-core path whose blocks each compute
    one 256-column slice of the output), built by ``nvcc`` at first use
    and bound with ``ctypes``: split-K over each slot's keys in fixed splits of
    ``SPLIT_KEYS`` (a partial softmax state per split, into a scratch
    allocated here), then a merge kernel that combines a row's partials
    in a fixed order. One call of the C entry point launches both and
    counts as one launch.

``paged_attention`` routes on the tensor's device ONLY: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel or raises.
``counts`` tallies both (``kernel_launches[name]`` once per launch,
``plain_calls[name]`` once per plain-version call through the router,
``name`` ``KERNEL`` for float32 pages and ``KERNEL_BF16`` for bfloat16
pages) so a run can show that its main path went through the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from .counts import LaunchCounts

NEG_INF = -1e30

# keys per split of the kernel's split-K: a slot's keys [s * SPLIT_KEYS,
# (s + 1) * SPLIT_KEYS) form split s whatever the batch, table width or
# chunk, so a slot's output never depends on what else is in the call
SPLIT_KEYS = 256  # chosen by k4_splits.py on an H100 (PERF.md)

__all__ = ["paged_attention", "paged_attention_reference", "counts",
           "KERNEL", "KERNEL_BF16", "NEG_INF", "SPLIT_KEYS", "n_splits",
           "kernel_of"]

KERNEL = "paged_attention_f32"
KERNEL_BF16 = "paged_attention_bf16"
counts = LaunchCounts(KERNEL, KERNEL_BF16)

# the pools' dtypes the kernels take, by kernel name; q and the output
# are float32 or bfloat16 with either
_PAGE_KERNELS = {torch.float32: KERNEL, torch.bfloat16: KERNEL_BF16}


def kernel_of(k_pages) -> str:
    """The kernel (and counts entry) that serves pools of this dtype;
    raises naming any other dtype."""
    try:
        return _PAGE_KERNELS[k_pages.dtype]
    except KeyError:
        raise TypeError(f"paged attention takes float32 or bfloat16 "
                        f"pages, got {k_pages.dtype}") from None


def _check_shapes(q, k_pages, v_pages, page_tables, kv_lens, q_lens):
    if q.ndim not in (3, 4):
        raise ValueError(f"q must be [B, Hq, D] or [B, C, Hq, D], got "
                         f"{tuple(q.shape)}")
    b = q.shape[0]
    c = q.shape[1] if q.ndim == 4 else 1
    hq, d = q.shape[-2], q.shape[-1]
    p, ps, hkv, d2 = k_pages.shape
    if v_pages.shape != k_pages.shape:
        raise ValueError(f"k_pages {tuple(k_pages.shape)} != v_pages "
                         f"{tuple(v_pages.shape)}")
    if d2 != d:
        raise ValueError(f"head_dim mismatch: q has {d}, pages have {d2}")
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads "
                         f"{hkv}")
    if page_tables.ndim != 2 or page_tables.shape[0] != b:
        raise ValueError(f"page_tables {tuple(page_tables.shape)} does "
                         f"not match batch {b}")
    if tuple(kv_lens.shape) != (b,):
        raise ValueError(f"kv_lens {tuple(kv_lens.shape)} != ({b},)")
    if q.ndim == 4:
        if q_lens is None:
            raise ValueError("chunked q [B, C, Hq, D] requires q_lens")
        if tuple(q_lens.shape) != (b,):
            raise ValueError(f"q_lens {tuple(q_lens.shape)} != ({b},)")
    elif q_lens is not None:
        raise ValueError("q_lens only applies to chunked q [B, C, Hq, D]")
    return b, c, hq, d, ps, hkv, page_tables.shape[1]


def _canon_chunked(q, kv_lens, q_lens):
    """Canonicalize both call forms to (q [B, C, Hq, D], q_lens [B]):
    the single-token form is C=1 with one valid query iff the slot is
    live (kv_len > 0)."""
    if q.ndim == 3:
        q = q[:, None]
        # 1 where kv_len > 0, else 0: one device op on int32 lengths
        q_lens = kv_lens.clamp(0, 1).to(torch.int32)
    return q, q_lens


def paged_attention_reference(q, k_pages, v_pages, page_tables, kv_lens,
                              *, q_lens=None,
                              scale: Optional[float] = None):
    """The plain version: gather the pages, mask causally past each
    query's visibility limit, dense softmax in float32 (bf16 pages and
    q widened first). Same signature and semantics as the kernel;
    returns the same rank and dtype as ``q``."""
    b, c, hq, d, ps, hkv, w = _check_shapes(q, k_pages, v_pages,
                                            page_tables, kv_lens, q_lens)
    squeeze = q.ndim == 3
    q, q_lens = _canon_chunked(q, kv_lens, q_lens)
    scale = float(scale) if scale else d ** -0.5
    rep = hq // hkv
    tables = page_tables.long()
    # [B, W, ps, Hkv, D] -> [B, T, Hkv, D], T = W * ps
    k = k_pages[tables].reshape(b, w * ps, hkv, d)
    v = v_pages[tables].reshape(b, w * ps, hkv, d)
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    qf = q.float() * scale
    s = torch.einsum("bchd,bthd->bcht", qf, k.float())
    # chunk-causal visibility: query j (absolute position
    # kv_len - q_len + j) sees keys at positions <= its own; dead
    # lanes (j >= q_len) see nothing -> exact-zero rows
    dev = q.device
    lane = torch.arange(c, device=dev)[None, :]                # [1, C]
    kv_l = kv_lens.long()[:, None]
    q_l = q_lens.long()[:, None]
    limit = kv_l - q_l + lane                                  # [B, C]
    valid = lane < q_l                                         # [B, C]
    t = torch.arange(w * ps, device=dev)[None, None, :]        # [1, 1, T]
    keep = (t <= limit[:, :, None]) & valid[:, :, None]        # [B, C, T]
    keep = keep[:, :, None, :]                                 # [B, C, 1, T]
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m) * keep
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bcht,bthd->bchd", p, v.float())
    tiny = torch.finfo(torch.float32).tiny
    o = (o / torch.clamp(l, min=tiny)).to(q.dtype)
    return o[:, 0] if squeeze else o


def n_splits(table_width: int, page_size: int) -> int:
    """Splits of the kernel's grid: enough for every key slot of a
    table row. Known on the host, so no device value is read."""
    return -(-table_width * page_size // SPLIT_KEYS)


def _paged_attention_cuda(q, k_pages, v_pages, page_tables, kv_lens,
                          *, q_lens=None, scale: Optional[float] = None):
    """Launch the hand-written kernels. Raises on what they do not take:
    a non-CUDA or mixed device, pools other than float32 or bfloat16
    (or K and V of two dtypes), q other than float32 or bfloat16, a
    non-contiguous or misaligned q or pool. Reads no device value on the
    host (no sync)."""
    from ._build import launch

    b, c, hq, d, ps, hkv, w = _check_shapes(q, k_pages, v_pages,
                                            page_tables, kv_lens, q_lens)
    squeeze = q.ndim == 3
    q, q_lens = _canon_chunked(q, kv_lens, q_lens)
    dev = q.device
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("page_tables", page_tables), ("kv_lens", kv_lens),
                    ("q_lens", q_lens)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    kernel = kernel_of(k_pages)
    if v_pages.dtype != k_pages.dtype:
        raise TypeError(f"paged attention takes k_pages and v_pages of one "
                        f"dtype, got {k_pages.dtype} and {v_pages.dtype}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"paged attention kernel takes float32 or bfloat16 "
                        f"q, got {q.dtype}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if not t.is_contiguous():
            raise ValueError(f"paged attention kernel needs a contiguous "
                             f"{name}")
        # rows of 4-column units load as one 16-byte (float32) or 8-byte
        # (bfloat16) access when head_dim % 4 == 0
        if d % 4 == 0 and t.data_ptr() % (4 * t.element_size()):
            raise ValueError(f"paged attention kernel needs {name} aligned "
                             f"to {4 * t.element_size()} bytes")
    scale = float(scale) if scale else d ** -0.5
    # index vectors as contiguous int32 (the engine already hands them
    # over so; other callers pay one small conversion)
    tables = page_tables.to(torch.int32).contiguous()
    kv_l = kv_lens.to(torch.int32).contiguous()
    q_l = q_lens.to(torch.int32).contiguous()
    out = torch.empty((b, c, hq, d), dtype=q.dtype, device=dev)
    # one scratch for each split's partial of every output row: (m, l)
    # pairs, then acc[D] rows; only the splits a row sees are written
    ns = n_splits(w, ps)
    rows = ns * b * c * hq
    scratch = torch.empty(rows * (2 + d), dtype=torch.float32, device=dev)
    launch("paged_attention", kernel, dev, q.data_ptr(), k_pages.data_ptr(),
           v_pages.data_ptr(), tables.data_ptr(), kv_l.data_ptr(),
           q_l.data_ptr(), scratch.data_ptr(), scratch.data_ptr() + 8 * rows,
           out.data_ptr(), b, c, hq, hkv, d, ps, w, SPLIT_KEYS, ns,
           int(q.dtype == torch.bfloat16), scale)
    counts.kernel_launches[kernel] += 1
    return out[:, 0] if squeeze else out


def paged_attention(q, k_pages, v_pages, page_tables, kv_lens,
                    *, q_lens=None, scale: Optional[float] = None):
    """Route on the device of ``q``: the plain version for a CPU tensor,
    the hand-written kernel for a CUDA tensor (which launches or raises
    — there is no fallback). ``q`` may be ``[B, Hq, D]`` (one token per
    slot) or ``[B, C, Hq, D]`` with ``q_lens`` (a prefill chunk per
    slot, causal within the chunk)."""
    if q.device.type == "cpu":
        counts.plain_calls[KERNEL_BF16 if k_pages.dtype == torch.bfloat16
                           else KERNEL] += 1
        return paged_attention_reference(q, k_pages, v_pages, page_tables,
                                         kv_lens, q_lens=q_lens,
                                         scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged attention runs on cpu (plain version) or "
                         f"cuda (kernel), not {q.device}")
    return _paged_attention_cuda(q, k_pages, v_pages, page_tables,
                                 kv_lens, q_lens=q_lens, scale=scale)
