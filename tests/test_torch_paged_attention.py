"""The port's ragged paged attention (paddle_tpu_torch/kernels) against
the JAX package's: its plain PyTorch version is held to the JAX
reference ``paged_attention_reference`` AND to the Pallas kernel run in
interpret mode, on the same seeded numpy inputs.

Tolerance: atol 1e-5, rtol 1e-5 in float32 — the same function, with
sums taken in another order. Dead slots and dead query lanes must be
exactly 0 in every implementation. Cases include head_dim 18 (not a
multiple of 4), 256 (the kernel's largest bucket), 264 (above 256: the
card's wide bodies) and a long context of five key splits.

The hand-written CUDA kernels run only on a card; ``chip_smoke.py``
holds them against the plain version there. Here the router must take
the plain version for CPU tensors and count it, the kernels package
must import with no nvcc in reach, and ``test_split_k_algorithm_emulated``
runs the kernels' split-K algorithm (fixed splits of SPLIT_KEYS keys,
32-key tiles, online softmax in exp2 units, partials merged in split
order) in float32 against the Pallas kernel, and shows that a slot's
rows do not change, bitwise, with the batch around it;
``test_wide_partition_emulated`` does the same for the partition of
head_dim 257-512 (splits of SPLIT_KEYS_WIDE keys; a decode slot's keys
dealt to 8 warps, each with its own online softmax a key, the warps'
states merged in the order 0..7; more live rows in 32-key tiles).
"""
import math
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.fluid.ops.pallas_kernels.paged_attention import (
    _paged_attention_pallas, paged_attention_reference as jax_reference)
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import paged_attention as pa

ATOL = RTOL = 1e-5


def _case(seed, *, B, C, Hq, Hkv, D, ps, W, P, kv_lens, q_lens):
    """Seeded inputs. Tables name live pages for each slot's visible
    keys and the garbage page 0 past them (the engine's padding); a
    dead slot's row is all garbage."""
    rng = np.random.RandomState(seed)
    shape_q = (B, Hq, D) if C is None else (B, C, Hq, D)
    q = rng.randn(*shape_q).astype(np.float32)
    kp = rng.randn(P, ps, Hkv, D).astype(np.float32)
    vp = rng.randn(P, ps, Hkv, D).astype(np.float32)
    kv_lens = np.asarray(kv_lens, np.int32)
    tables = np.zeros((B, W), np.int32)
    for b in range(B):
        n = -(-int(kv_lens[b]) // ps)
        tables[b, :n] = rng.randint(1, P, size=n)
    q_lens = None if q_lens is None else np.asarray(q_lens, np.int32)
    return q, kp, vp, tables, kv_lens, q_lens


CASES = {
    # single-token form: ragged lengths, a dead slot (kv_len 0)
    "single_mha_ps4": dict(B=4, C=None, Hq=4, Hkv=4, D=8, ps=4, W=5, P=20,
                           kv_lens=[1, 7, 0, 20], q_lens=None),
    "single_gqa2_ps16": dict(B=3, C=None, Hq=4, Hkv=2, D=16, ps=16, W=3,
                             P=8, kv_lens=[40, 0, 17], q_lens=None),
    "single_gqa4_ps4": dict(B=3, C=None, Hq=8, Hkv=2, D=8, ps=4, W=6,
                            P=20, kv_lens=[24, 0, 13], q_lens=None),
    # chunked form: ragged q_lens (dead lanes), q_len 0 (dead slot), a
    # chunk crossing a page boundary, a pure-prefill chunk
    "chunk_mha_ps4": dict(B=3, C=6, Hq=4, Hkv=4, D=8, ps=4, W=5, P=20,
                          kv_lens=[20, 5, 0], q_lens=[6, 5, 0]),
    "chunk_gqa2_ps16": dict(B=4, C=5, Hq=4, Hkv=2, D=16, ps=16, W=3, P=10,
                            kv_lens=[33, 5, 40, 9], q_lens=[5, 5, 1, 0]),
    "chunk_gqa4_ps4": dict(B=2, C=8, Hq=8, Hkv=2, D=8, ps=4, W=6, P=20,
                           kv_lens=[23, 8], q_lens=[3, 8]),
    # head_dim not a multiple of 4, and the largest bucket
    "single_gqa2_d18": dict(B=3, C=None, Hq=4, Hkv=2, D=18, ps=4, W=6,
                            P=20, kv_lens=[21, 0, 5], q_lens=None),
    "chunk_mha_d18": dict(B=3, C=5, Hq=2, Hkv=2, D=18, ps=8, W=4, P=12,
                          kv_lens=[30, 5, 0], q_lens=[5, 3, 0]),
    "chunk_gqa2_d256": dict(B=2, C=3, Hq=4, Hkv=2, D=256, ps=8, W=3, P=8,
                            kv_lens=[20, 2], q_lens=[3, 1]),
    # head_dim above 256
    "chunk_gqa2_d264": dict(B=3, C=3, Hq=4, Hkv=2, D=264, ps=8, W=5, P=12,
                            kv_lens=[35, 3, 0], q_lens=[3, 2, 0]),
    "single_mha_d264": dict(B=2, C=None, Hq=2, Hkv=2, D=264, ps=4, W=6,
                            P=14, kv_lens=[0, 22], q_lens=None),
    # a long context: W * ps = 1152 keys, five splits of SPLIT_KEYS
    "chunk_long_ps16": dict(B=4, C=4, Hq=4, Hkv=2, D=16, ps=16, W=72,
                            P=80, kv_lens=[1100, 257, 0, 768],
                            q_lens=[4, 1, 0, 2]),
}


def _dead_mask(case, shape):
    """[B, C] True where a row must be exactly 0."""
    kv = np.asarray(case["kv_lens"])
    if case["q_lens"] is None:
        return (kv == 0)[:, None]
    ql = np.asarray(case["q_lens"])
    return np.arange(shape[1])[None, :] >= ql[:, None]


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_jax_reference_and_pallas(name):
    case = CASES[name]
    q, kp, vp, tables, kv_lens, q_lens = _case(7, **case)
    t = {k: (None if a is None else torch.from_numpy(a))
         for k, a in dict(q=q, kp=kp, vp=vp, tables=tables, kv=kv_lens,
                          ql=q_lens).items()}
    got = pa.paged_attention_reference(
        t["q"], t["kp"], t["vp"], t["tables"], t["kv"],
        q_lens=t["ql"]).numpy()
    jq = None if q_lens is None else jnp.asarray(q_lens)
    ref = np.asarray(jax_reference(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(kv_lens), q_lens=jq))
    pal = np.asarray(_paged_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(kv_lens), q_lens=jq,
        interpret=True))
    assert got.shape == ref.shape == q.shape
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, pal, rtol=RTOL, atol=ATOL)
    g4 = got if got.ndim == 4 else got[:, None]
    dead = _dead_mask(case, g4.shape)
    assert dead.any()
    # dead rows bitwise 0 (not merely close)
    assert np.all(g4[dead] == 0.0)
    assert np.all(np.isfinite(got))


def test_router_takes_plain_version_on_cpu_and_counts_it():
    q, kp, vp, tables, kv_lens, q_lens = _case(3, **CASES["chunk_gqa2_ps16"])
    before_k = pa.counts.kernel_launches[pa.KERNEL]
    before_p = pa.counts.plain_calls[pa.KERNEL]
    args = [torch.from_numpy(a) for a in (q, kp, vp, tables, kv_lens)]
    out = pa.paged_attention(*args, q_lens=torch.from_numpy(q_lens))
    ref = pa.paged_attention_reference(*args,
                                       q_lens=torch.from_numpy(q_lens))
    assert torch.equal(out, ref)
    assert pa.counts.plain_calls[pa.KERNEL] == before_p + 1
    assert pa.counts.kernel_launches[pa.KERNEL] == before_k


def test_shape_checks_refuse_bad_layouts():
    q, kp, vp, tables, kv_lens, _ = _case(1, **CASES["single_mha_ps4"])
    args = [torch.from_numpy(a) for a in (q, kp, vp, tables, kv_lens)]
    with pytest.raises(ValueError, match="q_lens only applies"):
        pa.paged_attention(*args, q_lens=torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="requires q_lens"):
        pa.paged_attention(args[0][:, None], *args[1:])
    with pytest.raises(ValueError, match="not a multiple"):
        pa.paged_attention(args[0][:, :3], *args[1:])
    # head_dim above 256 is taken: the CPU route and the plain version
    # on meta tensors give the output's shape
    wide = torch.ones(4, 4, 264)
    pool = torch.ones(20, 4, 4, 264)
    out = pa.paged_attention(wide, pool, pool, *args[3:])
    assert out.shape == (4, 4, 264)
    meta = [t.to("meta") for t in (wide, pool, pool, *args[3:])]
    assert pa.paged_attention_reference(*meta).shape == (4, 4, 264)


def test_kernels_import_without_nvcc_and_build_fails_clearly(monkeypatch):
    """Importing the kernels starts no build; asking for a build with
    no nvcc in reach names the problem instead of a deep OSError."""
    code = ("import paddle_tpu_torch.kernels as k, "
            "paddle_tpu_torch.kernels._build as b; "
            "print(sorted(b._libs))")
    out = subprocess.run([sys.executable, "-c", code], env={"PATH": ""},
                         capture_output=True, text=True, timeout=120,
                         cwd=_build._PKG + "/..")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "NVCC_FALLBACK", "/nonexistent/nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert _build.kernel_sources() == ["conv_bn_relu", "flash_attention",
                                       "layer_norm", "paged_attention"]


LOG2E = 1.4426950408889634
TILE = 32  # keys a kernel tile stages


def _split_k_emulated(q, kp, vp, tables, kv_lens, q_lens, split=None):
    """The kernels' algorithm on the CPU in float32 (numpy in, torch
    out): each slot's keys in fixed splits of ``split`` keys by absolute
    position; per split, per visible row, an online softmax over 32-key
    tiles in units of s * scale * log2(e) (p = 2^(x - m)), giving a
    partial (m, l, acc); the row's partials merged with weights
    2^(m_s - M), then divided by max(l, FLT_MIN). Dead rows stay exact
    zeros. Each slot is computed on its own, as a kernel block only ever
    reads its own slot. Not emulated: the order of the kernels' float32
    sums inside a tile (lane partials, butterflies, tensor-core
    fragments), which chip_smoke.py holds to the plain version."""
    q = torch.from_numpy(q)
    split = split or pa.split_keys(q.shape[-1])
    squeeze = q.ndim == 3
    if squeeze:
        q = q[:, None]
        q_lens = (np.asarray(kv_lens) > 0).astype(np.int32)
    kp, vp = torch.from_numpy(kp), torch.from_numpy(vp)
    B, C, Hq, D = q.shape
    ps, Hkv = kp.shape[1], kp.shape[2]
    T = tables.shape[1] * ps
    heads = torch.arange(Hq) // (Hq // Hkv)
    c = torch.tensor(D ** -0.5, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    out = torch.zeros_like(q)
    for b in range(B):
        for lane in range(min(int(q_lens[b]), C)):
            limit = min(int(kv_lens[b]) - int(q_lens[b]) + lane, T - 1)
            if limit < 0:
                continue
            parts = []
            for s0 in range(0, limit + 1, split):
                m = torch.full((Hq,), -1e30)
                l = torch.zeros(Hq)
                acc = torch.zeros(Hq, D)
                for t0 in range(s0, min(s0 + split, limit + 1), TILE):
                    t = torch.arange(t0, min(t0 + TILE, limit + 1))
                    pages = torch.from_numpy(tables[b]).long()[t // ps]
                    k = kp[pages, t % ps][:, heads]          # [n, Hq, D]
                    v = vp[pages, t % ps][:, heads]
                    x = torch.einsum("hd,nhd->hn", q[b, lane], k) * c
                    m_new = torch.maximum(m, x.amax(-1))
                    alpha = torch.exp2(m - m_new)
                    p = torch.exp2(x - m_new[:, None])
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[:, None] + torch.einsum(
                        "hn,nhd->hd", p, v)
                    m = m_new
                parts.append((m, l, acc))
            M = torch.stack([pm for pm, _, _ in parts]).amax(0)
            L = torch.zeros(Hq)
            A = torch.zeros(Hq, D)
            for pm, pl, pacc in parts:
                wt = torch.exp2(pm - M)
                L = L + pl * wt
                A = A + pacc * wt[:, None]
            out[b, lane] = A / torch.clamp(L, min=torch.finfo(
                torch.float32).tiny)[:, None]
    return out[:, 0] if squeeze else out


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_k_algorithm_emulated(name):
    """The split-K partition, the per-split online softmax and the
    fixed-order merge compute the Pallas kernel's function within 1e-6
    (float32, unit-scale inputs), dead rows exactly 0. A slot computed
    alone, with its table padded wider (more splits in the grid, none of
    them read), gives bitwise the rows it gives inside the batch."""
    case = CASES[name]
    q, kp, vp, tables, kv_lens, q_lens = _case(7, **case)
    got = _split_k_emulated(q, kp, vp, tables, kv_lens, q_lens).numpy()
    jq = None if q_lens is None else jnp.asarray(q_lens)
    pal = np.asarray(_paged_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(kv_lens), q_lens=jq,
        interpret=True))
    np.testing.assert_allclose(got, pal, rtol=0, atol=1e-6)
    g4 = got if got.ndim == 4 else got[:, None]
    assert np.all(g4[_dead_mask(case, g4.shape)] == 0.0)
    for b in range(q.shape[0]):
        wide = np.concatenate(
            [tables[b:b + 1], np.zeros((1, 2 * pa.SPLIT_KEYS // case["ps"]),
                                       np.int32)], axis=1)
        alone = _split_k_emulated(
            q[b:b + 1], kp, vp, wide, kv_lens[b:b + 1],
            None if q_lens is None else q_lens[b:b + 1]).numpy()
        assert np.array_equal(alone[0], got[b]), b


def test_split_count_comes_from_the_table_width():
    """The grid's split count is known on the host from W * page_size
    (no device read), and covers every key slot of a table row."""
    assert pa.SPLIT_KEYS % TILE == 0
    case = CASES["chunk_long_ps16"]
    assert pa.n_splits(case["W"], case["ps"], case["D"]) >= 4
    for w, ps in ((1, 4), (64, 16), (40, 16), (3, 8), (8, 16)):
        ns = pa.n_splits(w, ps, 64)
        assert (ns - 1) * pa.SPLIT_KEYS < w * ps <= ns * pa.SPLIT_KEYS


def test_kernel_path_reads_no_device_value_on_the_host():
    """The wrapper runs 24 times an engine step: it sizes the grid and
    the scratch from shapes the host knows (W * page_size) and never
    reads a device value, which would synchronize with the card."""
    import inspect

    src = inspect.getsource(pa._paged_attention_cuda) + inspect.getsource(
        pa._canon_chunked) + inspect.getsource(pa.n_splits)
    for call in (".item(", ".cpu(", ".tolist(", ".numpy(", "int(kv",
                 "max()"):
        assert call not in src, call


# head_dim 257-512: the kernels' wide bodies
WIDE_DEC_CAP = 4   # live rows up to which a slot takes the decode body
WIDE_WARPS = 8     # warps of a decode block, one key of each 8 a warp

WIDE_CASES = {
    # decode body: MHA (one live row a kv head), a dead slot, three splits
    "decode_mha_d264": dict(B=3, C=None, Hq=2, Hkv=2, D=264, ps=8, W=40,
                            P=50, kv_lens=[300, 0, 17], q_lens=None),
    # decode body under GQA: 4 query heads a kv head (4 live rows)
    "decode_gqa4_d512": dict(B=2, C=None, Hq=8, Hkv=2, D=512, ps=16, W=20,
                             P=30, kv_lens=[290, 40], q_lens=None),
    # chunked: a 6-row slot (chunk body), a 2-row slot (decode body), a
    # dead slot; GQA 2, head_dim 264 and 512
    "chunk_gqa2_d264": dict(B=3, C=3, Hq=4, Hkv=2, D=264, ps=8, W=40,
                            P=50, kv_lens=[270, 130, 0], q_lens=[3, 1, 0]),
    "chunk_mha_d512": dict(B=3, C=5, Hq=2, Hkv=2, D=512, ps=16, W=20,
                           P=40, kv_lens=[290, 40, 9], q_lens=[5, 2, 1]),
    # an odd head_dim that is not a multiple of 4, page size 3
    "chunk_gqa2_d257_ps3": dict(B=2, C=4, Hq=4, Hkv=2, D=257, ps=3, W=100,
                                P=120, kv_lens=[280, 4], q_lens=[4, 1]),
}


def _wide_emulated(q, kp, vp, tables, kv_lens, q_lens):
    """The wide bodies' algorithm on the CPU in float32 (numpy in, torch
    out), slot by slot and kv head by kv head, as a block reads only its
    own slot: splits of split_keys(D) keys by absolute position; in each,
    a slot of at most WIDE_DEC_CAP live rows (q_len * rep) deals key
    s0 + i to warp i % 8, and each warp keeps its own (m, l, acc) for
    every row, updated a key at a time in units of s * scale * log2(e)
    (rescaled only when m moves, p = 2^(x - m), masked keys p = 0); the
    8 states merge with weights 2^(m_w - M) in the order 0..7. A slot
    with more live rows takes one online softmax over 32-key tiles. The
    splits' partials merge in split order, divided by max(l, FLT_MIN);
    dead rows stay exact zeros. Not emulated: the order of the float32
    sums inside a dot product or a tensor-core fragment."""
    q = torch.from_numpy(q)
    squeeze = q.ndim == 3
    if squeeze:
        q = q[:, None]
        q_lens = (np.asarray(kv_lens) > 0).astype(np.int32)
    kp, vp = torch.from_numpy(kp), torch.from_numpy(vp)
    B, C, Hq, D = q.shape
    ps, Hkv = kp.shape[1], kp.shape[2]
    rep = Hq // Hkv
    T = tables.shape[1] * ps
    split = pa.split_keys(D)
    c = torch.tensor(D ** -0.5, dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    out = torch.zeros_like(q)
    for b in range(B):
        n_live = min(int(q_lens[b]), C) * rep
        if n_live == 0:
            continue
        lanes = torch.arange(n_live) // rep
        lim = torch.clamp(int(kv_lens[b]) - int(q_lens[b]) + lanes,
                          max=T - 1)
        for g in range(Hkv):
            heads = g * rep + torch.arange(n_live) % rep
            qi = q[b, lanes, heads]                            # [n, D]
            parts = []
            for s0 in range(0, int(lim.max()) + 1, split):
                n_keys = min(int(lim.max()) + 1 - s0, split)
                t = torch.arange(s0, s0 + n_keys)
                pages = torch.from_numpy(tables[b]).long()[t // ps]
                k, v = kp[pages, t % ps, g], vp[pages, t % ps, g]
                x = (qi @ k.T) * c                              # [n, keys]
                x = torch.where(t[None, :] <= lim[:, None], x,
                                torch.tensor(float("-inf")))
                if n_live <= WIDE_DEC_CAP:
                    m = torch.full((WIDE_WARPS, n_live), -1e30)
                    l = torch.zeros(WIDE_WARPS, n_live)
                    acc = torch.zeros(WIDE_WARPS, n_live, D)
                    for r0 in range(0, n_keys, WIDE_WARPS):
                        idx = torch.arange(r0, r0 + WIDE_WARPS)
                        ok = idx < n_keys
                        xs = torch.full((WIDE_WARPS, n_live), float("-inf"))
                        xs[ok] = x[:, idx[ok]].T
                        vs = torch.zeros(WIDE_WARPS, D)
                        vs[ok] = v[idx[ok]]
                        up = xs > m
                        alpha = torch.where(up, torch.exp2(m - xs),
                                            torch.ones_like(m))
                        m = torch.where(up, xs, m)
                        l = l * alpha
                        acc = acc * alpha[..., None]
                        p = torch.exp2(xs - m)
                        l = l + p
                        acc = acc + p[..., None] * vs[:, None, :]
                    M = m.amax(0)
                    L = torch.zeros(n_live)
                    A = torch.zeros(n_live, D)
                    for w in range(WIDE_WARPS):
                        wt = torch.exp2(m[w] - M)
                        L = L + l[w] * wt
                        A = A + acc[w] * wt[:, None]
                    parts.append((M, L, A))
                else:
                    m = torch.full((n_live,), -1e30)
                    l = torch.zeros(n_live)
                    acc = torch.zeros(n_live, D)
                    for t0 in range(0, n_keys, TILE):
                        xt = x[:, t0:t0 + TILE]
                        m_new = torch.maximum(m, xt.amax(-1))
                        alpha = torch.exp2(m - m_new)
                        p = torch.exp2(xt - m_new[:, None])
                        l = l * alpha + p.sum(-1)
                        acc = acc * alpha[:, None] + p @ v[t0:t0 + TILE]
                        m = m_new
                    parts.append((m, l, acc))
            # each row merges the splits it sees, in split order
            M = torch.stack([pm for pm, _, _ in parts]).amax(0)
            L = torch.zeros(n_live)
            A = torch.zeros(n_live, D)
            for si, (pm, pl, pacc) in enumerate(parts):
                sees = lim >= si * split
                wt = torch.where(sees, torch.exp2(pm - M),
                                 torch.zeros_like(pm))
                L = L + pl * wt
                A = A + pacc * wt[:, None]
            out[b, lanes, heads] = A / torch.clamp(L, min=tiny)[:, None]
    return out[:, 0] if squeeze else out


@pytest.mark.parametrize("name", sorted(WIDE_CASES))
def test_wide_partition_emulated(name):
    """The head_dim 257-512 partition (the decode body's 8 warp states
    and their fixed-order merge, the chunk body's 32-key tiles, splits of
    SPLIT_KEYS_WIDE keys) computes the Pallas kernel's function within
    1e-6 (float32, unit-scale inputs), dead rows exactly 0; a slot
    computed alone, with its table padded wider, gives bitwise the rows
    it gives inside the batch."""
    case = WIDE_CASES[name]
    q, kp, vp, tables, kv_lens, q_lens = _case(11, **case)
    got = _wide_emulated(q, kp, vp, tables, kv_lens, q_lens).numpy()
    jq = None if q_lens is None else jnp.asarray(q_lens)
    pal = np.asarray(_paged_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(kv_lens), q_lens=jq,
        interpret=True))
    np.testing.assert_allclose(got, pal, rtol=0, atol=1e-6)
    g4 = got if got.ndim == 4 else got[:, None]
    assert np.all(g4[_dead_mask(case, g4.shape)] == 0.0)
    split = pa.split_keys(case["D"])
    assert split == pa.SPLIT_KEYS_WIDE
    for b in range(q.shape[0]):
        wide = np.concatenate(
            [tables[b:b + 1], np.zeros((1, 2 * split // case["ps"] + 1),
                                       np.int32)], axis=1)
        alone = _wide_emulated(
            q[b:b + 1], kp, vp, wide, kv_lens[b:b + 1],
            None if q_lens is None else q_lens[b:b + 1]).numpy()
        assert np.array_equal(alone[0], got[b]), b


def test_wide_split_count_comes_from_head_dim_and_table_width():
    """The split length is a function of head_dim alone (the wide
    length at 257-512, SPLIT_KEYS elsewhere), a multiple of the kernels'
    32-key tiles, and the split count of the grid follows from it and
    W * page_size: no batch, chunk, device value or card enters."""
    import inspect

    assert list(inspect.signature(pa.split_keys).parameters) == ["head_dim"]
    assert list(inspect.signature(pa.n_splits).parameters) == [
        "table_width", "page_size", "head_dim"]
    lo, hi = pa.WIDE_DIMS
    assert (lo, hi) == (257, 512)
    for d in (1, 64, 129, 256, 513, 1024):
        assert pa.split_keys(d) == pa.SPLIT_KEYS
    for d in (257, 264, 300, 384, 511, 512):
        assert pa.split_keys(d) == pa.SPLIT_KEYS_WIDE
    assert pa.SPLIT_KEYS_WIDE % TILE == 0
    assert pa.SPLIT_KEYS_WIDE <= pa.SPLIT_KEYS
    for w, ps in ((1, 4), (64, 16), (40, 16), (3, 8), (100, 3)):
        for d in (64, 264, 512, 600):
            split, ns = pa.split_keys(d), pa.n_splits(w, ps, d)
            assert (ns - 1) * split < w * ps <= ns * split
    # the wide split doubles the grid's splits at W * ps = 1024 keys
    assert pa.n_splits(64, 16, 512) == 1024 // pa.SPLIT_KEYS_WIDE
    assert pa.n_splits(64, 16, 256) == 1024 // pa.SPLIT_KEYS


@pytest.mark.parametrize("d,dtype,nbytes", [
    (64, torch.float32, 16), (18, torch.float32, 4), (257, torch.float32, 4),
    (64, torch.bfloat16, 16), (264, torch.bfloat16, 16),
    (100, torch.bfloat16, 8), (18, torch.bfloat16, 4),
    (257, torch.bfloat16, 2)])
def test_page_copy_width_follows_head_dim(d, dtype, nbytes):
    """The kernel copies a page row in the widest unit its alignment
    allows: float32 16 bytes when head_dim % 4 == 0, else 4; bfloat16 16
    when % 8 == 0, 8 when % 4 == 0, 4 when even, else 2."""
    assert pa.page_copy_bytes(d, dtype) == nbytes


def _c_ternary(expr, D):
    """Evaluate a C chain ``c1 ? v1 : c2 ? v2 : ... : v`` whose
    conditions are Python expressions in D."""
    parts = [x.strip() for x in re.split(r"[?:]", expr)]
    for cond, value in zip(parts[:-1:2], parts[1::2]):
        if eval(cond, {"D": D}):
            return int(value)
    return int(parts[-1])


def test_wide_dims_and_copy_rule_match_the_c_source():
    """The wrapper and the C routing state two rules each: the head_dims
    of the wide bodies (WIDE_DIMS, the split length's band, against
    ``D <= 256`` and ``wide::kMaxD`` in the C dispatch) and the copy
    width of a page row (page_copy_bytes in both, the wrapper checking
    the pools' alignment against its own). They must not drift apart,
    or the split length measured for a body stops matching the body
    that runs."""
    csrc = os.path.join(os.path.dirname(_build.__file__), os.pardir, "csrc")
    with open(os.path.join(csrc, "paged_attention.cu")) as f:
        cu = f.read()
    with open(os.path.join(csrc, "paged_wide.cuh")) as f:
        cuh = f.read()
    (max_d,) = re.findall(r"constexpr int kMaxD = (\d+);", cuh)
    # the last bucket of the split kernel, then the wide bodies, then
    # paged_wide_kernel
    (split_max,) = re.findall(
        r"else if \(D <= (\d+)\)\s*e = vec \? args\(launch<\1, true, TK>\)"
        r" : args\(launch<\1, false, TK>\);\s*else if \(D <= wide::kMaxD\)"
        r"\s*e = args\(wide::launch<TK>\);\s*else\s*e = "
        r"args\(launch_wide<TK>\);", cu)
    assert pa.WIDE_DIMS == (int(split_max) + 1, int(max_d))
    (body,) = re.findall(r"int page_copy_bytes\(int D\) \{(.*?)\n\}", cu,
                         re.S)
    f32, bf16 = re.findall(r"return (.*?);", body)
    f32 = f32.replace("if (sizeof(TK) == 4) return ", "")
    assert "sizeof(TK) == 4" in body
    for d in range(1, 600):
        assert pa.page_copy_bytes(d, torch.float32) == _c_ternary(f32, d), d
        assert pa.page_copy_bytes(d, torch.bfloat16) == _c_ternary(bf16,
                                                                   d), d


@pytest.mark.parametrize("d,offset,need", [(264, 8, 16), (100, 4, 8),
                                           (18, 2, 4)])
def test_kernel_wrapper_refuses_pools_misaligned_for_the_copy(d, offset,
                                                              need):
    """bf16 pools must start at a multiple of the copy unit (16, 8 or 4
    bytes by head_dim): the wrapper raises naming it before any build or
    launch."""
    B, Hq, Hkv, ps, P = 2, 2, 2, 4, 6
    n = P * ps * Hkv * d
    flat = torch.zeros(n + 16, dtype=torch.bfloat16)
    pool = flat[offset // 2:offset // 2 + n].view(P, ps, Hkv, d)
    assert pool.is_contiguous() and pool.data_ptr() % need
    q = torch.zeros(B, Hq, d)
    tables = torch.zeros(B, 2, dtype=torch.int32)
    kv = torch.tensor([3, 0], dtype=torch.int32)
    with pytest.raises(ValueError, match=f"aligned to {need} bytes"):
        pa._paged_attention_cuda(q, pool, pool, tables, kv)
