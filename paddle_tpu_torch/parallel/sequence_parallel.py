"""Sequence/context parallelism: ring attention and Ulysses all-to-all —
the counterpart of ``paddle_tpu/parallel/sequence_parallel.py``, in plain
PyTorch math (the JAX module computes it in ``jnp``; there is no Pallas
kernel on this path).

  - **Ring attention** (``ring_attention_shard``): each rank holds a
    sequence chunk of Q/K/V; K/V blocks rotate around the ring of the
    sequence axis's ranks by batched P2P sends (``batch_isend_irecv``)
    while a flash-style online softmax in float32 (running max / sum)
    accumulates the local queries' output. The backward is a second
    ring: dK/dV accumulators travel with their K/V blocks and are home
    after n hops (``torch.autograd.Function``, the JAX custom_vjp).
  - **Ulysses** (``ulysses_attention_shard``): an all-to-all re-shards
    ``[B, S/n, H, D] -> [B, S, H/n, D]`` so each rank runs full-sequence
    attention on a head subset, then the inverse all-to-all restores the
    sequence sharding. Its backward is the inverse all-to-all.

Both are per-shard functions on plain local tensors with the sequence
axis's process group; ``sequence_parallel_attention`` is the DTensor
entry point, a ``local_map`` over ``(batch_axis, seq_axis, head_axis,
None)`` shards of ``[B, S, H, D]``.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["ring_attention_shard", "ulysses_attention_shard",
           "sequence_parallel_attention", "NEG_INF"]

NEG_INF = -1e30


def _bhq_to_bqh1(x):
    # [B, H, Sq] -> [B, Sq, H, 1] (broadcast factor of a [B, Sq, H, D] sum)
    return x.transpose(1, 2)[..., None]


def _block_scores(q32, k, scale, mask):
    s = torch.einsum("bqhd,bkhd->bhqk", q32, k.float()) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    return s


def _online_softmax_block(q32, k, v, m, l, o, mask, scale):
    """One flash-attention block update. m, l: [B, H, Sq] float32 running
    max and sum; o: [B, Sq, H, D] float32 unnormalized output."""
    s = _block_scores(q32, k, scale, mask)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # rows with no valid key yet keep m = NEG_INF; exp(0) = 1 there would
    # poison p, so masked score entries are explicitly zeroed
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    l_new = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return m_new, l_new, o * _bhq_to_bqh1(alpha) + pv


def _causal_mask(my, src, sq, sk, device):
    """Block mask for query chunk ``my`` against the key chunk originally
    at ``src`` (chunks are contiguous sequence slices of equal length per
    rank)."""
    qpos = my * sq + torch.arange(sq, device=device)
    kpos = src * sk + torch.arange(sk, device=device)
    return (qpos[:, None] >= kpos[None, :])[None, None]  # [1, 1, Sq, Sk]


class _Ring:
    """The ring of one sequence axis: this rank's position and the global
    ranks of its neighbours (``group=None``: a ring of one)."""

    def __init__(self, group):
        import torch.distributed as dist

        self.group = group
        if group is None:
            self.n, self.my = 1, 0
            return
        self.n = dist.get_world_size(group)
        self.my = dist.get_rank(group)
        self.next = dist.get_global_rank(group, (self.my + 1) % self.n)
        self.prev = dist.get_global_rank(group, (self.my - 1) % self.n)

    def rotate(self, *ts):
        """Send each tensor to the next rank, receive the previous rank's:
        one batched P2P exchange for the lot."""
        import torch.distributed as dist

        outs = [torch.empty_like(t) for t in ts]
        ops = []
        for t, o in zip(ts, outs):
            ops.append(dist.P2POp(dist.isend, t.contiguous(), self.next,
                                  self.group))
            ops.append(dist.P2POp(dist.irecv, o, self.prev, self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return outs


def _ring_fwd_pass(q, k, v, ring, causal, scale):
    n, my = ring.n, ring.my
    b, sq, h, d = q.shape
    sk = k.shape[1]
    q32 = q.float()
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    kk, vv = k, v
    for i in range(n):
        src = (my - i) % n
        mask = _causal_mask(my, src, sq, sk, q.device) if causal else None
        m, l, o = _online_softmax_block(q32, kk, vv, m, l, o, mask, scale)
        if i < n - 1:  # the last block's rotation would be discarded
            kk, vv = ring.rotate(kk, vv)
    l_safe = torch.clamp(l, min=torch.finfo(torch.float32).tiny)
    out = (o / _bhq_to_bqh1(l_safe)).to(q.dtype)
    lse = m + torch.log(l_safe)  # [B, H, Sq]
    return out, lse


class _RingAttention(torch.autograd.Function):
    """The ring forward, and the second ring of the backward (JAX
    ``_ring_bwd_rule``): P from the saved row LSE, dK/dV accumulated into
    buffers that rotate with their K/V blocks."""

    @staticmethod
    def forward(ctx, q, k, v, ring, causal, scale):
        out, lse = _ring_fwd_pass(q, k, v, ring, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring, ctx.causal, ctx.scale = ring, causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        ring, causal, scale = ctx.ring, ctx.causal, ctx.scale
        n, my = ring.n, ring.my
        b, sq, h, d = q.shape
        sk = k.shape[1]
        q32 = q.float()
        do32 = dout.float()
        # D_i = sum_d dO_i * O_i, the softmax-jacobian diagonal: [B, H, Sq]
        delta = torch.sum(do32 * out.float(), dim=-1).transpose(1, 2)
        dq = torch.zeros((b, sq, h, d), dtype=torch.float32,
                         device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        kk, vv = k, v
        for i in range(n):
            src = (my - i) % n
            mask = _causal_mask(my, src, sq, sk, q.device) if causal \
                else None
            s = _block_scores(q32, kk, scale, mask)
            p = torch.exp(s - lse[..., None])
            if mask is not None:
                p = torch.where(mask, p, torch.zeros_like(p))
            dv = dv + torch.einsum("bhqk,bqhd->bkhd", p, do32)
            dp = torch.einsum("bqhd,bkhd->bhqk", do32, vv.float())
            ds = p * (dp - delta[..., None])
            dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kk.float()) * scale
            dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds, q32) * scale
            if n > 1:
                # dK/dV travel with their K/V blocks: after n hops every
                # block is home with all its contributions
                kk, vv, dk, dv = ring.rotate(kk, vv, dk, dv)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def ring_attention_shard(q, k, v, group=None, causal: bool = False,
                         scale: Optional[float] = None):
    """Per-shard ring attention. q: [B, Sq_local, H, D]; k/v: [B,
    Sk_local, H, D], sequence-sharded over the ranks of ``group`` (None =
    a single chunk: plain online-softmax attention). Softmax in float32;
    the output in q's dtype. Differentiable (the backward is the second
    ring)."""
    scale = float(scale) if scale is not None else q.shape[-1] ** -0.5
    return _RingAttention.apply(q, k, v, _Ring(group), bool(causal), scale)


def _all_to_all(x, group, scatter_dim: int, gather_dim: int):
    """Split ``x`` into n chunks along ``scatter_dim``, send chunk j to
    rank j of ``group``, concatenate what arrives along ``gather_dim`` in
    rank order."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    chunks = torch.stack(torch.chunk(x, n, dim=scatter_dim))
    out = torch.empty_like(chunks)
    dist.all_to_all_single(out, chunks.contiguous(), group=group)
    return torch.cat(list(out.unbind(0)), dim=gather_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, scatter_dim, gather_dim):
        ctx.args = (group, scatter_dim, gather_dim)
        return _all_to_all(x, group, scatter_dim, gather_dim)

    @staticmethod
    def backward(ctx, g):
        group, scatter_dim, gather_dim = ctx.args
        # the inverse re-shard carries the gradient back
        return _all_to_all(g, group, gather_dim, scatter_dim), None, None, \
            None


def ulysses_attention_shard(q, k, v, group, causal: bool = False,
                            scale: Optional[float] = None):
    """Per-shard Ulysses attention: all-to-all heads <-> sequence over the
    ranks of ``group``, full-sequence attention on a head subset, then
    the inverse all-to-all. Requires H % n == 0."""
    import torch.distributed as dist

    n = 1 if group is None else dist.get_world_size(group)
    if n > 1:
        if q.shape[2] % n:
            raise ValueError(f"ulysses needs heads ({q.shape[2]}) divisible "
                             f"by axis size {n}")
        q, k, v = (_AllToAll.apply(t, group, 2, 1) for t in (q, k, v))
    out = ring_attention_shard(q, k, v, None, causal, scale)
    if n > 1:
        out = _AllToAll.apply(out, group, 1, 2)
    return out


def sequence_parallel_attention(q, k, v, mesh, seq_axis: str = "sp",
                                batch_axis: Optional[str] = None,
                                head_axis: Optional[str] = None,
                                causal: bool = False,
                                scale: Optional[float] = None,
                                impl: str = "ring"):
    """DTensor entry point: q/k/v are [B, S, H, D] DTensors on ``mesh``;
    attention runs on ``(batch_axis, seq_axis, head_axis, None)`` shards
    (each rank's local block, through ``local_map``), the sequence dim's
    ranks exchanging blocks by ``impl`` ('ring' or 'ulysses'). Every
    other mesh axis is replicated. Differentiable."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if impl not in ("ring", "ulysses"):
        raise ValueError(f"unknown sequence-parallel impl '{impl}'")
    group = mesh.get_group(seq_axis)
    pl = tuple(Shard(0) if name == batch_axis else
               Shard(1) if name == seq_axis else
               Shard(2) if name == head_axis else Replicate()
               for name in mesh.mesh_dim_names)

    def body(qs, ks, vs):
        if impl == "ring":
            return ring_attention_shard(qs, ks, vs, group, causal, scale)
        return ulysses_attention_shard(qs, ks, vs, group, causal, scale)

    # one output: its placements as a list (a tuple reads as one per
    # output)
    mapped = local_map(body, out_placements=list(pl),
                       in_placements=(pl, pl, pl),
                       in_grad_placements=(pl, pl, pl), device_mesh=mesh,
                       redistribute_inputs=True)
    return mapped(q, k, v)
