"""The kernel ops under a mesh: ``local_map`` around the hand-written
kernels — the counterpart of the JAX ops' ``shard_map`` around a Pallas
kernel (``paddle_tpu/fluid/ops/attention_ops.py:66-95``).

A ParallelExecutor run (or a mesh-sharded decode step) hands the ops
DTensors. A kernel takes plain
tensors, so each op below redistributes its operands to the placement
its kernel can compute locally and runs the kernel's wrapper on every
rank's local shards through ``torch.distributed.tensor.experimental.
local_map``; the autograd.Function inside (the kernel forward and its
backward) runs on those shards too. No kernel changes: on a card each
shard launches the kernel, on the CPU its plain version runs.
"""
from __future__ import annotations

from typing import Optional

import torch


def mesh_operands(mesh, *ts) -> bool:
    """True when ``mesh`` is active and any operand is a DTensor."""
    if mesh is None:
        return False
    from torch.distributed.tensor import DTensor

    return any(isinstance(t, DTensor) for t in ts)


def _batch_placements(mesh, x, divisible_dim0: bool):
    """Placements keeping ``x``'s ``Shard(0)`` mesh dims (when dim 0
    divides evenly) and replicating every other mesh dim."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    pl = list(x.placements) if isinstance(x, DTensor) else \
        [Replicate()] * mesh.ndim
    out = []
    for p in pl:
        keep = isinstance(p, Shard) and p.dim == 0 and divisible_dim0
        out.append(Shard(0) if keep else Replicate())
    return tuple(out)


def _dim0_divides(mesh, x, placements) -> bool:
    from torch.distributed.tensor import Shard

    k = 1
    for size, p in zip(mesh.shape, placements):
        if isinstance(p, Shard) and p.dim == 0:
            k *= int(size)
    return x.shape[0] % k == 0


def layer_norm(mesh, x, scale, bias, eps: float, begin_norm_axis: int):
    """K1 over row shards: x keeps its batch (dim 0) sharding and is
    whole along every other dim; scale and bias are replicated, their
    gradients partial sums over the batch shards. Mean and Variance come
    out sharded as the rows. Returns ``(y, mean, variance)``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from ...kernels.layer_norm import fused_layer_norm

    pl = _batch_placements(mesh, x, True) if begin_norm_axis >= 1 else \
        tuple(Replicate() for _ in range(mesh.ndim))
    if not _dim0_divides(mesh, x, pl):
        pl = tuple(Replicate() for _ in range(mesh.ndim))
    rep = tuple(Replicate() for _ in range(mesh.ndim))
    grad_pl = tuple(Partial() if isinstance(p, Shard) else Replicate()
                    for p in pl)
    row_pl = pl

    def fn(xs, s, b):
        return fused_layer_norm(xs, s, b, eps=eps,
                                begin_norm_axis=begin_norm_axis)

    mapped = local_map(
        fn, out_placements=(pl, row_pl, row_pl),
        in_placements=(pl, rep if scale is not None else None,
                       rep if bias is not None else None),
        in_grad_placements=(pl, grad_pl if scale is not None else None,
                            grad_pl if bias is not None else None),
        device_mesh=mesh, redistribute_inputs=True)
    return mapped(x, scale, bias)


def flash_attention(mesh, q, k, v, causal: bool, scale: Optional[float],
                    batch_axis: Optional[str], head_axis: Optional[str]):
    """K2 (forward) and K3a/K3b (backward) over ``(batch_axis, None,
    head_axis, None)`` shards of [B, S, H, D] Q/K/V, every other mesh
    axis replicated: attention is independent per batch row and head, so
    no collective runs inside. An axis the mesh does not hold, or that
    does not divide its dim, is left whole (the JAX op's rule)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from ...kernels.flash_attention import flash_attention as _flash

    sizes = dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))
    if batch_axis is not None and (batch_axis not in sizes
                                   or q.shape[0] % sizes[batch_axis]):
        batch_axis = None
    if head_axis is not None and (head_axis not in sizes
                                  or q.shape[2] % sizes[head_axis]):
        head_axis = None
    pl = tuple(Shard(0) if name == batch_axis else
               Shard(2) if name == head_axis else Replicate()
               for name in mesh.mesh_dim_names)

    def fn(qs, ks, vs):
        return _flash(qs, ks, vs, causal=causal, scale=scale)

    # one output: its placements as a list (a tuple reads as one per
    # output)
    mapped = local_map(fn, out_placements=list(pl),
                       in_placements=(pl, pl, pl),
                       in_grad_placements=(pl, pl, pl), device_mesh=mesh,
                       redistribute_inputs=True)
    return mapped(q, k, v)


def paged_attention(mesh, q, k, v, k_pool, v_pool, layer: int, page, off,
                    page_tables, kv_lens, q_lens):
    """K4 on each rank's kv heads, for a mesh-sharded decode step: the
    pools ``[layers, pages, page_size, kv_heads, head_dim]`` are sharded
    on the kv-head dim; q ``[B, C, Hq, D]`` and the step's new k/v
    ``[B, C, Hkv, D]`` take the same split of their head dim (a rank's
    query heads are the groups of its kv heads, so GQA stays local).
    Inside ``local_map`` each rank writes its heads of k/v into its slice
    of layer ``layer`` (pages ``page``, offsets ``off``) and runs K4 on
    that slice through the (replicated, plain) page tables; the output
    comes back sharded on its head dim. No collective runs inside."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from ...serving.decode import write_and_attend

    pool_pl = tuple(k_pool.placements)
    head_pl = tuple(Shard(2) if isinstance(p, Shard) and p.dim == 3
                    else Replicate() for p in pool_pl)

    def fn(qs, ks, vs, kp, vp):
        return write_and_attend(qs, ks, vs, kp, vp, layer, page, off,
                                page_tables, kv_lens, q_lens)

    mapped = local_map(fn, out_placements=list(head_pl),
                       in_placements=(head_pl, head_pl, head_pl, pool_pl,
                                      pool_pl),
                       device_mesh=mesh, redistribute_inputs=True)
    return mapped(q, k, v, k_pool, v_pool)


def conv_bn_relu(mesh, x, w, scale, shift, stride: int, padding: int,
                 relu: bool):
    """K5 over batch shards of x [N, C, H, W]: filter and the folded
    affine replicated, the output sharded as x. An inference op: no
    gradient flows."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    from ...kernels.conv_bn_relu import fused_conv_bn_relu

    pl = _batch_placements(mesh, x, True)
    if not _dim0_divides(mesh, x, pl):
        pl = tuple(Replicate() for _ in range(mesh.ndim))
    rep = tuple(Replicate() for _ in range(mesh.ndim))

    def fn(xs, ws, sc, sh):
        return fused_conv_bn_relu(xs, ws, sc, sh, stride=stride,
                                  padding=padding, relu=relu)

    mapped = local_map(fn, out_placements=list(pl),
                       in_placements=(pl, rep, rep, rep), device_mesh=mesh,
                       redistribute_inputs=True)
    return mapped(x, w, scale, shift)


def conform(y, x):
    """``y`` (already broadcast-shaped against ``x``) laid out as ``x``: on
    each mesh dim where x is sharded on a dim y also spans, y is sharded
    the same way; everywhere else y is replicated. The result of a Paddle
    axis-broadcast op then takes X's layout, as the reference's
    broadcast of Y onto X does; without it a Y sharded on a dim X keeps
    whole (a catch-all FSDP rule on a position table) hands the
    following ops a layout whose reshapes DTensor plans very slowly."""
    if type(x) is torch.Tensor or type(y) is torch.Tensor:
        return y  # no mesh: nothing to conform
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not (isinstance(y, DTensor) and isinstance(x, DTensor)) or \
            y.ndim != x.ndim:
        return y
    want = []
    for p in x.placements:
        if isinstance(p, Shard) and y.shape[p.dim] == x.shape[p.dim]:
            want.append(Shard(p.dim))
        else:
            want.append(Replicate())
    if tuple(want) == tuple(y.placements):
        return y
    return y.redistribute(x.device_mesh, want)
