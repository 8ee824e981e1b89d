"""Mixture-of-Experts with expert parallelism over a mesh axis — the
counterpart of ``paddle_tpu/parallel/moe.py``.

Switch/GShard-style dense dispatch: routing is expressed as one-hot
products with static capacity (no dynamic shapes), expert weights carry a
leading expert axis sharded over ``ep``. Where the JAX package constrains
the dispatched activations' sharding and lets XLA's SPMD partitioner
insert the token all-to-alls, the port redistributes them as DTensors to
``Shard(0)`` over ``ep_axis`` (replicated over the other mesh axes), and
DTensor inserts the collectives. Capacity comes from the global token
count, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

__all__ = ["top1_dispatch", "moe_ffn"]


def _constrain(x, mesh, ep_axis: str):
    """``x`` [E, ...] as a DTensor sharded on its expert axis over
    ``ep_axis`` and replicated over every other mesh axis."""
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    placements = [Shard(0) if name == ep_axis else Replicate()
                  for name in mesh.mesh_dim_names]
    return x.redistribute(mesh, placements)


def _one_hot(idx, n: int, dtype):
    """``jax.nn.one_hot``: rows of ``idx`` (int) against ``0..n-1``; an
    index outside the range gives a zero row."""
    return (idx[:, None] == torch.arange(n, device=idx.device)).to(dtype)


def top1_dispatch(gates, capacity: int):
    """Switch-style top-1 routing. gates: [T, E] softmax probs. Returns
    (dispatch [T, E, C] one-hot, combine [T, E, C] gate-weighted, aux_loss).
    Tokens beyond an expert's capacity C are dropped (output 0 for them —
    the residual connection around the MoE layer carries them through)."""
    t, e = gates.shape
    expert_idx = gates.argmax(dim=-1)                           # [T]
    onehot = _one_hot(expert_idx, e, gates.dtype)               # [T, E]
    # load-balancing aux loss (Switch Transformer eq. 4):
    # E * sum_e (fraction of tokens to e) * (mean gate prob of e)
    density = onehot.mean(dim=0)
    density_proxy = gates.mean(dim=0)
    aux_loss = (density * density_proxy).sum() * e
    # position of each token within its expert's queue
    pos = (torch.cumsum(onehot, dim=0) - 1.0) * onehot          # [T, E]
    pos = pos.sum(dim=-1)                                       # [T]
    keep = (pos < capacity).to(gates.dtype)
    onehot = onehot * keep[:, None]
    pos_onehot = _one_hot(pos.to(torch.int64), capacity, gates.dtype)
    dispatch = onehot[:, :, None] * pos_onehot[:, None, :]      # [T, E, C]
    gate_val = (gates * onehot).sum(dim=-1)                     # [T]
    combine = dispatch * gate_val[:, None, None]
    return dispatch, combine, aux_loss


def moe_ffn(x, router_w, w1, w2, mesh=None, ep_axis: str = "ep",
            capacity_factor: float = 1.25,
            activation=torch.relu) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE feed-forward. x: [..., d]; router_w: [d, E]; w1: [E, d, ff];
    w2: [E, ff, d]. Returns (out [..., d], aux_loss scalar float32).

    Under a ``mesh`` (a ``DeviceMesh`` holding ``ep_axis``; DTensor
    operands) the [E, ...] dispatched activations are redistributed to
    shard over ``ep_axis``; with w1/w2 sharded the same way each device
    computes only its experts. The routing runs on the replicated [T, E]
    gates, so capacity and queue positions are those of the global
    batch."""
    d = x.shape[-1]
    e = router_w.shape[1]
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    capacity = int(math.ceil(t / e * capacity_factor))

    logits = torch.matmul(xt.float(), router_w.float())
    gates = torch.softmax(logits, dim=-1)
    if mesh is not None:
        from torch.distributed.tensor import DTensor, Replicate

        if isinstance(gates, DTensor):
            gates = gates.redistribute(mesh, [Replicate()] * mesh.ndim)
    dispatch, combine, aux_loss = top1_dispatch(gates, capacity)
    dispatch = dispatch.to(x.dtype)
    combine = combine.to(x.dtype)

    # the JAX package's einsums as explicit products whose reshapes merge
    # only a leading sharded dim (DTensor cannot flatten a dim group
    # whose inner dim is split)
    c = dispatch.shape[2]
    expert_in = torch.matmul(
        dispatch.permute(1, 2, 0).reshape(e * c, t), xt).reshape(e, c, d)
    expert_in = _constrain(expert_in, mesh, ep_axis)        # tec,td->ecd
    h = activation(torch.bmm(expert_in, w1))                # ecd,edf->ecf
    h = _constrain(h, mesh, ep_axis)
    expert_out = torch.bmm(h, w2)                           # ecf,efd->ecd
    expert_out = _constrain(expert_out, mesh, ep_axis)
    out = torch.matmul(combine.reshape(t, e * c),
                       expert_out.reshape(e * c, d))        # tec,ecd->td
    return out.reshape(x.shape), aux_loss.to(torch.float32)
