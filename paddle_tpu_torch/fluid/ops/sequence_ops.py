"""Sequence ops on the padded + lengths representation — the counterpart
of ``paddle_tpu/fluid/ops/sequence_ops.py`` (``_mask``, ``sequence_pool``,
``lstm``, ``lod_rank_table``, ``reorder_lod_tensor_by_rank``), computed
with torch ops.

A "sequence batch" is a padded dense tensor [N, T, ...] plus a lengths
vector [N] (int32) carried in the companion variable `<name>@LEN` (see
layers/sequence.py); masking replaces the reference's LoD offset tables
(lod_tensor.h:44-110). The JAX package computes ``lstm`` with
``jax.lax.scan``; here the same recurrence is a Python loop over the time
steps, and the generic autograd grad differentiates it.

Reference op files: sequence_pool_op.cc, lstm_op.cc (+math/lstm_compute),
lod_rank_table_op.cc, reorder_lod_tensor_by_rank_op.cc.
"""
from __future__ import annotations

import torch

from ..registry import register_op
from .common import one


def _mask(lengths, T, dtype=torch.float32):
    # [N, T] 1.0 where t < len
    return (torch.arange(T, device=lengths.device)[None, :]
            < lengths[:, None]).to(dtype)


@register_op("sequence_pool", no_grad=("Lengths",),
             ref="paddle/fluid/operators/sequence_pool_op.cc")
def sequence_pool(ctx, ins, attrs):
    x = one(ins, "X")  # [N, T, D]
    lengths = one(ins, "Lengths")
    pool_type = str(attrs.get("pooltype", "AVERAGE")).upper()
    N, T = x.shape[0], x.shape[1]
    if lengths is None:
        lengths = torch.full((N,), T, dtype=torch.int32, device=x.device)
    m = _mask(lengths, T, x.dtype)[:, :, None]
    safe_len = torch.clamp(lengths, min=1).to(x.dtype)[:, None]
    if pool_type == "AVERAGE":
        out = torch.sum(x * m, dim=1) / safe_len
    elif pool_type == "SUM":
        out = torch.sum(x * m, dim=1)
    elif pool_type == "SQRT":
        out = torch.sum(x * m, dim=1) / torch.sqrt(safe_len)
    elif pool_type == "MAX":
        # amax spreads a tie's gradient evenly, as jnp.max's vjp does
        # (torch.max(dim) gives it all to one index)
        neg = torch.finfo(x.dtype).min
        out = torch.amax(torch.where(m > 0, x, torch.full_like(x, neg)),
                         dim=1)
    elif pool_type == "LAST":
        idx = torch.clamp(lengths - 1, min=0).long()
        out = torch.take_along_dim(x, idx[:, None, None], dim=1)[:, 0]
    elif pool_type == "FIRST":
        out = x[:, 0]
    else:
        raise ValueError(f"unknown pooltype {pool_type}")
    return {"Out": out,
            "MaxIndex": torch.zeros((N,), dtype=torch.int32,
                                    device=x.device)}


_ACTS = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu,
         "identity": lambda v: v}


@register_op("lstm", no_grad=("Lengths",),
             ref="paddle/fluid/operators/lstm_op.cc, math/lstm_compute.*")
def lstm(ctx, ins, attrs):
    """Fused LSTM over time. Input is the pre-projected gate activations
    [N, T, 4H] (the reference's dynamic_lstm also takes the x-projection
    as input, layers/nn.py:277); Weight [H, 4H] is the recurrent
    projection; Bias [4H] or [7H] with peepholes. Gate order i, f, c, o
    (reference lstm_op.cc). As in the JAX op, ``candidate_activation``
    applies to the cell gate and ``cell_activation`` to c before the
    output gate. Past a sequence's length h and c stay frozen, and
    Hidden / Cell are zero there."""
    x = one(ins, "Input")
    w = one(ins, "Weight")
    bias = one(ins, "Bias")
    lengths = one(ins, "Lengths")
    h0, c0 = one(ins, "H0"), one(ins, "C0")
    use_peepholes = bool(attrs.get("use_peepholes", False))
    is_reverse = bool(attrs.get("is_reverse", False))
    g_act = _ACTS[attrs.get("gate_activation", "sigmoid")]
    c_act = _ACTS[attrs.get("candidate_activation", "tanh")]
    d_act = _ACTS[attrs.get("cell_activation", "tanh")]

    N, T, H4 = x.shape
    H = H4 // 4
    if bias is not None:
        x = x + bias[:4 * H][None, None, :]
        if use_peepholes:
            w_ic, w_fc, w_oc = (bias[4 * H:5 * H], bias[5 * H:6 * H],
                                bias[6 * H:7 * H])
    if x.device.type == "meta":  # shape inference: no need to step
        cell = x.new_empty((N, T, H))
        return {"Hidden": x.new_empty((N, T, H)), "Cell": cell,
                "BatchGate": x, "BatchCellPreAct": cell}
    h = torch.zeros((N, H), dtype=x.dtype, device=x.device) \
        if h0 is None else h0
    c = torch.zeros((N, H), dtype=x.dtype, device=x.device) \
        if c0 is None else c0
    if lengths is None:
        lengths = torch.full((N,), T, dtype=torch.int32, device=x.device)
    valid = (torch.arange(T, device=x.device)[:, None]
             < lengths[None, :])[:, :, None]  # [T, N, 1]

    hs, cs = [None] * T, [None] * T
    for t in (range(T - 1, -1, -1) if is_reverse else range(T)):
        gates = x[:, t] + h @ w  # [N, 4H]
        gi, gf, gc, go = torch.chunk(gates, 4, dim=1)
        if use_peepholes:
            gi = gi + c * w_ic[None, :]
            gf = gf + c * w_fc[None, :]
        i = g_act(gi)
        f = g_act(gf)
        c_new = f * c + i * c_act(gc)
        if use_peepholes:
            go = go + c_new * w_oc[None, :]
        o = g_act(go)
        h_new = o * d_act(c_new)
        h = torch.where(valid[t], h_new, h)
        c = torch.where(valid[t], c_new, c)
        hs[t], cs[t] = h, c
    hidden = torch.stack(hs, dim=1)
    cell = torch.stack(cs, dim=1)
    mask = _mask(lengths, T, x.dtype)[:, :, None]
    return {"Hidden": hidden * mask, "Cell": cell * mask,
            "BatchGate": x, "BatchCellPreAct": cell}


@register_op("lod_rank_table", no_grad=("X", "Lengths"),
             ref="paddle/fluid/operators/lod_rank_table_op.cc")
def lod_rank_table(ctx, ins, attrs):
    """The permutation that sorts the batch by DESCENDING length, ties in
    batch order (the reference's LoDRankTable; the JAX package's
    ``argsort(-lengths, stable=True)``), int32."""
    lengths = one(ins, "Lengths").to(torch.int32)
    return {"Out": torch.argsort(-lengths, stable=True).to(torch.int32)}


@register_op("reorder_lod_tensor_by_rank", no_grad=("RankTable",),
             ref="paddle/fluid/operators/reorder_lod_tensor_by_rank_op.cc")
def reorder_lod_tensor_by_rank(ctx, ins, attrs):
    x, rank = one(ins, "X"), one(ins, "RankTable")
    return {"Out": x.index_select(0, rank.long())}
