"""Tensor-manipulation ops (reference paddle/fluid/operators/{reshape,
transpose,fill_constant,assign,assign_value,lookup_table}_op.*)."""
from __future__ import annotations

import numpy as np
import torch

from ..registry import register_op
from .common import dtype_of, one


@register_op("reshape", ref="paddle/fluid/operators/reshape_op.cc")
def reshape(ctx, ins, attrs):
    x = one(ins, "X")
    shape = [int(s) for s in attrs["shape"]]
    # reference semantics: 0 means "copy this dim from input"
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return {"Out": x.reshape(shape)}


@register_op("transpose", ref="paddle/fluid/operators/transpose_op.cc")
def transpose(ctx, ins, attrs):
    return {"Out": one(ins, "X").permute([int(a) for a in attrs["axis"]])}


@register_op("assign", ref="paddle/fluid/operators/assign_op.cc")
def assign(ctx, ins, attrs):
    # values are never written in place, so the alias is a copy
    return {"Out": one(ins, "X")}


@register_op("assign_value", ref="paddle/fluid/operators/assign_value_op.cc")
def assign_value(ctx, ins, attrs):
    dtype = dtype_of(attrs)
    shape = [int(s) for s in attrs["shape"]]
    if ctx.device.type == "meta":
        return {"Out": torch.empty(shape, dtype=dtype, device="meta")}
    vals = np.asarray(attrs["values"], dtype=np.float64 if dtype.is_floating_point
                      else np.int64).reshape(shape)
    return {"Out": torch.as_tensor(vals).to(device=ctx.device, dtype=dtype)}


@register_op("fill_constant", ref="paddle/fluid/operators/fill_constant_op.cc")
def fill_constant(ctx, ins, attrs):
    shape = [int(s) for s in attrs["shape"]]
    return {"Out": torch.full(shape, float(attrs.get("value", 0.0)),
                              dtype=dtype_of(attrs), device=ctx.device)}


def _squeezed_ids(ids):
    if ids.ndim >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    return ids.long()


def _lookup_table_grad(ctx, fwd_ins, fwd_outs, out_grads, attrs):
    """Dense grad W: the rows' output gradients scatter-added into a zero
    table (the JAX package's dense path, ``jnp.take``'s vjp)."""
    w, ids = fwd_ins["W"][0], fwd_ins["Ids"][0]
    dy = out_grads["Out"][0]
    if dy is None:
        return {}
    padding_idx = int(attrs.get("padding_idx", -1))
    flat_ids = _squeezed_ids(ids).reshape(-1)
    flat_dy = dy.reshape((flat_ids.shape[0],) + tuple(w.shape[1:])).to(w.dtype)
    if padding_idx != -1:
        flat_dy = torch.where((flat_ids == padding_idx)[:, None],
                              torch.zeros_like(flat_dy), flat_dy)
    # index_put_ with accumulate sorts the ids and sums each row in one
    # order; index_add_ adds with atomics on the card, so repeated ids
    # (every sequence's start token) changed the last bits from run to run
    dw = torch.zeros_like(w).index_put_((flat_ids,), flat_dy, accumulate=True)
    return {"GRAD@W": dw, "GRAD@Ids": None}


@register_op("lookup_table", no_grad=("Ids",), grad=_lookup_table_grad,
             ref="paddle/fluid/operators/lookup_table_op.cc")
def lookup_table(ctx, ins, attrs):
    if bool(attrs.get("is_sparse", False)):
        raise NotImplementedError(
            "lookup_table is_sparse=True (SelectedRows gradients) is not "
            "yet ported to paddle_tpu_torch")
    w, ids = one(ins, "W"), one(ins, "Ids")
    padding_idx = int(attrs.get("padding_idx", -1))
    ids = _squeezed_ids(ids)
    out = w[ids]
    if padding_idx != -1:
        out = torch.where((ids == padding_idx)[..., None],
                          torch.zeros_like(out), out)
    return {"Out": out}
