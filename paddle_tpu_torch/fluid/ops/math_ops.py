"""GEMM-family + misc math ops (reference paddle/fluid/operators/{mul,
matmul,sum,mean,scale,cum,sign,minus,clip,clip_by_norm,squared_l2_norm,
l1_norm,cos_sim}_op.*). ``sum`` and the clip ops take SelectedRows
gradients as the JAX package's do. Plain large products stay ``torch.matmul``
(cuBLAS on a card), as the JAX package leaves them to XLA; under
FLAGS['amp'] ``mul`` and ``matmul`` multiply bfloat16 operands and
restore the result to float32 (``amp_operands``)."""
from __future__ import annotations

import math

import torch

from ..registry import register_op
from ..selected_rows import SelectedRows, add_any, is_selected_rows
from .common import amp_operands, many, one, restored


@register_op("mul", ref="paddle/fluid/operators/mul_op.cc")
def mul(ctx, ins, attrs):
    x, y = one(ins, "X"), one(ins, "Y")
    xn = int(attrs.get("x_num_col_dims", 1))
    yn = int(attrs.get("y_num_col_dims", 1))
    y2 = y.reshape(math.prod(y.shape[:yn]), -1)
    if xn >= 2 and _sequence_sharded(x):
        # under sequence parallelism dim 1 of the activations (and of
        # their gradients) is sharded, and DTensor (torch 2.11) may not
        # flatten it into rows behind dim 0, forward or in a view's
        # backward: the product is batched over dim 0, the other leading
        # dims its rows, and the output needs no view
        lead = tuple(x.shape[:xn])
        x3 = x.reshape(lead[0], math.prod(lead[1:]), -1)
        x3, y3, restore = amp_operands(x3, y2)
        out = restored(torch.bmm(
            x3, y3.unsqueeze(0).expand(lead[0], *y3.shape)), restore)
    else:
        x2 = x.reshape(math.prod(x.shape[:xn]), -1)
        x2, y2, restore = amp_operands(x2, y2)
        out = restored(x2 @ y2, restore)
    return {"Out": out.reshape(tuple(x.shape[:xn]) + tuple(y.shape[yn:]))}


def _sequence_sharded(x) -> bool:
    """True for a DTensor operand of a run whose plan splits feeds on
    ``[batch, seq]`` over a mesh that holds the sequence axis."""
    from ...parallel.api import current_seq_axis

    return hasattr(x, "placements") and current_seq_axis() is not None


@register_op("matmul", ref="paddle/fluid/operators/matmul_op.cc")
def matmul(ctx, ins, attrs):
    x, y = one(ins, "X"), one(ins, "Y")
    tx = bool(attrs.get("transpose_X", False))
    ty = bool(attrs.get("transpose_Y", False))
    alpha = float(attrs.get("alpha", 1.0))
    if x.ndim == 1:
        x = x[None, :] if not tx else x[:, None]
    if y.ndim == 1:
        y = y[:, None] if not ty else y[None, :]
    if tx:
        x = x.transpose(-1, -2)
    if ty:
        y = y.transpose(-1, -2)
    x, y, restore = amp_operands(x, y)
    out = restored(x @ y, restore)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": out}


@register_op("sum", ref="paddle/fluid/operators/sum_op.cc")
def sum_op(ctx, ins, attrs):
    """Dense and SelectedRows terms as the reference's sum_op
    (math/selected_rows_functor.cc): all sparse stays sparse (rows
    concatenated), mixed densifies by a scatter-add."""
    xs = many(ins, "X")
    out = xs[0]
    for x in xs[1:]:
        out = add_any(out, x)
    return {"Out": out}


@register_op("mean", ref="paddle/fluid/operators/mean_op.cc")
def mean(ctx, ins, attrs):
    return {"Out": one(ins, "X").mean().reshape(1)}


@register_op("scale", ref="paddle/fluid/operators/scale_op.cc")
def scale(ctx, ins, attrs):
    x = one(ins, "X")
    s = float(attrs.get("scale", 1.0))
    b = float(attrs.get("bias", 0.0))
    if bool(attrs.get("bias_after_scale", True)):
        return {"Out": x * s + b}
    return {"Out": (x + b) * s}


@register_op("cumsum", ref="paddle/fluid/operators/cum_op.h")
def cumsum(ctx, ins, attrs):
    x = one(ins, "X")
    axis = int(attrs.get("axis", -1))
    if bool(attrs.get("reverse", False)):
        out = torch.flip(torch.cumsum(torch.flip(x, [axis]), dim=axis),
                         [axis])
    else:
        out = torch.cumsum(x, dim=axis)
    if bool(attrs.get("exclusive", False)):
        out = out - x
    return {"Out": out}


@register_op("sign", ref="paddle/fluid/operators/sign_op.cc")
def sign(ctx, ins, attrs):
    return {"Out": torch.sign(one(ins, "X"))}


@register_op("minus", ref="paddle/fluid/operators/minus_op.cc")
def minus(ctx, ins, attrs):
    return {"Out": one(ins, "X") - one(ins, "Y")}


@register_op("clip", ref="paddle/fluid/operators/clip_op.cc")
def clip(ctx, ins, attrs):
    """Elementwise clamp to [min, max]. A SelectedRows merges first, so
    a repeated row clips its sum, and the masked duplicate entries stay
    0 even where the range leaves out 0."""
    x = one(ins, "X")
    lo, hi = float(attrs["min"]), float(attrs["max"])
    if is_selected_rows(x):
        rows, merged, mask = x.merged()
        maskb = mask.reshape((-1,) + (1,) * (merged.ndim - 1))
        return {"Out": SelectedRows(rows, maskb * torch.clamp(merged, lo, hi),
                                    x.height)}
    return {"Out": torch.clamp(x, lo, hi)}


def _clipped(x, max_norm):
    norm = torch.sqrt(torch.sum(x * x))
    return torch.where(norm > max_norm, x * (max_norm / norm), x)


@register_op("clip_by_norm", ref="paddle/fluid/operators/clip_by_norm_op.cc")
def clip_by_norm(ctx, ins, attrs):
    """``x * max_norm / ||x||`` where the L2 norm exceeds ``max_norm``,
    else ``x``; a SelectedRows merges first (the merged norm is the
    dense one)."""
    x = one(ins, "X")
    max_norm = float(attrs["max_norm"])
    if is_selected_rows(x):
        rows, merged, _ = x.merged()
        return {"Out": SelectedRows(rows, _clipped(merged, max_norm),
                                    x.height)}
    return {"Out": _clipped(x, max_norm)}


@register_op("squared_l2_norm",
             ref="paddle/fluid/operators/squared_l2_norm_op.cc")
def squared_l2_norm(ctx, ins, attrs):
    x = one(ins, "X")
    if is_selected_rows(x):
        x = x.merged()[1]
    return {"Out": torch.sum(x * x).reshape(1)}


@register_op("l1_norm", ref="paddle/fluid/operators/l1_norm_op.cc")
def l1_norm(ctx, ins, attrs):
    return {"Out": torch.sum(torch.abs(one(ins, "X"))).reshape(1)}


@register_op("cos_sim", ref="paddle/fluid/operators/cos_sim_op.cc")
def cos_sim(ctx, ins, attrs):
    """Row-wise cosine similarity over the last axis, with both norms."""
    x, y = one(ins, "X"), one(ins, "Y")
    xn = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    yn = torch.sqrt(torch.sum(y * y, dim=-1, keepdim=True))
    out = torch.sum(x * y, dim=-1, keepdim=True) / (xn * yn)
    return {"Out": out, "XNorm": xn, "YNorm": yn}

