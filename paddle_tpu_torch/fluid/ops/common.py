"""Shared helpers for op emitters."""
from __future__ import annotations

from ..core import as_torch_dtype


def one(ins, slot):
    lst = ins.get(slot) or []
    return lst[0] if lst else None


def many(ins, slot):
    return [x for x in (ins.get(slot) or []) if x is not None]


def refuse_amp(op):
    """The JAX package casts this op's operands to bf16 under
    FLAGS['amp']; the port computes float32 only, so it refuses the flag
    rather than ignore it."""
    from ...flags import FLAGS

    if FLAGS["amp"]:
        raise NotImplementedError(
            f"{op} with FLAGS['amp'] (bf16 operands) is not yet ported to "
            "paddle_tpu_torch: it computes float32 only")


def bcast_y(x, y, axis: int):
    """Paddle elementwise broadcast: Y's shape is a contiguous sub-sequence
    of X's, aligned at `axis` (-1 = align trailing). Reference
    operators/elementwise_op_function.h."""
    if x.shape == y.shape:
        return y
    if axis == -1:
        axis = x.ndim - y.ndim
    # trim trailing size-1 dims of y (reference allows [..., 1] tails)
    yshape = list(y.shape)
    while yshape and yshape[-1] == 1 and len(yshape) > x.ndim - axis:
        yshape.pop()
    new_shape = [1] * axis + yshape + [1] * (x.ndim - axis - len(yshape))
    return y.reshape(new_shape)


def dtype_of(attrs, key="dtype", default="float32"):
    return as_torch_dtype(attrs.get(key, default))
