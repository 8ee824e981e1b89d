"""Shared helpers for op emitters."""
from __future__ import annotations

import torch

from ..core import as_torch_dtype


def one(ins, slot):
    lst = ins.get(slot) or []
    return lst[0] if lst else None


def many(ins, slot):
    return [x for x in (ins.get(slot) or []) if x is not None]


def amp_operands(x, w):
    """Mixed precision (FLAGS['amp']), the JAX package's
    ``amp_operands``: float32 operands of a product (matmul, conv) go to
    bfloat16, and the caller casts the bfloat16 result back to the
    returned ``restore`` dtype (float32). The product accumulates in
    float32 inside cuBLAS, cuDNN or K5 and rounds once to bfloat16; master
    weights and every other tensor stay float32. The casts are torch ops
    on the autograd record, so a generic grad op runs the JAX ``vjp``'s
    path through ``astype``: the cotangent rounds to bfloat16, the
    backward products run in bfloat16 and the gradients come back
    float32. No-op (``restore`` None) when the flag is off or either
    operand is not float32."""
    from ...flags import FLAGS

    if FLAGS["amp"] and x.dtype == torch.float32 \
            and w.dtype == torch.float32:
        return x.to(torch.bfloat16), w.to(torch.bfloat16), torch.float32
    return x, w, None


def restored(out, restore):
    """``out`` cast back to ``restore`` (the third value of
    ``amp_operands``), or ``out`` itself when that is None."""
    return out if restore is None else out.to(restore)


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
