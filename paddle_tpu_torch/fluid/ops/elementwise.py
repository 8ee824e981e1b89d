"""Elementwise ops with Paddle axis-broadcast semantics (reference
paddle/fluid/operators/elementwise_*_op.cc, activation_op.cc). Gradients
come from the generic path: autograd sum-reduces broadcast dims, as the
reference's grad does."""
from __future__ import annotations

import torch

from ..registry import register_op
from .common import bcast_y, one


def _binary(name, fn):
    @register_op(name, ref="paddle/fluid/operators/elementwise_op_function.h")
    def _op(ctx, ins, attrs, _fn=fn):
        x, y = one(ins, "X"), one(ins, "Y")
        return {"Out": _fn(x, bcast_y(x, y, int(attrs.get("axis", -1))))}

    return _op


def _unary(name, fn):
    @register_op(name, ref="paddle/fluid/operators/activation_op.cc")
    def _op(ctx, ins, attrs, _fn=fn):
        return {"Out": _fn(one(ins, "X"))}

    return _op


_binary("elementwise_add", torch.add)
_binary("elementwise_sub", torch.sub)
_unary("relu", torch.relu)
_unary("square", torch.square)
