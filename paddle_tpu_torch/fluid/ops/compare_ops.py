"""Comparison and logical ops (reference paddle/fluid/operators/
compare_op.cc, logical_op.cc) — the counterpart of
``paddle_tpu/fluid/ops/compare_ops.py``. They feed While conditions and
stay outside the gradient."""
from __future__ import annotations

import torch

from ..registry import register_op
from .common import one


def _cmp(name, fn):
    @register_op(name, no_grad=("X", "Y"),
                 ref="paddle/fluid/operators/compare_op.cc")
    def _op(ctx, ins, attrs, _fn=fn):
        return {"Out": _fn(one(ins, "X"), one(ins, "Y"))}

    return _op


_cmp("less_than", torch.lt)
_cmp("less_equal", torch.le)
_cmp("greater_than", torch.gt)
_cmp("greater_equal", torch.ge)
_cmp("equal", torch.eq)
_cmp("not_equal", torch.ne)


def _logical(name, fn, binary=True):
    @register_op(name, no_grad=("X", "Y"),
                 ref="paddle/fluid/operators/logical_op.cc")
    def _op(ctx, ins, attrs, _fn=fn, _binary=binary):
        if _binary:
            return {"Out": _fn(one(ins, "X"), one(ins, "Y"))}
        return {"Out": _fn(one(ins, "X"))}

    return _op


_logical("logical_and", torch.logical_and)
_logical("logical_or", torch.logical_or)
_logical("logical_xor", torch.logical_xor)
_logical("logical_not", torch.logical_not, binary=False)
