"""Elementwise binary ops with Paddle axis-broadcast semantics (reference
paddle/fluid/operators/elementwise_*_op.cc, elementwise_op_function.h)
— the counterpart of ``paddle_tpu/fluid/ops/elementwise.py``. Gradients
come from the generic path: autograd sum-reduces broadcast dims, as the
reference's grad does. Under a ParallelExecutor mesh the result takes
X's layout (``mesh_ops.conform``). The unary activations live in
``activations.py``."""
from __future__ import annotations

import torch

from ..registry import register_op
from ..selected_rows import SelectedRows, is_selected_rows
from .common import bcast_y, one
from .mesh_ops import conform


def _binary(name, fn):
    @register_op(name, ref="paddle/fluid/operators/elementwise_op_function.h")
    def _op(ctx, ins, attrs, _fn=fn):
        x, y = one(ins, "X"), one(ins, "Y")
        if (is_selected_rows(x) and y.ndim <= 1 and y.numel() == 1
                and _fn in (torch.mul, torch.div)):
            # a sparse gradient times a scalar (global-norm clipping,
            # per-parameter rates): row by row equals the dense op only
            # for f(0) = 0 that distributes over duplicate rows' sums,
            # so mul and div alone
            return {"Out": SelectedRows(x.rows, _fn(x.value, y.reshape(())),
                                        x.height)}
        # under a ParallelExecutor mesh Y takes X's layout
        y = conform(bcast_y(x, y, int(attrs.get("axis", -1))), x)
        return {"Out": _fn(x, y)}

    return _op


_binary("elementwise_add", torch.add)
_binary("elementwise_sub", torch.sub)
_binary("elementwise_mul", torch.mul)
_binary("elementwise_div", torch.div)
_binary("elementwise_max", torch.maximum)
_binary("elementwise_min", torch.minimum)
_binary("elementwise_pow", torch.pow)
