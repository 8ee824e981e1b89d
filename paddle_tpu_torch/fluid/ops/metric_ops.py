"""Metric ops (reference paddle/fluid/operators/accuracy_op.cc): the
counterpart of ``paddle_tpu/fluid/ops/metric_ops.py`` for the ops ported
so far."""
from __future__ import annotations

import torch

from ..registry import register_op
from .common import one


@register_op("accuracy", no_grad=("Out", "Indices", "Label"),
             ref="paddle/fluid/operators/accuracy_op.cc")
def accuracy(ctx, ins, attrs):
    """A row is correct when its label is among its top-k indices:
    float32 Accuracy, int32 Correct and Total, each of shape [1]."""
    indices, label = one(ins, "Indices"), one(ins, "Label")
    if label.ndim >= 2 and label.shape[-1] == 1:
        label = label.squeeze(-1)
    n = indices.shape[0]
    correct = (indices == label[:, None]).any(dim=1).sum(dtype=torch.int32)
    return {
        "Accuracy": (correct.to(torch.float32) / n).reshape(1),
        "Correct": correct.reshape(1),
        "Total": torch.full((1,), n, dtype=torch.int32,
                            device=indices.device),
    }
