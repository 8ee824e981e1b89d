"""Loss ops (reference paddle/fluid/operators/
softmax_with_cross_entropy_op.cc)."""
from __future__ import annotations

import torch

from ..registry import register_op
from .common import one


@register_op("softmax_with_cross_entropy", no_grad=("Label",),
             ref="paddle/fluid/operators/softmax_with_cross_entropy_op.cc")
def softmax_with_cross_entropy(ctx, ins, attrs):
    logits, label = one(ins, "Logits"), one(ins, "Label")
    logp = torch.log_softmax(logits, dim=-1)
    if bool(attrs.get("soft_label", False)):
        loss = -(label * logp).sum(dim=-1, keepdim=True)
    else:
        lab = label.squeeze(-1) if label.ndim >= 2 and label.shape[-1] == 1 \
            else label
        loss = -torch.take_along_dim(logp, lab[..., None].long(), dim=-1)
    return {"Softmax": torch.exp(logp), "Loss": loss}
