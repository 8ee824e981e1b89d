"""Loss ops (reference paddle/fluid/operators/cross_entropy_op.cc,
softmax_with_cross_entropy_op.cc)."""
from __future__ import annotations

import torch

from ..registry import register_op
from .common import one


def _squeeze_label(label):
    if label.ndim >= 2 and label.shape[-1] == 1:
        return label.squeeze(-1)
    return label


@register_op("cross_entropy", no_grad=("Label",),
             ref="paddle/fluid/operators/cross_entropy_op.cc")
def cross_entropy(ctx, ins, attrs):
    """-log of the label's probability (X holds probabilities), clamped
    below at 1e-20 as the JAX package's op."""
    x, label = one(ins, "X"), one(ins, "Label")
    if bool(attrs.get("soft_label", False)):
        loss = -(label * torch.log(torch.clamp(x, min=1e-20))).sum(
            dim=-1, keepdim=True)
    else:
        picked = torch.take_along_dim(
            x, _squeeze_label(label)[..., None].long(), dim=-1)
        loss = -torch.log(torch.clamp(picked, min=1e-20))
    return {"Y": loss}


@register_op("softmax_with_cross_entropy", no_grad=("Label",),
             ref="paddle/fluid/operators/softmax_with_cross_entropy_op.cc")
def softmax_with_cross_entropy(ctx, ins, attrs):
    logits, label = one(ins, "Logits"), one(ins, "Label")
    logp = torch.log_softmax(logits, dim=-1)
    if bool(attrs.get("soft_label", False)):
        loss = -(label * logp).sum(dim=-1, keepdim=True)
    else:
        loss = -torch.take_along_dim(
            logp, _squeeze_label(label)[..., None].long(), dim=-1)
    return {"Softmax": torch.exp(logp), "Loss": loss}
