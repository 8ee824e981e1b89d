"""Loss ops (reference paddle/fluid/operators/cross_entropy_op.cc,
softmax_with_cross_entropy_op.cc, smooth_l1_loss_op.cc,
huber_loss_op.cc)."""
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


@register_op("smooth_l1_loss", no_grad=("InsideWeight", "OutsideWeight"),
             ref="paddle/fluid/operators/smooth_l1_loss_op.cc")
def smooth_l1_loss(ctx, ins, attrs):
    """Per-row sum of the smooth L1 of (X - Y) * InsideWeight at sigma,
    times OutsideWeight: Out [N, 1], Diff the weighted difference."""
    x, y = one(ins, "X"), one(ins, "Y")
    iw, ow = one(ins, "InsideWeight"), one(ins, "OutsideWeight")
    sigma = float(attrs.get("sigma", 1.0))
    s2 = sigma * sigma
    d = x - y
    if iw is not None:
        d = d * iw
    ad = torch.abs(d)
    diff = torch.where(ad < 1.0 / s2, 0.5 * s2 * d * d, ad - 0.5 / s2)
    if ow is not None:
        diff = diff * ow
    out = diff.reshape(diff.shape[0], -1).sum(dim=1, keepdim=True)
    return {"Out": out, "Diff": d}


@register_op("huber_loss", ref="paddle/fluid/operators/huber_loss_op.cc")
def huber_loss(ctx, ins, attrs):
    """Elementwise Huber loss of the residual Y - X at ``delta``; the
    residual is the second output (``ssd_loss``'s location loss)."""
    x, y = one(ins, "X"), one(ins, "Y")
    delta = float(attrs.get("delta", 1.0))
    r = y - x
    ar = torch.abs(r)
    out = torch.where(ar <= delta, 0.5 * r * r, delta * (ar - 0.5 * delta))
    return {"Out": out, "Residual": r}
