"""Noise-contrastive estimation (reference paddle/fluid/operators/
nce_op.{cc,h} and operators/math/sampler.*) — the counterpart of
``paddle_tpu/fluid/ops/nce_op.py``.

The negatives are drawn uniformly from ``ctx.rng(attrs)``: a generator
seeded from the step seed and the op's seeds. The grad op differentiates
the forward's autograd record, and a replayed forward draws the same
numbers, so the backward scores the forward's samples (the reference's
grad kernel reuses its sampled ids for the same reason). The draws are
torch's: they cannot match ``jax.random``'s, so a parity test hands the
JAX op the port's negatives.
"""
from __future__ import annotations

import torch

from ..registry import register_op
from .common import one


@register_op("nce", needs_rng=True,
             no_grad=("Label", "SampleWeight", "CustomDistribution"),
             ref="paddle/fluid/operators/nce_op.cc")
def nce(ctx, ins, attrs):
    """Input [N, D], Weight [V, D], optional Bias [V], Label [N,
    num_true]; attrs ``num_total_classes``, ``num_neg_samples``. Cost
    [N, 1] is the sigmoid cross entropy of the true and the sampled
    classes' logits, each corrected by log(k P_n) for the uniform noise
    P_n = 1/V; SampleLogits [N, S] and SampleLabels [N, S] (int64, the
    true classes first) are the parity slots."""
    x, w = one(ins, "Input"), one(ins, "Weight")
    bias = one(ins, "Bias")
    label = one(ins, "Label")
    num_classes = int(attrs["num_total_classes"])
    num_neg = int(attrs.get("num_neg_samples", 10))
    n = x.shape[0]
    if label.ndim == 1:
        label = label[:, None]
    num_true = label.shape[1]
    neg = torch.randint(0, num_classes, (n, num_neg), generator=ctx.rng(attrs),
                        device=ctx.device)
    samples = torch.cat([label.long(), neg], dim=1)            # [N, S]
    logits = torch.bmm(w[samples], x[:, :, None])[..., 0]      # [N, S]
    if bias is not None:
        logits = logits + bias.reshape(-1)[samples]
    log_kpn = torch.log(torch.tensor(num_neg / num_classes,
                                     dtype=logits.dtype, device=ctx.device))
    adj = logits - log_kpn
    is_true = torch.zeros_like(adj)
    is_true[:, :num_true] = 1.0
    loss = torch.clamp(adj, min=0) - adj * is_true \
        + torch.log1p(torch.exp(-torch.abs(adj)))
    return {"Cost": loss.sum(dim=1, keepdim=True), "SampleLogits": logits,
            "SampleLabels": samples}
