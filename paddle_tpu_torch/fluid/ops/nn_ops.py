"""NN ops (reference paddle/fluid/operators/{layer_norm,softmax}_op.cc)."""
from __future__ import annotations

import torch

from ...kernels.layer_norm import fused_layer_norm
from ..registry import register_op
from .common import one


@register_op("layer_norm", ref="paddle/fluid/operators/layer_norm_op.cc")
def layer_norm(ctx, ins, attrs):
    """Through the K1 router on every device: the hand-written kernel on
    a card, its plain version on the CPU (the JAX package takes its
    Pallas kernel single-device when kernels are enabled, jnp otherwise
    — the same function). Mean and Variance are [rows] over the leading
    dims, the variance rebuilt from the kernel's rstd."""
    y, mean, var = fused_layer_norm(
        one(ins, "X"), one(ins, "Scale"), one(ins, "Bias"),
        eps=float(attrs.get("epsilon", 1e-5)),
        begin_norm_axis=int(attrs.get("begin_norm_axis", 1)))
    return {"Y": y, "Mean": mean, "Variance": var}


@register_op("softmax", ref="paddle/fluid/operators/softmax_op.cc")
def softmax(ctx, ins, attrs):
    return {"Out": torch.softmax(one(ins, "X"), dim=-1)}
