"""Optimizer ops — device-side parameter updates (reference
paddle/fluid/operators/{sgd,momentum,adam}_op.*). Each returns the new
state; the executor writes it back to the scope. Dense gradients only
(SelectedRows are not ported)."""
from __future__ import annotations

import torch

from ..registry import register_op
from .common import one


@register_op("sgd", ref="paddle/fluid/operators/sgd_op.cc")
def sgd(ctx, ins, attrs):
    p, g, lr = one(ins, "Param"), one(ins, "Grad"), one(ins, "LearningRate")
    return {"ParamOut": p - lr.reshape(()) * g}


@register_op("momentum", ref="paddle/fluid/operators/momentum_op.cc")
def momentum(ctx, ins, attrs):
    """``v' = mu * v + g``; ``p' = p - lr * v'``, or with Nesterov
    ``p' = p - (g + mu * v') * lr``."""
    p, g, v = one(ins, "Param"), one(ins, "Grad"), one(ins, "Velocity")
    if g.layout != torch.strided:
        raise NotImplementedError(
            "momentum with a sparse (SelectedRows) gradient is not yet "
            "ported to paddle_tpu_torch")
    lr = one(ins, "LearningRate").reshape(())
    mu = float(attrs.get("mu", 0.9))
    v_new = mu * v + g
    if bool(attrs.get("use_nesterov", False)):
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    return {"ParamOut": p_new, "VelocityOut": v_new}


@register_op("adam", ref="paddle/fluid/operators/adam_op.cc")
def adam(ctx, ins, attrs):
    p, g = one(ins, "Param"), one(ins, "Grad")
    m1, m2 = one(ins, "Moment1"), one(ins, "Moment2")
    b1p, b2p = one(ins, "Beta1Pow"), one(ins, "Beta2Pow")
    lr = one(ins, "LearningRate").reshape(())
    b1 = float(attrs.get("beta1", 0.9))
    b2 = float(attrs.get("beta2", 0.999))
    eps = float(attrs.get("epsilon", 1e-8))
    lr_t = lr * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(()))
    m1n = b1 * m1 + (1 - b1) * g
    m2n = b2 * m2 + (1 - b2) * g * g
    pn = p - lr_t * m1n / (torch.sqrt(m2n) + eps)
    return {
        "ParamOut": pn, "Moment1Out": m1n, "Moment2Out": m2n,
        "Beta1PowOut": b1p * b1, "Beta2PowOut": b2p * b2,
    }
