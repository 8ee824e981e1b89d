"""Activation ops (reference paddle/fluid/operators/activation_op.cc) —
the counterpart of ``paddle_tpu/fluid/ops/activations.py``: the same
table of unary functions, in torch ops. Gradients come from the generic
autograd path."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..registry import register_op
from .common import one


def _unary(name, fn, ref="paddle/fluid/operators/activation_op.cc"):
    @register_op(name, ref=ref)
    def _op(ctx, ins, attrs, _fn=fn):
        return {"Out": _fn(one(ins, "X"), attrs)}

    return _op


def _f(a, key, default):
    return float(a.get(key, default))


def _softshrink(x, a):
    lam = _f(a, "lambda", 0.5)
    return torch.where(x > lam, x - lam,
                       torch.where(x < -lam, x + lam, torch.zeros_like(x)))


_unary("sigmoid", lambda x, a: torch.sigmoid(x))
_unary("logsigmoid", lambda x, a: F.logsigmoid(x))
_unary("exp", lambda x, a: torch.exp(x))
_unary("relu", lambda x, a: torch.relu(x))
_unary("tanh", lambda x, a: torch.tanh(x))
_unary("tanh_shrink", lambda x, a: x - torch.tanh(x))
_unary("sqrt", lambda x, a: torch.sqrt(x))
_unary("abs", lambda x, a: torch.abs(x))
_unary("ceil", lambda x, a: torch.ceil(x))
_unary("floor", lambda x, a: torch.floor(x))
_unary("cos", lambda x, a: torch.cos(x))
_unary("sin", lambda x, a: torch.sin(x))
_unary("round", lambda x, a: torch.round(x))  # half to even, as jnp
_unary("reciprocal", lambda x, a: 1.0 / x)
_unary("log", lambda x, a: torch.log(x))
_unary("log_softmax",
       lambda x, a: torch.log_softmax(x, dim=int(a.get("axis", -1))))
_unary("square", lambda x, a: torch.square(x))
# jax.nn.softplus is logaddexp(x, 0) at every x (F.softplus returns x
# itself above its threshold)
_unary("softplus", lambda x, a: torch.logaddexp(x, torch.zeros_like(x)))
_unary("softsign", lambda x, a: x / (1 + torch.abs(x)))
_unary("softshrink", _softshrink)
_unary("brelu", lambda x, a: torch.clamp(
    x, _f(a, "t_min", 0.0), _f(a, "t_max", 24.0)))
_unary("leaky_relu", lambda x, a: torch.where(
    x >= 0, x, _f(a, "alpha", 0.02) * x))
_unary("soft_relu", lambda x, a: torch.log(1 + torch.exp(torch.clamp(
    x, -_f(a, "threshold", 40.0), _f(a, "threshold", 40.0)))))
_unary("elu", lambda x, a: torch.where(
    x > 0, x, _f(a, "alpha", 1.0) * torch.expm1(
        torch.where(x > 0, torch.zeros_like(x), x))))
_unary("relu6", lambda x, a: torch.clamp(x, 0.0, _f(a, "threshold", 6.0)))
_unary("pow", lambda x, a: torch.pow(x, _f(a, "factor", 1.0)))
_unary("stanh", lambda x, a: _f(a, "scale_b", 1.7159) * torch.tanh(
    _f(a, "scale_a", 2.0 / 3.0) * x))
_unary("hard_sigmoid", lambda x, a: torch.clamp(
    _f(a, "slope", 0.2) * x + _f(a, "offset", 0.5), 0.0, 1.0))
_unary("swish", lambda x, a: x * torch.sigmoid(_f(a, "beta", 1.0) * x))
_unary("thresholded_relu", lambda x, a: torch.where(
    x > _f(a, "threshold", 1.0), x, torch.zeros_like(x)))
_unary("hard_shrink", lambda x, a: torch.where(
    torch.abs(x) > _f(a, "threshold", 0.5), x, torch.zeros_like(x)))
_unary("gelu", lambda x, a: F.gelu(x, approximate="none"))


@register_op("prelu", ref="paddle/fluid/operators/prelu_op.cc")
def prelu(ctx, ins, attrs):
    """Modes (reference prelu_op.cc): 'all' = one shared alpha;
    'channel' = one alpha per channel (dim 1 of NC...); 'element' = one
    alpha per element of x.shape[1:]."""
    x, alpha = one(ins, "X"), one(ins, "Alpha")
    mode = str(attrs.get("mode", "all"))
    if mode == "all":
        a = alpha.reshape(())
    elif mode == "channel":
        a = alpha.reshape((1, -1) + (1,) * (x.ndim - 2))
    else:  # element
        a = alpha.reshape((1,) + tuple(x.shape[1:]))
    return {"Out": torch.where(x > 0, x, a * x)}
