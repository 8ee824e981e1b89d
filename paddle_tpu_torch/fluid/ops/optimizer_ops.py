"""Optimizer ops — device-side parameter updates (reference
paddle/fluid/operators/{sgd,momentum,adam,adagrad,adamax,adadelta,rmsprop,
decayed_adagrad,ftrl,proximal_gd,proximal_adagrad,average_accumulates}_op.*),
the counterpart of ``paddle_tpu/fluid/ops/optimizer_ops.py``. Each returns
the new state; the executor writes it back to the scope.

A SelectedRows gradient (a sparse ``lookup_table``'s): ``sgd`` adds it
row by row; ``momentum``, ``adam`` and ``adagrad`` update only the
merged rows through the first-occurrence mask (the reference's MergeAdd
before its sparse kernels; a bare scatter of per-entry deltas would
apply a repeated row's moment update twice); every other op densifies
it, as the JAX package's ``_dense_grad`` does."""
from __future__ import annotations

import torch

from ..registry import register_op
from ..selected_rows import is_selected_rows
from .common import one


def _sparse_grad(ins):
    """The merged SelectedRows gradient ``(rows, value, mask)``, the mask
    shaped to broadcast over a row, or None for a dense gradient."""
    g = one(ins, "Grad")
    if not is_selected_rows(g):
        return None
    rows, gm, mask = g.merged()
    return rows, gm, mask.reshape((-1,) + (1,) * (gm.ndim - 1))


def _dense_grad(ins):
    """The gradient, densified where it is a SelectedRows (correct, but
    without the memory win: the reference falls back so for optimizers
    with no SelectedRows kernel)."""
    g = one(ins, "Grad")
    return g.to_dense() if is_selected_rows(g) else g


def _rows_add(x, rows, delta):
    """x with ``delta`` added at ``rows`` (one order, repeatable)."""
    return x.index_put((rows,), delta, accumulate=True)


def _lr(ins):
    return one(ins, "LearningRate").reshape(())


@register_op("sgd", ref="paddle/fluid/operators/sgd_op.cc")
def sgd(ctx, ins, attrs):
    p, g = one(ins, "Param"), one(ins, "Grad")
    if is_selected_rows(g):
        # linear in g: a scatter-add takes repeated rows as they come
        # (reference sgd_op.h's SelectedRows branch)
        return {"ParamOut": _rows_add(p, g.rows, -_lr(ins) * g.value.to(
            p.dtype))}
    return {"ParamOut": p - _lr(ins) * g}


@register_op("momentum", ref="paddle/fluid/operators/momentum_op.cc")
def momentum(ctx, ins, attrs):
    """``v' = mu * v + g``; ``p' = p - lr * v'``, or with Nesterov
    ``p' = p - (g + mu * v') * lr``."""
    p, g, v = one(ins, "Param"), one(ins, "Grad"), one(ins, "Velocity")
    lr = _lr(ins)
    mu = float(attrs.get("mu", 0.9))
    nesterov = bool(attrs.get("use_nesterov", False))
    sparse = _sparse_grad(ins)
    if sparse is not None:
        rows, gm, mask = sparse
        v_rows, p_rows = v[rows], p[rows]
        v_new_rows = mu * v_rows + gm
        if nesterov:
            p_new_rows = p_rows - (gm + mu * v_new_rows) * lr
        else:
            p_new_rows = p_rows - lr * v_new_rows
        return {"ParamOut": _rows_add(p, rows, mask * (p_new_rows - p_rows)),
                "VelocityOut": _rows_add(v, rows,
                                         mask * (v_new_rows - v_rows))}
    v_new = mu * v + g
    if nesterov:
        p_new = p - (g + mu * v_new) * lr
    else:
        p_new = p - lr * v_new
    return {"ParamOut": p_new, "VelocityOut": v_new}


@register_op("adam", ref="paddle/fluid/operators/adam_op.cc")
def adam(ctx, ins, attrs):
    p, g = one(ins, "Param"), one(ins, "Grad")
    m1, m2 = one(ins, "Moment1"), one(ins, "Moment2")
    b1p, b2p = one(ins, "Beta1Pow"), one(ins, "Beta2Pow")
    lr = _lr(ins)
    b1 = float(attrs.get("beta1", 0.9))
    b2 = float(attrs.get("beta2", 0.999))
    eps = float(attrs.get("epsilon", 1e-8))
    lr_t = lr * torch.sqrt(1 - b2p.reshape(())) / (1 - b1p.reshape(()))
    sparse = _sparse_grad(ins)
    if sparse is not None:
        # lazy sparse Adam (reference SparseAdamFunctor, adam_op.h): the
        # moments and the parameter move on the batch's rows only
        rows, gm, mask = sparse
        m1r, m2r, pr = m1[rows], m2[rows], p[rows]
        m1n = b1 * m1r + (1 - b1) * gm
        m2n = b2 * m2r + (1 - b2) * gm * gm
        pn = pr - lr_t * m1n / (torch.sqrt(m2n) + eps)
        return {
            "ParamOut": _rows_add(p, rows, mask * (pn - pr)),
            "Moment1Out": _rows_add(m1, rows, mask * (m1n - m1r)),
            "Moment2Out": _rows_add(m2, rows, mask * (m2n - m2r)),
            "Beta1PowOut": b1p * b1, "Beta2PowOut": b2p * b2,
        }
    m1n = b1 * m1 + (1 - b1) * g
    m2n = b2 * m2 + (1 - b2) * g * g
    pn = p - lr_t * m1n / (torch.sqrt(m2n) + eps)
    return {
        "ParamOut": pn, "Moment1Out": m1n, "Moment2Out": m2n,
        "Beta1PowOut": b1p * b1, "Beta2PowOut": b2p * b2,
    }


@register_op("adagrad", ref="paddle/fluid/operators/adagrad_op.cc")
def adagrad(ctx, ins, attrs):
    p, g, m = one(ins, "Param"), one(ins, "Grad"), one(ins, "Moment")
    eps = float(attrs.get("epsilon", 1e-6))
    sparse = _sparse_grad(ins)
    if sparse is not None:
        rows, gm, mask = sparse
        mr, pr = m[rows], p[rows]
        mn = mr + gm * gm
        pn = pr - _lr(ins) * gm / (torch.sqrt(mn) + eps)
        return {"ParamOut": _rows_add(p, rows, mask * (pn - pr)),
                "MomentOut": _rows_add(m, rows, mask * (mn - mr))}
    mn = m + g * g
    return {"ParamOut": p - _lr(ins) * g / (torch.sqrt(mn) + eps),
            "MomentOut": mn}


@register_op("decayed_adagrad",
             ref="paddle/fluid/operators/decayed_adagrad_op.cc")
def decayed_adagrad(ctx, ins, attrs):
    p, g, m = one(ins, "Param"), _dense_grad(ins), \
        one(ins, "Moment")
    decay = float(attrs.get("decay", 0.95))
    eps = float(attrs.get("epsilon", 1e-6))
    mn = decay * m + (1 - decay) * g * g
    return {"ParamOut": p - _lr(ins) * g / (torch.sqrt(mn) + eps),
            "MomentOut": mn}


@register_op("adadelta", ref="paddle/fluid/operators/adadelta_op.cc")
def adadelta(ctx, ins, attrs):
    p, g = one(ins, "Param"), _dense_grad(ins)
    avg_sq_g = one(ins, "AvgSquaredGrad")
    avg_sq_u = one(ins, "AvgSquaredUpdate")
    rho = float(attrs.get("rho", 0.95))
    eps = float(attrs.get("epsilon", 1e-6))
    asg = rho * avg_sq_g + (1 - rho) * g * g
    update = -torch.sqrt((avg_sq_u + eps) / (asg + eps)) * g
    asu = rho * avg_sq_u + (1 - rho) * update * update
    return {"ParamOut": p + update, "AvgSquaredGradOut": asg,
            "AvgSquaredUpdateOut": asu}


@register_op("adamax", ref="paddle/fluid/operators/adamax_op.cc")
def adamax(ctx, ins, attrs):
    """The reference's adamax_op.h: eps joins the DECAYED norm before the
    max, and the step divides by the new norm with no further eps."""
    p, g = one(ins, "Param"), _dense_grad(ins)
    m, inf = one(ins, "Moment"), one(ins, "InfNorm")
    b1p = one(ins, "Beta1Pow").reshape(())
    b1 = float(attrs.get("beta1", 0.9))
    b2 = float(attrs.get("beta2", 0.999))
    eps = float(attrs.get("epsilon", 1e-8))
    mn = b1 * m + (1 - b1) * g
    infn = torch.maximum(torch.abs(g), b2 * inf + eps)
    pn = p - (_lr(ins) / (1 - b1p)) * mn / infn
    return {"ParamOut": pn, "MomentOut": mn, "InfNormOut": infn}


@register_op("rmsprop", ref="paddle/fluid/operators/rmsprop_op.cc")
def rmsprop(ctx, ins, attrs):
    p, g = one(ins, "Param"), _dense_grad(ins)
    ms, mom = one(ins, "MeanSquare"), one(ins, "Moment")
    decay = float(attrs.get("decay", 0.9))
    mu = float(attrs.get("momentum", 0.0))
    eps = float(attrs.get("epsilon", 1e-10))
    msn = decay * ms + (1 - decay) * g * g
    momn = mu * mom + _lr(ins) * g / torch.sqrt(msn + eps)
    return {"ParamOut": p - momn, "MeanSquareOut": msn, "MomentOut": momn}


@register_op("ftrl", ref="paddle/fluid/operators/ftrl_op.cc")
def ftrl(ctx, ins, attrs):
    """The reference's ftrl_op.h, with its two branches on ``lr_power``
    (square roots at -0.5, powers otherwise)."""
    p, g = one(ins, "Param"), _dense_grad(ins)
    sq, lin = one(ins, "SquaredAccumulator"), one(ins, "LinearAccumulator")
    lr = _lr(ins)
    l1 = float(attrs.get("l1", 0.0))
    l2 = float(attrs.get("l2", 0.0))
    power = float(attrs.get("lr_power", -0.5))
    new_sq = sq + g * g
    if power == -0.5:
        sigma = (torch.sqrt(new_sq) - torch.sqrt(sq)) / lr
        denom = torch.sqrt(new_sq) / lr + 2 * l2
    else:
        sigma = (torch.pow(new_sq, -power) - torch.pow(sq, -power)) / lr
        denom = torch.pow(new_sq, -power) / lr + 2 * l2
    new_lin = lin + g - sigma * p
    pre = torch.clamp(new_lin, -l1, l1) - new_lin
    return {"ParamOut": pre / denom, "SquaredAccumOut": new_sq,
            "LinearAccumOut": new_lin}


def _proximal(prox, lr, l1, l2):
    return (torch.sign(prox) * torch.clamp(torch.abs(prox) - lr * l1, min=0.0)
            / (1.0 + lr * l2))


@register_op("proximal_gd", ref="paddle/fluid/operators/proximal_gd_op.cc")
def proximal_gd(ctx, ins, attrs):
    p, g = one(ins, "Param"), _dense_grad(ins)
    lr = _lr(ins)
    return {"ParamOut": _proximal(p - lr * g, lr,
                                  float(attrs.get("l1", 0.0)),
                                  float(attrs.get("l2", 0.0)))}


@register_op("proximal_adagrad",
             ref="paddle/fluid/operators/proximal_adagrad_op.cc")
def proximal_adagrad(ctx, ins, attrs):
    p, g, m = one(ins, "Param"), _dense_grad(ins), \
        one(ins, "Moment")
    mn = m + g * g
    lr_t = _lr(ins) / torch.sqrt(mn)
    return {"ParamOut": _proximal(p - lr_t * g, lr_t,
                                  float(attrs.get("l1", 0.0)),
                                  float(attrs.get("l2", 0.0))),
            "MomentOut": mn}


@register_op("average_accumulates", no_grad=("Param",),
             ref="paddle/fluid/operators/average_accumulates_op.cc")
def average_accumulates(ctx, ins, attrs):
    """ModelAverage's accumulator update, the JAX package's branch logic
    as ``torch.where`` (no host read): ``sum_1`` gathers the parameter
    each step; every ``max_average_window`` updates it folds into
    ``sum_2``; when the window closes (at least ``min_average_window``
    accumulated, and at least ``average_window`` x updates) the sums
    move to ``sum_3`` and the counters reset. The counters are int64
    (the JAX package, without x64, holds them as int32); the window
    compares in float32, as there."""
    param = one(ins, "Param")
    sum_1, sum_2, sum_3 = one(ins, "Sum1"), one(ins, "Sum2"), one(ins, "Sum3")
    num_acc = one(ins, "NumAccumulates").reshape(()).to(torch.int64)
    old_num_acc = one(ins, "OldNumAccumulates").reshape(()).to(torch.int64)
    num_upd = one(ins, "NumUpdates").reshape(()).to(torch.int64)
    avg_window = float(attrs.get("average_window", 0.0))
    max_avg_win = int(attrs.get("max_average_window", 2 ** 31 - 1))
    min_avg_win = int(attrs.get("min_average_window", 10000))

    num_upd = num_upd + 1
    num_acc = num_acc + 1
    sum_1 = sum_1 + param

    zero = torch.zeros_like(sum_1)
    fold = num_upd % max_avg_win == 0
    sum_2 = torch.where(fold, sum_2 + sum_1, sum_2)
    sum_1 = torch.where(fold, zero, sum_1)

    window = torch.minimum(
        torch.tensor(float(max_avg_win), dtype=torch.float32,
                     device=num_upd.device),
        num_upd.to(torch.float32) * avg_window)
    close = (num_acc >= min_avg_win) & (num_acc.to(torch.float32) >= window)
    sum_3 = torch.where(close, sum_1 + sum_2, sum_3)
    sum_1 = torch.where(close, zero, sum_1)
    sum_2 = torch.where(close, zero, sum_2)
    old_num_acc = torch.where(close, num_acc, old_num_acc)
    num_acc = torch.where(close, torch.zeros_like(num_acc), num_acc)

    return {
        "SumOut1": sum_1, "SumOut2": sum_2, "SumOut3": sum_3,
        "NumAccumulatesOut": num_acc.reshape(1),
        "OldNumAccumulatesOut": old_num_acc.reshape(1),
        "NumUpdatesOut": num_upd.reshape(1),
    }
