"""Loss ops (reference paddle/fluid/operators/cross_entropy_op.cc,
softmax_with_cross_entropy_op.cc, sigmoid_cross_entropy_with_logits_op.cc,
smooth_l1_loss_op.cc, huber_loss_op.cc, log_loss_op.cc, hinge_loss_op.cc,
rank_loss_op.cc, margin_rank_loss_op.cc, squared_l2_distance_op.cc,
modified_huber_loss_op.cc, hierarchical_sigmoid_op.cc; the legacy
LambdaCost and ScaleSubRegionLayer) — the counterpart of
``paddle_tpu/fluid/ops/loss_ops.py``, formula for formula."""
from __future__ import annotations

import math

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


@register_op("sigmoid_cross_entropy_with_logits",
             ref="paddle/fluid/operators/"
                 "sigmoid_cross_entropy_with_logits_op.cc")
def sigmoid_cross_entropy_with_logits(ctx, ins, attrs):
    x, label = one(ins, "X"), one(ins, "Label")
    return {"Out": torch.clamp(x, min=0) - x * label
            + torch.log1p(torch.exp(-torch.abs(x)))}


@register_op("log_loss", ref="paddle/fluid/operators/log_loss_op.cc")
def log_loss(ctx, ins, attrs):
    p, label = one(ins, "Predicted"), one(ins, "Labels")
    eps = float(attrs.get("epsilon", 1e-4))
    return {"Loss": -label * torch.log(p + eps)
            - (1 - label) * torch.log(1 - p + eps)}


@register_op("hinge_loss", ref="paddle/fluid/operators/hinge_loss_op.cc")
def hinge_loss(ctx, ins, attrs):
    logits, label = one(ins, "Logits"), one(ins, "Labels")
    return {"Loss": torch.clamp(1.0 - (2.0 * label - 1.0) * logits, min=0.0)}


@register_op("rank_loss", ref="paddle/fluid/operators/rank_loss_op.cc")
def rank_loss(ctx, ins, attrs):
    """RankNet's pairwise cost ``log(1 + e^d) - label * d``,
    d = Left - Right."""
    label = one(ins, "Label")
    d = one(ins, "Left") - one(ins, "Right")
    return {"Out": torch.log1p(torch.exp(d)) - label * d}


@register_op("margin_rank_loss",
             ref="paddle/fluid/operators/margin_rank_loss_op.cc")
def margin_rank_loss(ctx, ins, attrs):
    label = one(ins, "Label")
    x1, x2 = one(ins, "X1"), one(ins, "X2")
    margin = float(attrs.get("margin", 0.0))
    out = torch.clamp(-label * (x1 - x2) + margin, min=0.0)
    return {"Out": out, "Activated": (out > 0).to(x1.dtype)}


@register_op("squared_l2_distance",
             ref="paddle/fluid/operators/squared_l2_distance_op.cc")
def squared_l2_distance(ctx, ins, attrs):
    d = one(ins, "X") - one(ins, "Y")
    return {"Out": torch.sum(d * d, dim=-1, keepdim=True), "sub_result": d}


@register_op("modified_huber_loss",
             ref="paddle/fluid/operators/modified_huber_loss_op.cc")
def modified_huber_loss(ctx, ins, attrs):
    x, y = one(ins, "X"), one(ins, "Y")
    z = (2.0 * y - 1.0) * x
    zero = torch.zeros_like(z)
    out = torch.where(z < -1.0, -4.0 * z,
                      torch.where(z < 1.0, (1.0 - z) * (1.0 - z), zero))
    return {"Out": out, "IntermediateVal": z}


@register_op("hierarchical_sigmoid", no_grad=("Label",),
             ref="paddle/fluid/operators/hierarchical_sigmoid_op.cc")
def hierarchical_sigmoid(ctx, ins, attrs):
    """Hierarchical sigmoid over a complete binary tree of K =
    ``num_classes`` leaves (the reference's matrix_bit_code): leaf
    ``label`` has code label + K; level j of its path is internal node
    (code >> (j + 1)) - 1, whose row of W [K-1, D] (and Bias [K-1])
    scores the branch bit (code >> j) & 1. A path is at most
    ceil(log2(2K)) levels; where K is not a power of two a shorter path
    masks its top levels off. Cost [N, 1] sums the sigmoid cross
    entropy over the path: O(log K) rows of W a sample in place of K."""
    x, w = one(ins, "X"), one(ins, "W")
    bias = one(ins, "Bias")
    num_classes = int(attrs["num_classes"])
    code = _squeeze_label(one(ins, "Label")).long() + num_classes  # [N]
    max_len = int(math.ceil(math.log2(2 * num_classes)))
    js = torch.arange(max_len, device=x.device)
    shifted = code[:, None] >> (js[None, :] + 1)                  # [N, L]
    valid = shifted >= 1
    node = torch.clamp(shifted - 1, 0, num_classes - 2)           # W rows
    bit = ((code[:, None] >> js[None, :]) & 1).to(x.dtype)
    z = torch.bmm(w[node].to(x.dtype), x[:, :, None])[..., 0]     # [N, L]
    if bias is not None:
        z = z + bias.reshape(-1)[node].to(z.dtype)
    ce = torch.nn.functional.softplus(z) - bit * z
    cost = torch.where(valid, ce, torch.zeros_like(ce)).sum(dim=1,
                                                          keepdim=True)
    return {"Cost": cost.to(x.dtype)}


@register_op("lambda_cost", no_grad=("Score", "Lengths"),
             ref="legacy paddle/gserver LambdaCost (trainer_config_helpers "
                 "lambda_cost) — LambdaRank listwise ranking cost")
def lambda_cost(ctx, ins, attrs):
    """LambdaRank's cost per query. X [N, T] model scores, Score [N, T]
    relevance, Lengths [N]. Each valid pair with r_i > r_j costs
    |dNDCG_ij| * log(1 + exp(-(s_i - s_j))), dNDCG from swapping the
    pair in the model's ranking (a stable descending sort, as
    ``jnp.argsort``'s), over the ideal DCG at ``NDCG_num``. Cost
    [N, 1]."""
    s = one(ins, "X").to(torch.float32)
    r = one(ins, "Score").to(torch.float32)
    lens = one(ins, "Lengths")
    ndcg_num = int(attrs.get("NDCG_num", 5))
    if s.ndim == 3 and s.shape[-1] == 1:
        s, r = s.squeeze(-1), r.squeeze(-1)
    T = s.shape[1]
    pos = torch.arange(T, device=s.device)
    valid = (pos[None, :] < lens[:, None]) if lens is not None else \
        torch.ones(s.shape, dtype=torch.bool, device=s.device)
    neg_inf = torch.full_like(s, -1e30)
    zero = torch.zeros_like(r)
    s_m = torch.where(valid, s, neg_inf)
    r_m = torch.where(valid, r, neg_inf)
    order = torch.argsort(-s_m, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True).to(torch.float32)
    discount = 1.0 / torch.log2(rank + 2.0)
    gain = torch.where(valid, torch.exp2(r_m) - 1.0, zero)
    r_sorted = -torch.sort(-torch.where(valid, r, zero), dim=1,
                           stable=True).values
    n_top = min(ndcg_num, T)
    ideal = torch.sum(
        (torch.exp2(r_sorted[:, :n_top]) - 1.0)
        / torch.log2(torch.arange(n_top, dtype=torch.float32,
                                  device=s.device) + 2.0), dim=1)
    ideal = torch.clamp(ideal, min=1e-6)[:, None, None]
    dgain = gain[:, :, None] - gain[:, None, :]
    ddisc = discount[:, :, None] - discount[:, None, :]
    dndcg = torch.abs(dgain * ddisc) / ideal
    pair = (r_m[:, :, None] > r_m[:, None, :]) \
        & valid[:, :, None] & valid[:, None, :]
    logistic = torch.nn.functional.softplus(-(s[:, :, None] - s[:, None, :]))
    cost = torch.where(pair, dndcg * logistic,
                       torch.zeros_like(logistic)).sum(dim=(1, 2))
    return {"Cost": cost[:, None]}


@register_op("scale_sub_region", no_grad=("Indices",),
             ref="legacy paddle/gserver ScaleSubRegionLayer "
                 "(trainer_config_helpers scale_sub_region_layer)")
def scale_sub_region(ctx, ins, attrs):
    """X [N, C, H, W] with each sample's box [c0:c1, h0:h1, w0:w1]
    (Indices [N, 6], 1-based and inclusive, the legacy layer's
    convention) scaled by ``value``."""
    x = one(ins, "X")
    idx = one(ins, "Indices").long()
    value = float(attrs.get("value", 1.0))
    mask = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    for d in range(3):
        ar = torch.arange(x.shape[d + 1], device=x.device).reshape(
            (1,) + tuple(-1 if k == d else 1 for k in range(3)))
        lo = idx[:, 2 * d].reshape(-1, 1, 1, 1) - 1
        hi = idx[:, 2 * d + 1].reshape(-1, 1, 1, 1) - 1
        mask = mask & (ar >= lo) & (ar <= hi)
    return {"Out": torch.where(mask, x * value, x)}
