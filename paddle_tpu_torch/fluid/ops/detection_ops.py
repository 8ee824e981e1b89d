"""SSD detection ops (reference paddle/fluid/operators/{prior_box,
box_coder,iou_similarity,bipartite_match,target_assign,multiclass_nms,
mine_hard_examples}_op.* and detection_map_op.*): the counterpart of
``paddle_tpu/fluid/ops/detection_ops.py``.

Every output keeps the JAX op's dense padded shape ([B, P, ...] with -1
labels and indices where the reference emits LoD). The JAX op's
sequential ``fori_loop``s (the greedy bipartite match over min(M, N)
rounds, NMS over the top ``nms_top_k`` boxes, the mAP matching over the
detections) are host loops over that sequential index only, each step
one batch of tensor ops over every image (and for NMS every class) at
once. Ties decide indices, so every sort is ``torch.sort(...,
stable=True)``: lower index first among equal keys, as ``lax.top_k``
and ``jnp.argsort``; ``torch.argmax`` takes the first maximum, as
``jnp.argmax``. A divisor is a tensor on the operands' device: PyTorch's
CUDA division by a host scalar multiplies by the reciprocal, an ulp off
the CPU's quotient. On ``meta`` (shape inference) the loop ops return
their shapes without stepping."""
from __future__ import annotations

import math

import torch

from ..registry import register_op
from .common import one


def _iou_matrix(a, b, eps=1e-10):
    """a [..., M, 4], b [..., N, 4] (xmin, ymin, xmax, ymax) -> [..., M,
    N] IoU, the JAX op's arithmetic in its order."""
    area_a = (torch.clamp(a[..., 2] - a[..., 0], min=0)
              * torch.clamp(a[..., 3] - a[..., 1], min=0))
    area_b = (torch.clamp(b[..., 2] - b[..., 0], min=0)
              * torch.clamp(b[..., 3] - b[..., 1], min=0))
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(union, min=eps)


def _sort_desc(x, dim=-1):
    """Values and indices in descending order, ties lower index first
    (``lax.top_k``'s order)."""
    return torch.sort(x, dim=dim, descending=True, stable=True)


@register_op("iou_similarity", no_grad=("X", "Y"),
             ref="paddle/fluid/operators/iou_similarity_op.cc")
def iou_similarity(ctx, ins, attrs):
    """X [M, 4] or batched [B, M, 4] against Y [N, 4]."""
    return {"Out": _iou_matrix(one(ins, "X"), one(ins, "Y"))}


@register_op("prior_box", no_grad=("Input", "Image"),
             ref="paddle/fluid/operators/prior_box_op.cc")
def prior_box(ctx, ins, attrs):
    """SSD priors of one feature map: Boxes [H, W, num_priors, 4] in
    normalised image coordinates, Variances the same shape. The
    expanded aspect ratios are 1.0 first, then each other ratio and,
    with ``flip``, its inverse; per min size those, then one prior per
    max size."""
    feat, image = one(ins, "Input"), one(ins, "Image")
    min_sizes = [float(s) for s in attrs["min_sizes"]]
    max_sizes = [float(s) for s in attrs.get("max_sizes", []) or []]
    aspect_ratios = [float(a) for a in attrs.get("aspect_ratios", [1.0])]
    variances = [float(v) for v in
                 attrs.get("variances", [0.1, 0.1, 0.2, 0.2])]
    flip = bool(attrs.get("flip", False))
    step_w = float(attrs.get("step_w", 0.0))
    step_h = float(attrs.get("step_h", 0.0))
    offset = float(attrs.get("offset", 0.5))
    h, w = feat.shape[2], feat.shape[3]
    ih, iw = image.shape[2], image.shape[3]
    if step_w == 0.0 or step_h == 0.0:
        step_w, step_h = iw / w, ih / h
    ars = [1.0]
    for ar in aspect_ratios:
        if abs(ar - 1.0) > 1e-6:
            ars.append(ar)
            if flip:
                ars.append(1.0 / ar)
    widths, heights = [], []
    for ms in min_sizes:
        for ar in ars:
            widths.append(ms * (ar ** 0.5))
            heights.append(ms / (ar ** 0.5))
        for big in max_sizes:
            widths.append((ms * big) ** 0.5)
            heights.append((ms * big) ** 0.5)
    dev = feat.device
    bw = torch.tensor(widths, dtype=torch.float32, device=dev) * 0.5
    bh = torch.tensor(heights, dtype=torch.float32, device=dev) * 0.5
    cx = ((torch.arange(w, dtype=torch.float32, device=dev) + offset)
          * step_w)[None, :, None]
    cy = ((torch.arange(h, dtype=torch.float32, device=dev) + offset)
          * step_h)[:, None, None]
    shape = (h, w, len(widths))
    # tensor divisors: PyTorch's CUDA division by a host scalar multiplies
    # by its reciprocal, an ulp off the CPU's quotient
    iw, ih = bw.new_tensor(float(iw)), bw.new_tensor(float(ih))
    boxes = torch.stack([((cx - bw) / iw).expand(shape),
                         ((cy - bh) / ih).expand(shape),
                         ((cx + bw) / iw).expand(shape),
                         ((cy + bh) / ih).expand(shape)], dim=-1)
    if bool(attrs.get("clip", False)):
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = torch.tensor(variances, dtype=torch.float32,
                       device=dev).expand(shape + (4,))
    return {"Boxes": boxes, "Variances": var}


@register_op("box_coder", no_grad=("PriorBox", "PriorBoxVar"),
             ref="paddle/fluid/operators/box_coder_op.cc")
def box_coder(ctx, ins, attrs):
    """Center-size encode of target boxes against the priors, or decode
    of predicted offsets. PriorBox, PriorBoxVar [P, 4]; TargetBox:
    encode [M, 4] -> Out [M, P, 4] (every pair), or [N, P, 4] already
    matched row by row -> [N, P, 4]; decode [N, P, 4] or [P, 4] -> the
    same shape."""
    prior = one(ins, "PriorBox")
    prior_var = one(ins, "PriorBoxVar")
    target = one(ins, "TargetBox")
    code_type = str(attrs.get("code_type", "encode_center_size"))
    off = 0.0 if bool(attrs.get("box_normalized", True)) else 1.0
    pw = prior[:, 2] - prior[:, 0] + off
    ph = prior[:, 3] - prior[:, 1] + off
    pcx = prior[:, 0] + pw * 0.5
    pcy = prior[:, 1] + ph * 0.5
    if prior_var is None:
        prior_var = torch.ones_like(prior)
    var = [prior_var[None, :, i] for i in range(4)]
    if code_type == "encode_center_size":
        tw = target[..., 2] - target[..., 0] + off
        th = target[..., 3] - target[..., 1] + off
        tcx = target[..., 0] + tw * 0.5
        tcy = target[..., 1] + th * 0.5
        if target.ndim == 3:  # paired: row p already matched to prior p
            ox = (tcx - pcx[None, :]) / pw[None, :] / var[0]
            oy = (tcy - pcy[None, :]) / ph[None, :] / var[1]
            ow = torch.log(torch.clamp(torch.abs(tw / pw[None, :]),
                                       min=1e-10)) / var[2]
            oh = torch.log(torch.clamp(torch.abs(th / ph[None, :]),
                                       min=1e-10)) / var[3]
        else:  # every pair: [M, 4] -> [M, P, 4]
            ox = (tcx[:, None] - pcx[None, :]) / pw[None, :] / var[0]
            oy = (tcy[:, None] - pcy[None, :]) / ph[None, :] / var[1]
            ow = torch.log(torch.abs(tw[:, None] / pw[None, :])) / var[2]
            oh = torch.log(torch.abs(th[:, None] / ph[None, :])) / var[3]
        out = torch.stack([ox, oy, ow, oh], dim=-1)
    elif code_type == "decode_center_size":
        t = target if target.ndim == 3 else target[None]
        dcx = var[0] * t[..., 0] * pw[None, :] + pcx[None, :]
        dcy = var[1] * t[..., 1] * ph[None, :] + pcy[None, :]
        dw = torch.exp(var[2] * t[..., 2]) * pw[None, :]
        dh = torch.exp(var[3] * t[..., 3]) * ph[None, :]
        out = torch.stack([dcx - dw * 0.5, dcy - dh * 0.5,
                           dcx + dw * 0.5 - off, dcy + dh * 0.5 - off],
                          dim=-1)
        if target.ndim == 2:
            out = out[0]
    else:
        raise ValueError(f"unknown code_type {code_type}")
    return {"OutputBox": out}


@register_op("bipartite_match", no_grad=("DistMat",),
             ref="paddle/fluid/operators/bipartite_match_op.cc")
def bipartite_match(ctx, ins, attrs):
    """Greedy bipartite matching on [B, M, N] (or [M, N]) similarities:
    min(M, N) rounds, each taking every image's global maximum (the
    first in row-major order), matching its row and column if it is
    positive and masking both out. ``per_prediction`` then gives each
    unmatched column its best row (the first maximum) above
    ``dist_threshold``. ColToRowMatchIndices [B, N] int32 (-1
    unmatched), ColToRowMatchDist [B, N]."""
    dist = one(ins, "DistMat")
    match_type = str(attrs.get("match_type", "bipartite"))
    thresh = float(attrs.get("dist_threshold", 0.5))
    d = dist if dist.ndim == 3 else dist[None]
    b, m, n = d.shape
    row_idx = torch.full((b, n), -1, dtype=torch.int32, device=d.device)
    row_dist = d.new_zeros((b, n))
    if d.device.type == "meta":
        return {"ColToRowMatchIndices": row_idx,
                "ColToRowMatchDist": row_dist}
    rows = torch.arange(m, device=d.device)[None, :, None]
    cols = torch.arange(n, device=d.device)[None, None, :]
    neg = torch.tensor(-1e9, dtype=d.dtype, device=d.device)
    dm = d
    for _ in range(min(m, n)):
        flat = dm.reshape(b, -1).argmax(dim=1)
        best = torch.take_along_dim(dm.reshape(b, -1), flat[:, None],
                                    dim=1)[:, 0]
        i, j = flat // n, flat % n
        do = best > 0
        hit = do[:, None] & (cols[0] == j[:, None])           # [B, N]
        row_idx = torch.where(hit, i[:, None].to(torch.int32), row_idx)
        row_dist = torch.where(hit, best[:, None], row_dist)
        out = ((rows == i[:, None, None]) | (cols == j[:, None, None]))
        dm = torch.where(do[:, None, None] & out, neg, dm)
    if match_type == "per_prediction":
        best_row = d.argmax(dim=1, keepdim=True)
        best_val = torch.take_along_dim(d, best_row, dim=1)[:, 0]
        best_row = best_row[:, 0].to(torch.int32)
        take = (row_idx < 0) & (best_val > thresh)
        row_idx = torch.where(take, best_row, row_idx)
        row_dist = torch.where(take, best_val, row_dist)
    return {"ColToRowMatchIndices": row_idx, "ColToRowMatchDist": row_dist}


@register_op("target_assign", no_grad=("X", "MatchIndices", "NegIndices"),
             ref="paddle/fluid/operators/target_assign_op.cc")
def target_assign(ctx, ins, attrs):
    """Per-prior targets gathered from each image's ground-truth rows X
    [B, M, K] by MatchIndices [B, P] (-1: background): Out [B, P, K]
    (``mismatch_value`` where unmatched), OutWeight [B, P, 1] float32, 1
    where matched and, given NegIndices ([B, *] with -1 padding), at
    those priors too."""
    x = one(ins, "X")
    match = one(ins, "MatchIndices")
    neg = one(ins, "NegIndices")
    mismatch_value = attrs.get("mismatch_value", 0)
    if x.ndim == 2:
        x = x[None]
    b, p = match.shape
    safe = torch.clamp(match, 0, x.shape[1] - 1).long()
    gathered = torch.take_along_dim(x, safe[:, :, None], dim=1)
    matched = (match >= 0)[:, :, None]
    out = torch.where(matched, gathered,
                      torch.tensor(mismatch_value, dtype=x.dtype,
                                   device=x.device))
    w = matched.to(torch.float32)
    if neg is not None:
        neg = neg.reshape(b, -1)
        valid = (neg >= 0).to(torch.float32)
        neg_mask = w.new_zeros((b, p)).scatter_add(
            1, torch.clamp(neg, 0, p - 1).long(), valid)
        w = torch.clamp(w + neg_mask[:, :, None], 0.0, 1.0)
    return {"Out": out, "OutWeight": w}


@register_op("mine_hard_examples",
             no_grad=("ClsLoss", "LocLoss", "MatchIndices", "MatchDist"),
             ref="paddle/fluid/operators/mine_hard_examples_op.cc")
def mine_hard_examples(ctx, ins, attrs):
    """Max-negative mining: each image's negatives (unmatched, and below
    ``neg_dist_threshold`` when MatchDist is given) ranked by loss, the
    top ``neg_pos_ratio`` x positives kept. NegIndices [B, P] int32 with
    -1 padding; UpdatedMatchIndices the matches, -1 elsewhere."""
    cls_loss = one(ins, "ClsLoss")
    loc_loss = one(ins, "LocLoss")
    match = one(ins, "MatchIndices")
    match_dist = one(ins, "MatchDist")
    neg_pos_ratio = float(attrs.get("neg_pos_ratio", 3.0))
    neg_dist_threshold = float(attrs.get("neg_dist_threshold", 0.5))
    loss = cls_loss if loc_loss is None else cls_loss + loc_loss
    is_neg = match < 0
    if match_dist is not None:
        is_neg = is_neg & (match_dist < neg_dist_threshold)
    num_pos = (match >= 0).to(torch.int32).sum(dim=1)
    num_neg = torch.minimum(
        (num_pos.to(torch.float32) * neg_pos_ratio).to(torch.int32),
        is_neg.to(torch.int32).sum(dim=1))
    neg_loss = torch.where(is_neg, loss,
                           torch.tensor(-math.inf, dtype=loss.dtype,
                                        device=loss.device))
    order = _sort_desc(neg_loss, dim=1)[1].to(torch.int32)
    rank = torch.arange(match.shape[1], device=match.device)[None, :]
    neg_indices = torch.where(rank < num_neg[:, None], order,
                              torch.full_like(order, -1))
    updated = torch.where(match >= 0, match, torch.full_like(match, -1))
    return {"NegIndices": neg_indices, "UpdatedMatchIndices": updated}


@register_op("multiclass_nms", no_grad=("BBoxes", "Scores"),
             ref="paddle/fluid/operators/multiclass_nms_op.cc")
def multiclass_nms(ctx, ins, attrs):
    """Per-class greedy NMS with a fixed output: BBoxes [B, P, 4], Scores
    [B, C, P] -> Out [B, keep_top_k, 6] (label, score, xmin, ymin, xmax,
    ymax), -1 rows past the detections. Every image and class at once as
    [B, C', k] (C' the classes but the background, k = min(nms_top_k,
    P)): the loop over the k candidates keeps one unless an earlier kept
    box of its class overlaps it above the threshold, which
    ``nms_eta`` < 1 shrinks after each kept box while it is above 0.5;
    then the best ``keep_top_k`` of the C' x k, class-major as the JAX
    op concatenates them."""
    bboxes = one(ins, "BBoxes")
    scores = one(ins, "Scores")
    score_threshold = float(attrs.get("score_threshold", 0.01))
    nms_threshold = float(attrs.get("nms_threshold", 0.3))
    nms_top_k = int(attrs.get("nms_top_k", 64))
    keep_top_k = int(attrs.get("keep_top_k", 100))
    background_label = int(attrs.get("background_label", 0))
    nms_eta = float(attrs.get("nms_eta", 1.0))
    if bboxes.ndim == 2:
        bboxes, scores = bboxes[None], scores[None]
    b, p, _ = bboxes.shape
    classes = [c for c in range(scores.shape[1]) if c != background_label]
    if bboxes.device.type == "meta":
        return {"Out": bboxes.new_empty((b, keep_top_k, 6))}
    dev = bboxes.device
    k = min(nms_top_k, p)
    top_sc, top_idx = _sort_desc(scores[:, classes])          # [B, C', P]
    top_sc, top_idx = top_sc[..., :k], top_idx[..., :k]
    top_boxes = torch.take_along_dim(bboxes[:, None],
                                     top_idx[..., None], dim=2)
    iou = _iou_matrix(top_boxes, top_boxes)                   # [B, C', k, k]
    keep = torch.zeros(top_sc.shape, dtype=torch.bool, device=dev)
    thresh = torch.full(top_sc.shape[:2], nms_threshold,
                        dtype=torch.float32, device=dev)
    for i in range(k):
        sup = ((iou[..., i, :] > thresh[..., None]) & keep).any(dim=-1)
        ok = ~sup & (top_sc[..., i] > score_threshold)
        if nms_eta < 1.0:
            thresh = torch.where(ok & (thresh > 0.5), thresh * nms_eta,
                                 thresh)
        keep[..., i] = ok
    all_sc = torch.where(keep, top_sc, torch.full_like(top_sc, -1.0))
    labels = torch.tensor(classes, dtype=torch.float32,
                          device=dev).repeat_interleave(k)
    cs = all_sc.reshape(b, -1)
    cb = top_boxes.reshape(b, -1, 4)
    kk = min(keep_top_k, cs.shape[1])
    top_s, top_i = _sort_desc(cs)
    top_s, top_i = top_s[:, :kk], top_i[:, :kk]
    live = top_s > 0
    dead = torch.tensor(-1.0, device=dev)
    out = torch.cat([torch.where(live, labels[top_i], dead)[..., None],
                     top_s[..., None],
                     torch.where(live[..., None],
                                 torch.take_along_dim(cb, top_i[..., None],
                                                      dim=1), dead)],
                    dim=-1)
    if kk < keep_top_k:
        out = torch.cat([out, out.new_full((b, keep_top_k - kk, 6), -1.0)],
                        dim=1)
    return {"Out": out}


@register_op("detection_map",
             no_grad=("DetectRes", "Label", "HasState", "PosCount",
                      "TruePos", "FalsePos"),
             ref="paddle/fluid/operators/detection_map_op.cc")
def detection_map(ctx, ins, attrs):
    """Mean average precision of one batch of dense detections DetectRes
    [B, D, 6] (label, score, box; label < 0 pads) against Label [B, G, 6]
    (label, box, difficult) or [B, G, 5]: each image's detections, in
    score order, greedily matched to an unused ground truth of their
    label at IoU >= ``overlap_threshold`` (a loop over the D ranks, every
    image at once); then every class at once: precision and recall over
    the batch's detections of the class in score order, AP 11-point or
    integral, the mean over classes with ground truth. The integral's
    sums run in float64 and round once to float32: exact, so the card
    and the CPU agree bitwise (XLA's float32 sums run in an order of
    their own, so the JAX op's mAP may sit an ulp or two away). The
    Accum* outputs are zeros, as the JAX op's."""
    det = one(ins, "DetectRes")
    gt = one(ins, "Label")
    overlap_threshold = float(attrs.get("overlap_threshold", 0.5))
    ap_type = str(attrs.get("ap_type", "integral"))
    class_num = int(attrs.get("class_num", 21))
    background_label = int(attrs.get("background_label", 0))
    evaluate_difficult = bool(attrs.get("evaluate_difficult", True))
    dev = det.device
    zeros = {"AccumPosCount": torch.zeros(1, dtype=torch.int32, device=dev),
             "AccumTruePos": torch.zeros((1, 2), device=dev),
             "AccumFalsePos": torch.zeros((1, 2), device=dev)}
    if dev.type == "meta":
        return {"MAP": torch.empty(1, device=dev), **zeros}
    if det.ndim == 2:
        det, gt = det[None], gt[None]
    b, d, _ = det.shape
    g = gt.shape[1]
    gt_label = gt[..., 0].to(torch.int32)
    gt_valid = gt_label >= 0
    if gt.shape[2] == 6 and not evaluate_difficult:
        gt_valid = gt_valid & (gt[..., 5] < 0.5)
    dlab = det[..., 0].to(torch.int32)
    same = dlab[:, :, None] == gt_label[:, None, :]
    iou = _iou_matrix(det[..., 2:6], gt[..., 1:5])            # [B, D, G]
    iou = torch.where(same & gt_valid[:, None, :], iou,
                      torch.zeros_like(iou))
    order = _sort_desc(det[..., 1], dim=1)[1]                 # [B, D]
    used = torch.zeros((b, g), dtype=torch.bool, device=dev)
    tp = torch.zeros((b, d), dtype=torch.bool, device=dev)
    gcols = torch.arange(g, device=dev)[None, :]
    for t in range(d):
        i = order[:, t:t + 1]                                 # [B, 1]
        row = torch.take_along_dim(iou, i[:, :, None], dim=1)[:, 0]
        row = torch.where(used, torch.zeros_like(row), row)   # [B, G]
        j = row.argmax(dim=1, keepdim=True)
        ok = ((torch.take_along_dim(row, j, dim=1) >= overlap_threshold)
              & (torch.take_along_dim(dlab, i, dim=1) >= 0))  # [B, 1]
        used = used | ((gcols == j) & ok)
        tp = tp.scatter(1, i, ok)
    classes = torch.tensor([c for c in range(class_num)
                            if c != background_label], device=dev)
    dvalid = (dlab >= 0).reshape(1, -1)
    m = dvalid & (dlab.reshape(1, -1) == classes[:, None])     # [C', BD]
    npos = (gt_valid.reshape(1, -1)
            & (gt_label.reshape(1, -1) == classes[:, None])).sum(dim=1)
    sc = torch.where(m, det[..., 1].reshape(1, -1),
                     torch.tensor(-math.inf, device=dev))
    tpc = tp.reshape(1, -1) & m
    order = _sort_desc(sc, dim=1)[1]
    tp_sorted = torch.take_along_dim(tpc, order, dim=1)
    valid_sorted = torch.take_along_dim(m, order, dim=1)
    tps = torch.cumsum(tp_sorted.to(torch.float32), dim=1)
    fps = torch.cumsum((valid_sorted & ~tp_sorted).to(torch.float32), dim=1)
    rec = tps / torch.clamp(npos.to(torch.float32), min=1.0)[:, None]
    prec = tps / torch.clamp(tps + fps, min=1e-12)
    if ap_type == "11point":
        # jnp.linspace(0, 1, 11): i x float32(0.1)
        pts = torch.arange(11, dtype=torch.float32, device=dev) * 0.1
        pmax = torch.where(rec[:, None, :] >= pts[None, :, None],
                           prec[:, None, :], torch.zeros_like(
                               prec[:, None, :])).amax(dim=2)   # [C', 11]
        ap = (pmax.to(torch.float64).sum(dim=1)
              / pmax.new_tensor(11.0, dtype=torch.float64)).to(torch.float32)
    else:
        drec = torch.diff(rec, dim=1, prepend=torch.zeros_like(rec[:, :1]))
        ap = (prec * drec).to(torch.float64).sum(dim=1).to(torch.float32)
    has = npos > 0
    count = has.sum()
    m_ap = torch.where(has, ap.to(torch.float64),
                       torch.zeros_like(ap, dtype=torch.float64)).sum()
    m_ap = torch.where(count > 0, m_ap / count.clamp(min=1),
                       torch.zeros_like(m_ap)).to(torch.float32)
    return {"MAP": m_ap.reshape(1), **zeros}
