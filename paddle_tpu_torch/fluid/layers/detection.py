"""SSD detection layer functions (reference python/paddle/fluid/layers/
detection.py: prior_box, multi_box_head, bipartite_match, target_assign,
box_coder, detection_output, ssd_loss, detection_map), copied from
``paddle_tpu/fluid/layers/detection.py``.

Ground truth arrives as fixed-width padded tensors [N, G, ...] (-1
labels pad) instead of LoD; every matching op is ``no_grad``, so
``ssd_loss``'s gradient reaches only ``location`` and ``confidence``.
"""
from __future__ import annotations

import numpy as np

from ..layer_helper import LayerHelper
from . import nn, tensor

__all__ = [
    "prior_box", "multi_box_head", "bipartite_match", "target_assign",
    "box_coder", "detection_output", "ssd_loss", "detection_map",
    "iou_similarity", "multiclass_nms", "mine_hard_examples",
]


def iou_similarity(x, y, name=None):
    helper = LayerHelper("iou_similarity", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="iou_similarity", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=None,
              variance=None, flip=False, clip=False, steps=None, offset=0.5,
              name=None):
    helper = LayerHelper("prior_box", name=name)
    boxes = helper.create_variable_for_type_inference("float32")
    variances = helper.create_variable_for_type_inference("float32")
    steps = steps or [0.0, 0.0]
    helper.append_op(
        type="prior_box",
        inputs={"Input": [input], "Image": [image]},
        outputs={"Boxes": [boxes], "Variances": [variances]},
        attrs={
            "min_sizes": list(np.atleast_1d(min_sizes).astype(float)),
            "max_sizes": list(np.atleast_1d(max_sizes).astype(float))
            if max_sizes else [],
            "aspect_ratios": list(
                np.atleast_1d(aspect_ratios if aspect_ratios else [1.0])
                .astype(float)),
            "variances": list(
                np.atleast_1d(variance if variance else [0.1, 0.1, 0.2, 0.2])
                .astype(float)),
            "flip": flip, "clip": clip,
            "step_w": float(steps[0]), "step_h": float(steps[1]),
            "offset": offset,
        },
    )
    return boxes, variances


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, name=None):
    helper = LayerHelper("box_coder", name=name)
    out = helper.create_variable_for_type_inference(target_box.dtype)
    helper.append_op(
        type="box_coder",
        inputs={"PriorBox": [prior_box], "PriorBoxVar": [prior_box_var],
                "TargetBox": [target_box]},
        outputs={"OutputBox": [out]},
        attrs={"code_type": code_type, "box_normalized": box_normalized},
    )
    return out


def bipartite_match(dist_matrix, match_type="bipartite", dist_threshold=0.5,
                    name=None):
    helper = LayerHelper("bipartite_match", name=name)
    match_indices = helper.create_variable_for_type_inference("int32")
    match_dist = helper.create_variable_for_type_inference(dist_matrix.dtype)
    helper.append_op(
        type="bipartite_match",
        inputs={"DistMat": [dist_matrix]},
        outputs={"ColToRowMatchIndices": [match_indices],
                 "ColToRowMatchDist": [match_dist]},
        attrs={"match_type": match_type, "dist_threshold": dist_threshold},
    )
    return match_indices, match_dist


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=0, name=None):
    helper = LayerHelper("target_assign", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    out_weight = helper.create_variable_for_type_inference("float32")
    inputs = {"X": [input], "MatchIndices": [matched_indices]}
    if negative_indices is not None:
        inputs["NegIndices"] = [negative_indices]
    helper.append_op(
        type="target_assign", inputs=inputs,
        outputs={"Out": [out], "OutWeight": [out_weight]},
        attrs={"mismatch_value": mismatch_value},
    )
    return out, out_weight


def mine_hard_examples(cls_loss, match_indices, match_dist=None, loc_loss=None,
                       neg_pos_ratio=3.0, neg_dist_threshold=0.5, name=None):
    helper = LayerHelper("mine_hard_examples", name=name)
    neg_indices = helper.create_variable_for_type_inference("int32")
    updated = helper.create_variable_for_type_inference("int32")
    inputs = {"ClsLoss": [cls_loss], "MatchIndices": [match_indices]}
    if loc_loss is not None:
        inputs["LocLoss"] = [loc_loss]
    if match_dist is not None:
        inputs["MatchDist"] = [match_dist]
    helper.append_op(
        type="mine_hard_examples", inputs=inputs,
        outputs={"NegIndices": [neg_indices],
                 "UpdatedMatchIndices": [updated]},
        attrs={"neg_pos_ratio": neg_pos_ratio,
               "neg_dist_threshold": neg_dist_threshold},
    )
    return neg_indices, updated


def multiclass_nms(bboxes, scores, score_threshold=0.01, nms_top_k=64,
                   keep_top_k=100, nms_threshold=0.3, background_label=0,
                   nms_eta=1.0, name=None):
    helper = LayerHelper("multiclass_nms", name=name)
    out = helper.create_variable_for_type_inference(bboxes.dtype)
    helper.append_op(
        type="multiclass_nms",
        inputs={"BBoxes": [bboxes], "Scores": [scores]},
        outputs={"Out": [out]},
        attrs={"score_threshold": score_threshold, "nms_top_k": nms_top_k,
               "keep_top_k": keep_top_k, "nms_threshold": nms_threshold,
               "background_label": background_label, "nms_eta": nms_eta},
    )
    return out


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0):
    """Decode predicted offsets against priors then NMS
    (reference detection.py detection_output)."""
    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type="decode_center_size")
    scores = nn.softmax(scores)
    scores = nn.transpose(scores, perm=[0, 2, 1])  # [N, C, P]
    return multiclass_nms(decoded, scores, score_threshold=score_threshold,
                          nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                          nms_threshold=nms_threshold,
                          background_label=background_label, nms_eta=nms_eta)


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, offset=0.5, flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1):
    """Per-feature-map loc/conf conv heads + priors, concatenated
    (reference detection.py multi_box_head)."""
    n_layer = len(inputs)
    if min_sizes is None:
        # evenly spaced ratios between min_ratio and max_ratio (percent)
        min_sizes, max_sizes = [], []
        step = int((max_ratio - min_ratio) / (n_layer - 2)) if n_layer > 2 else 0
        for ratio in range(min_ratio, max_ratio + 1, max(step, 1)):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
        min_sizes = [base_size * 0.1] + min_sizes[:n_layer - 1]
        max_sizes = [base_size * 0.2] + max_sizes[:n_layer - 1]

    locs, confs, boxes_l, vars_l = [], [], [], []
    for i, feat in enumerate(inputs):
        ms = min_sizes[i] if isinstance(min_sizes[i], (list, tuple)) \
            else [min_sizes[i]]
        Ms = (max_sizes[i] if isinstance(max_sizes[i], (list, tuple))
              else [max_sizes[i]]) if max_sizes else []
        ar = aspect_ratios[i] if isinstance(aspect_ratios[i], (list, tuple)) \
            else [aspect_ratios[i]]
        step_lay = steps[i] if steps else [0.0, 0.0]
        if not isinstance(step_lay, (list, tuple)):
            step_lay = [step_lay, step_lay]
        box, var = prior_box(feat, image, ms, Ms, ar, flip=flip, clip=clip,
                             steps=step_lay, offset=offset)
        # num priors from static shape [H, W, np, 4]
        num_priors = box.shape[2]
        n_loc = num_priors * 4
        loc = nn.conv2d(feat, num_filters=n_loc, filter_size=kernel_size,
                        padding=pad, stride=stride)
        loc = nn.transpose(loc, perm=[0, 2, 3, 1])
        loc = nn.reshape(loc, shape=[0, -1, 4])
        n_conf = num_priors * num_classes
        conf = nn.conv2d(feat, num_filters=n_conf, filter_size=kernel_size,
                         padding=pad, stride=stride)
        conf = nn.transpose(conf, perm=[0, 2, 3, 1])
        conf = nn.reshape(conf, shape=[0, -1, num_classes])
        box = nn.reshape(box, shape=[-1, 4])
        var = nn.reshape(var, shape=[-1, 4])
        locs.append(loc)
        confs.append(conf)
        boxes_l.append(box)
        vars_l.append(var)

    mbox_locs = tensor.concat(locs, axis=1)
    mbox_confs = tensor.concat(confs, axis=1)
    boxes = tensor.concat(boxes_l, axis=0)
    variances = tensor.concat(vars_l, axis=0)
    return mbox_locs, mbox_confs, boxes, variances


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, match_type="per_prediction",
             mining_type="max_negative", normalize=True, sample_size=None):
    """SSD multibox loss = smooth-L1 loc loss on matched priors +
    softmax conf loss on matched + hard-negative priors
    (reference detection.py ssd_loss). Dense gt: gt_box [N, G, 4],
    gt_label [N, G] (−1 pad)."""
    helper = LayerHelper("ssd_loss")
    dtype = location.dtype
    # static prior count from the prior tensor [P, 4] (downstream op outputs
    # have no inferred shape, so reshape targets are built from it)
    num_priors = int(prior_box.shape[0])

    # 1. match priors to gt per image: iou [N, G, P]
    iou = iou_similarity(gt_box, prior_box)
    matched_indices, matched_dist = bipartite_match(
        iou, match_type, overlap_threshold)

    # 2. conf loss per prior (vs background) for mining
    num_classes = confidence.shape[-1]
    # gather gt labels for matched priors
    gathered_label, label_weight = target_assign(
        _gt_label_3d(gt_label), matched_indices,
        mismatch_value=background_label)
    conf_for_loss = nn.reshape(confidence, shape=[-1, num_classes])
    target_label_flat = nn.reshape(gathered_label, shape=[-1, 1])
    conf_loss = nn.softmax_with_cross_entropy(conf_for_loss,
                                              target_label_flat)
    conf_loss = nn.reshape(conf_loss, shape=[-1, num_priors])

    # 3. hard-negative mining
    neg_indices, updated_indices = mine_hard_examples(
        conf_loss, matched_indices, match_dist=matched_dist,
        neg_pos_ratio=neg_pos_ratio, neg_dist_threshold=neg_overlap)

    # 4. localization targets for matched priors, encoded center-size against
    # each prior — the loc head therefore learns the same code that
    # detection_output's decode_center_size expects at inference
    loc_target, loc_weight = target_assign(
        gt_box, matched_indices, mismatch_value=0)
    if prior_box_var is not None:
        loc_target = box_coder(prior_box, prior_box_var, loc_target,
                               code_type="encode_center_size")
    # per-prior smooth-L1 via the elementwise huber op (smooth_l1_loss sums
    # to [N, 1]; here mining needs a [N, P] map)
    hub = helper.create_variable_for_type_inference(dtype)
    resid = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="huber_loss", inputs={"X": [location], "Y": [loc_target]},
        outputs={"Out": [hub], "Residual": [resid]}, attrs={"delta": 1.0})
    loc_loss = nn.reduce_sum(hub, dim=-1)
    loc_loss = nn.elementwise_mul(
        loc_loss, nn.reshape(loc_weight, shape=[-1, num_priors]))

    # 5. conf loss over matched + mined negatives
    _, conf_weight = target_assign(_gt_label_3d(gt_label), updated_indices,
                                   negative_indices=neg_indices,
                                   mismatch_value=background_label)
    conf_loss = nn.elementwise_mul(
        conf_loss, nn.reshape(conf_weight, shape=[-1, num_priors]))

    loss = nn.elementwise_add(
        nn.scale(nn.reduce_sum(loc_loss, dim=-1), scale=loc_loss_weight),
        nn.scale(nn.reduce_sum(conf_loss, dim=-1), scale=conf_loss_weight))
    if normalize:
        # normalize by number of matched (positive) priors
        pos = tensor.cast(
            nn.reshape(label_weight, shape=[-1, num_priors]), "float32")
        denom = nn.reduce_sum(pos, dim=-1)
        denom = nn.elementwise_max(
            denom, tensor.fill_constant(shape=[1], dtype="float32", value=1.0))
        loss = nn.elementwise_div(loss, denom)
    return nn.reshape(loss, shape=[-1, 1])


def _gt_label_3d(gt_label):
    """[N, G] int labels -> [N, G, 1] for target_assign gather."""
    return nn.reshape(gt_label, shape=[gt_label.shape[0],
                                       gt_label.shape[1], 1])


def detection_map(detect_res, label, class_num, background_label=0,
                  overlap_threshold=0.5, evaluate_difficult=True,
                  ap_version="integral"):
    helper = LayerHelper("detection_map")
    map_out = helper.create_variable_for_type_inference("float32")
    accum_pos = helper.create_variable_for_type_inference("int32")
    accum_tp = helper.create_variable_for_type_inference("float32")
    accum_fp = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        type="detection_map",
        inputs={"DetectRes": [detect_res], "Label": [label]},
        outputs={"MAP": [map_out], "AccumPosCount": [accum_pos],
                 "AccumTruePos": [accum_tp], "AccumFalsePos": [accum_fp]},
        attrs={"overlap_threshold": overlap_threshold,
               "class_num": class_num,
               "background_label": background_label,
               "evaluate_difficult": evaluate_difficult,
               "ap_type": ap_version},
    )
    return map_out
