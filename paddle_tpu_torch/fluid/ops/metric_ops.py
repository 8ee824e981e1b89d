"""Metric ops (reference paddle/fluid/operators/{accuracy,auc,
edit_distance,chunk_eval,precision_recall,positive_negative_pair}_op.*):
the counterpart of ``paddle_tpu/fluid/ops/metric_ops.py``.
``edit_distance`` and ``chunk_eval`` work on the whole batch at once, as
the JAX package's ``vmap``-ed forms do."""
from __future__ import annotations

import torch

from ..registry import register_op
from .common import one
from .ctc_ops import left_pack


@register_op("accuracy", no_grad=("Out", "Indices", "Label"),
             ref="paddle/fluid/operators/accuracy_op.cc")
def accuracy(ctx, ins, attrs):
    """A row is correct when its label is among its top-k indices:
    float32 Accuracy, int32 Correct and Total, each of shape [1]."""
    indices, label = one(ins, "Indices"), one(ins, "Label")
    if label.ndim >= 2 and label.shape[-1] == 1:
        label = label.squeeze(-1)
    n = indices.shape[0]
    correct = (indices == label[:, None]).any(dim=1).sum(dtype=torch.int32)
    return {
        "Accuracy": (correct.to(torch.float32) / n).reshape(1),
        "Correct": correct.reshape(1),
        "Total": torch.full((1,), n, dtype=torch.int32,
                            device=indices.device),
    }


def _auc_thresholds(num_t, device):
    """``jnp.linspace(0, 1, num_t)`` bit for bit: XLA computes i / (n - 1)
    as i times the float32 reciprocal of n - 1, and ends on 1.0. A score
    exactly on a threshold then falls on the JAX op's side of it."""
    if num_t < 2:
        return torch.zeros(num_t, dtype=torch.float32, device=device)
    recip = torch.tensor(1.0 / (num_t - 1), dtype=torch.float32,
                         device=device)
    t = torch.arange(num_t, dtype=torch.float32, device=device) * recip
    t[-1] = 1.0
    return t


@register_op("auc", no_grad=("Out", "Indices", "Label"),
             ref="paddle/fluid/operators/auc_op.cc")
def auc(ctx, ins, attrs):
    """One batch's ROC AUC: TPR and FPR at ``num_thresholds`` levels in
    [0, 1] (a score counts positive when above a level), joined by the
    trapezoid rule. Out's column 1 is the positive score (a [N, 2]
    softmax), else Out itself."""
    out, label = one(ins, "Out"), one(ins, "Label")
    num_t = int(attrs.get("num_thresholds", 200))
    pos_score = out[:, 1] if out.ndim == 2 and out.shape[1] >= 2 \
        else out.reshape(-1)
    lab = label.reshape(-1).to(torch.bool)
    pred = pos_score[None, :] > _auc_thresholds(num_t, out.device)[:, None]
    tp = (pred & lab[None, :]).sum(dim=1).to(torch.float32)
    fp = (pred & ~lab[None, :]).sum(dim=1).to(torch.float32)
    tpr = tp / torch.clamp(lab.sum(), min=1)
    fpr = fp / torch.clamp((~lab).sum(), min=1)
    return {"AUC": (-torch.trapezoid(tpr, fpr)).reshape(1)}


def _pack_tokens(x, lengths, ignored):
    """Drop negative, ignored and beyond-length tokens of each row of
    ``x`` [N, L] and left-pack the rest: (packed int32 [N, L] with -1
    after the kept tokens, kept count [N])."""
    keep = x >= 0
    if lengths is not None:
        keep &= torch.arange(x.shape[1], device=x.device)[None, :] \
            < lengths.reshape(-1, 1)
    for t in ignored:
        keep &= x != t
    return left_pack(x, keep)


@register_op("edit_distance", no_grad=("Hyps", "Refs", "HypsLength",
                                       "RefsLength"),
             ref="paddle/fluid/operators/edit_distance_op.cc")
def edit_distance(ctx, ins, attrs):
    """Levenshtein distance per row, float32 [N, 1]. Dense layout: negative
    ids and any id in `ignored_tokens` are filtered out (left-packed) before
    the DP, and the DP reads its answer at each row's effective length —
    equivalent to the reference's LoD-sliced sequences.

    One DP row per hypothesis token, for every pair at once: the row
    without insertions, min(up + 1, diagonal + cost), then insertions as a
    running minimum, cur[j] = min_k<=j (row[k] + j - k) — the JAX op's
    inner loop over j in one ``cummin`` (exact: small integers in float32).
    """
    hyps, refs = one(ins, "Hyps"), one(ins, "Refs")
    N = hyps.shape[0]
    seq_num = torch.full((1,), N, dtype=torch.int64, device=hyps.device)
    if hyps.device.type == "meta":
        return {"Out": hyps.new_empty((N, 1), dtype=torch.float32),
                "SequenceNum": seq_num}
    ignored = [int(t) for t in (attrs.get("ignored_tokens") or [])]
    hyps, m_eff = _pack_tokens(hyps.reshape(N, -1), one(ins, "HypsLength"),
                               ignored)
    refs, n_eff = _pack_tokens(refs.reshape(N, -1), one(ins, "RefsLength"),
                               ignored)
    j = torch.arange(refs.shape[1] + 1, device=refs.device,
                     dtype=torch.float32)[None, :]
    row = j.expand(N, -1)
    ans = row  # row 0 answers m == 0
    m_eff = m_eff.reshape(-1, 1)
    for i in range(1, hyps.shape[1] + 1):
        cost = (hyps[:, i - 1:i] != refs).to(torch.float32)  # [N, Lr]
        head = torch.full((N, 1), float(i), device=refs.device)
        tmp = torch.cat([head, torch.minimum(row[:, 1:] + 1.0,
                                             row[:, :-1] + cost)], dim=1)
        row = torch.cummin(tmp - j, dim=1).values + j
        ans = torch.where(m_eff == i, row, ans)
    d = torch.take_along_dim(ans, n_eff.reshape(-1, 1).long(), dim=1)
    if bool(attrs.get("normalized", False)):
        d = d / torch.clamp(n_eff.reshape(-1, 1).to(torch.float32), min=1.0)
    return {"Out": d, "SequenceNum": seq_num}


# chunk_eval's unified tag classes: 0=B 1=I 2=E 3=S 4=O
_SCHEMES = {"IOB": [0, 1], "IOE": [1, 2], "IOBES": [0, 1, 2, 3],
            "plain": [1]}


def _chunk_masks(seq, valid, tag_lut, type_lut, O):
    """Per position: does a chunk start here, does one end here (the
    conlleval start_of_chunk / end_of_chunk rules), and its type."""
    valid = valid & (seq >= 0)  # -1 padding counts as O
    ids = torch.clamp(seq.long(), 0, O)
    typ = torch.where(valid, type_lut[ids], -1)
    tag = torch.where(valid & (typ >= 0), tag_lut[ids], 4)  # excluded/O → O
    N = seq.shape[0]
    o_col, none_col = tag.new_full((N, 1), 4), typ.new_full((N, 1), -1)
    prev_tag = torch.cat([o_col, tag[:, :-1]], dim=1)
    prev_typ = torch.cat([none_col, typ[:, :-1]], dim=1)
    next_tag = torch.cat([tag[:, 1:], o_col], dim=1)
    next_typ = torch.cat([typ[:, 1:], none_col], dim=1)
    in_chunk = tag != 4
    start = in_chunk & ((tag == 0) | (tag == 3) | (prev_tag >= 2)
                        | (prev_typ != typ))
    end = in_chunk & ((tag == 2) | (tag == 3) | (next_tag == 0)
                      | (next_tag >= 3) | (next_typ != typ))
    return start, end, typ


def _next_end(end):
    """Per position, the index of the first chunk end at or after it (T+1
    if none)."""
    T = end.shape[1]
    idx = torch.arange(T, device=end.device)[None, :]
    cand = torch.where(end, idx, T + 1).flip(1)
    return torch.cummin(cand, dim=1).values.flip(1)


@register_op("chunk_eval",
             no_grad=("Inference", "Label", "SeqLength"),
             ref="paddle/fluid/operators/chunk_eval_op.cc")
def chunk_eval(ctx, ins, attrs):
    """Chunking precision/recall/F1 over dense [N, T] tag-id batches.

    The reference walks LoD sequences token-by-token on the host; here the
    conlleval start/end rules are evaluated as masks over the batch. Tag
    encoding (reference chunk_eval_op.h): label = chunk_type * num_tag
    + tag_type, O = num_chunk_types * num_tag; schemes IOB(2)/IOE(2)/
    IOBES(4)/plain(1). A chunk is correct where both start at the same
    position with the same type and end at the same position."""
    inference, label = one(ins, "Inference"), one(ins, "Label")
    seq_length = one(ins, "SeqLength")
    num_chunk_types = int(attrs["num_chunk_types"])
    tag_map = _SCHEMES[attrs.get("chunk_scheme", "IOB")]
    num_tag = len(tag_map)
    excluded = set(attrs.get("excluded_chunk_types", []) or [])
    O = num_chunk_types * num_tag
    dev = inference.device

    inference = inference.reshape(inference.shape[0], -1)
    label = label.reshape(label.shape[0], -1)
    N, T = inference.shape
    if seq_length is not None:
        valid = torch.arange(T, device=dev)[None, :] \
            < seq_length.reshape(-1, 1)
    else:
        valid = torch.ones((N, T), dtype=torch.bool, device=dev)
    tag_lut = torch.tensor([tag_map[i % num_tag] for i in range(O)] + [4],
                           device=dev)
    type_lut = torch.tensor(
        [-1 if i // num_tag in excluded else i // num_tag
         for i in range(O)] + [-1], device=dev)

    s_g, e_g, t_g = _chunk_masks(inference, valid, tag_lut, type_lut, O)
    s_l, e_l, t_l = _chunk_masks(label, valid, tag_lut, type_lut, O)
    correct = s_g & s_l & (t_g == t_l) & (_next_end(e_g) == _next_end(e_l))
    num_infer = s_g.sum(dtype=torch.int64)
    num_label = s_l.sum(dtype=torch.int64)
    num_correct = correct.sum(dtype=torch.int64)
    precision = num_correct.to(torch.float32) / torch.clamp(
        num_infer.to(torch.float32), min=1.0)
    recall = num_correct.to(torch.float32) / torch.clamp(
        num_label.to(torch.float32), min=1.0)
    f1 = torch.where(num_correct > 0, 2.0 * precision * recall / torch.clamp(
        precision + recall, min=1e-12), torch.zeros_like(precision))
    return {
        "Precision": precision.reshape(1),
        "Recall": recall.reshape(1),
        "F1-Score": f1.reshape(1),
        "NumInferChunks": num_infer.reshape(1),
        "NumLabelChunks": num_label.reshape(1),
        "NumCorrectChunks": num_correct.reshape(1),
    }


def _prf(st):
    """Macro (per-class mean) and micro precision, recall and F1 of
    per-class [tp, fp, tn, fn] rows."""
    tp, fp, fn = st[:, 0], st[:, 1], st[:, 3]

    def ratio(a, b):
        return torch.where(b > 0, a / torch.clamp(b, min=1e-12),
                           torch.zeros_like(a))

    prec, rec = ratio(tp, tp + fp), ratio(tp, tp + fn)
    f1 = ratio(2 * prec * rec, prec + rec)
    stp, sfp, sfn = tp.sum(), fp.sum(), fn.sum()
    mprec, mrec = ratio(stp, stp + sfp), ratio(stp, stp + sfn)
    mf1 = ratio(2 * mprec * mrec, mprec + mrec)
    return torch.stack([prec.mean(), rec.mean(), f1.mean(), mprec, mrec,
                        mf1])


@register_op("precision_recall",
             no_grad=("MaxProbs", "Indices", "Labels", "Weights",
                      "StatesInfo"),
             ref="paddle/fluid/operators/precision_recall_op.cc")
def precision_recall(ctx, ins, attrs):
    """Per-class weighted TP/FP/TN/FN of a batch and, through StatesInfo,
    of every batch so far; macro and micro precision, recall and F1 of
    each: BatchMetrics [6], AccumMetrics [6], AccumStatesInfo [C, 4]."""
    pred = one(ins, "Indices").reshape(-1).long()
    lab = one(ins, "Labels").reshape(-1).long()
    weights = one(ins, "Weights")
    states = one(ins, "StatesInfo")
    cls = torch.arange(int(attrs["class_number"]), device=pred.device)[:, None]
    w = (weights.reshape(-1).to(torch.float32) if weights is not None
         else torch.ones(pred.shape, dtype=torch.float32,
                         device=pred.device))[None, :]
    is_pred, is_lab = pred[None, :] == cls, lab[None, :] == cls
    zero = torch.zeros_like(w)

    def count(m):
        return torch.where(m, w, zero).sum(dim=1)

    batch = torch.stack([count(is_pred & is_lab), count(is_pred & ~is_lab),
                         count(~is_pred & ~is_lab), count(~is_pred & is_lab)],
                        dim=1)
    accum = batch if states is None else batch + states
    return {"BatchMetrics": _prf(batch), "AccumMetrics": _prf(accum),
            "AccumStatesInfo": accum}


@register_op("positive_negative_pair",
             no_grad=("Score", "Label", "QueryID", "AccumulatePositivePair",
                      "AccumulateNegativePair", "AccumulateNeutralPair",
                      "Weight"),
             ref="paddle/fluid/operators/positive_negative_pair_op.cc")
def positive_negative_pair(ctx, ins, attrs):
    """Ranking pairs a query: a pair of one query's items with different
    labels counts positive when the scores order it as the labels do,
    negative when inverted, neutral on a score tie, each weighted by the
    mean of its two weights; added to the Accumulate* inputs when given.
    [N, N] masks over the batch (the reference loops a query at a time
    on the host)."""
    score, label = one(ins, "Score"), one(ins, "Label")
    acc = [one(ins, "Accumulate" + k + "Pair")
           for k in ("Positive", "Negative", "Neutral")]
    weight = one(ins, "Weight")
    s = score if score.ndim == 1 else score[:, int(attrs.get("column", -1))]
    lb = label.reshape(-1)
    q = one(ins, "QueryID").reshape(-1)
    w = weight.reshape(-1) if weight is not None else torch.ones_like(s)
    upper = torch.triu(torch.ones(q.shape[0], q.shape[0], dtype=torch.bool,
                                  device=q.device), diagonal=1)
    cares = (q[:, None] == q[None, :]) & (lb[:, None] != lb[None, :]) & upper
    ds = s[:, None] - s[None, :]
    dl = lb[:, None] - lb[None, :]
    pw = 0.5 * (w[:, None] + w[None, :])
    zero = torch.zeros_like(pw)
    pairs = [torch.where(cares & m, pw, zero).sum()
             for m in (ds * dl > 0, ds * dl < 0, ds == 0)]
    if acc[0] is not None:
        pairs = [p + a.reshape(()) for p, a in zip(pairs, acc)]
    return dict(zip(("PositivePair", "NegativePair", "NeutralPair"),
                    (p.reshape(1) for p in pairs)))
