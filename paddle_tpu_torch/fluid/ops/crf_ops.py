"""Linear-chain CRF ops (reference paddle/fluid/operators/
{linear_chain_crf,crf_decoding}_op.*) — the counterpart of
``paddle_tpu/fluid/ops/crf_ops.py``.

The reference runs per-sequence host loops over LoD slices; the JAX
package runs the forward recursion and Viterbi as a ``lax.scan`` over the
padded time axis with a length mask. Here the same recursions are Python
loops over T on [N, ...] tensors (the whole batch at once), in log space
as the JAX op; the NLL's gradient is autograd's. On ``meta`` (shape
inference) the ops return their output shapes without stepping.

Transition layout matches the reference (linear_chain_crf_op.h): row 0 =
start weights a, row 1 = end weights b, rows 2.. = w[i][j] transition from
tag i to tag j; Transition shape [D+2, D].
"""
from __future__ import annotations

import torch

from ..registry import register_op
from .common import one
from .sequence_ops import _full_lengths


def _squeeze_label(label):
    if label.ndim == 3 and label.shape[-1] == 1:
        label = label[..., 0]
    return label


def _crf_log_alpha(emission, transition, lengths):
    """emission [N, T, D] log-potentials, transition [D+2, D], lengths [N].
    Returns the per-sequence log partition [N]."""
    a, b, w = transition[0], transition[1], transition[2:]
    T = emission.shape[1]
    alpha = a[None, :] + emission[:, 0]  # [N, D]
    for t in range(1, T):
        # logsumexp_i alpha[i] + w[i, j]
        nxt = torch.logsumexp(alpha[:, :, None] + w[None, :, :], dim=1) \
            + emission[:, t]
        alpha = torch.where((t < lengths)[:, None], nxt, alpha)
    return torch.logsumexp(alpha + b[None, :], dim=1)


def _crf_path_score(emission, transition, label, lengths):
    """Score of the gold path, log-space. label [N, T] int."""
    a, b, w = transition[0], transition[1], transition[2:]
    T, D = emission.shape[1], emission.shape[2]
    lab = torch.clamp(label.long(), 0, D - 1)
    valid = torch.arange(T, device=emission.device)[None, :] \
        < lengths[:, None]
    em = torch.take_along_dim(emission, lab[:, :, None], dim=2)[:, :, 0]
    zero = emission.new_zeros(())
    em_score = torch.sum(torch.where(valid, em, zero), dim=1)
    trans = w[lab[:, :-1], lab[:, 1:]]  # [N, T-1]
    trans_score = torch.sum(torch.where(valid[:, 1:], trans, zero), dim=1)
    last = torch.clamp(lengths.long() - 1, 0, T - 1)
    last_lab = torch.take_along_dim(lab, last[:, None], dim=1)[:, 0]
    return a[lab[:, 0]] + em_score + trans_score + b[last_lab]


@register_op("linear_chain_crf", no_grad=("Label", "Lengths"),
             ref="paddle/fluid/operators/linear_chain_crf_op.cc")
def linear_chain_crf(ctx, ins, attrs):
    """Negative log-likelihood per sequence. Inputs Emission [N, T, D] (raw
    scores; the reference internally exponentiates — this op stays in log
    space), Transition [D+2, D], Label [N, T]; optional Lengths [N]. Alpha,
    EmissionExps and TransitionExps hand the inputs back, as the JAX op's
    do (kept for the reference's output slots)."""
    emission = one(ins, "Emission")
    transition = one(ins, "Transition")
    label = _squeeze_label(one(ins, "Label"))
    lengths = one(ins, "Lengths")
    if lengths is None:
        lengths = _full_lengths(emission)
    if emission.device.type == "meta":
        nll = emission.new_empty((emission.shape[0], 1))
    else:
        nll = (_crf_log_alpha(emission, transition, lengths)
               - _crf_path_score(emission, transition, label, lengths))
    return {"LogLikelihood": nll.reshape(-1, 1), "Alpha": emission,
            "EmissionExps": emission, "TransitionExps": transition}


@register_op("crf_decoding", no_grad=("Emission", "Transition", "Label",
                                      "Lengths"),
             ref="paddle/fluid/operators/crf_decoding_op.cc")
def crf_decoding(ctx, ins, attrs):
    """Viterbi decode, int64 [N, T], 0 past each length. With Label given,
    outputs 1 where the viterbi path agrees with the label (reference
    semantics); else the path itself. Every argmax breaks a tie toward the
    lower tag, as ``jnp.argmax`` does."""
    emission = one(ins, "Emission")
    transition = one(ins, "Transition")
    label = one(ins, "Label")
    lengths = one(ins, "Lengths")
    N, T, D = emission.shape
    if emission.device.type == "meta":
        return {"ViterbiPath": emission.new_empty((N, T), dtype=torch.int64)}
    if lengths is None:
        lengths = _full_lengths(emission)
    a, b, w = transition[0], transition[1], transition[2:]
    lens = lengths.reshape(-1, 1).long()

    delta = a[None, :] + emission[:, 0]
    back = []  # back[t-1]: [N, D] best previous tag at step t, -1 past len
    for t in range(1, T):
        scores = delta[:, :, None] + w[None, :, :]  # [N, D_from, D_to]
        valid = t < lens
        delta = torch.where(valid, torch.amax(scores, dim=1) + emission[:, t],
                            delta)
        back.append(torch.where(valid, torch.argmax(scores, dim=1), -1))

    # the end weights at each sequence's true last step, then the trace
    # from t = T-1 down to 1 (a pointer of -1 keeps the tag)
    tag = torch.argmax(delta + b[None, :], dim=1, keepdim=True)  # [N, 1]
    path = [None] * T
    for t in range(T - 1, 0, -1):
        path[t] = tag
        ptr = torch.take_along_dim(back[t - 1], tag, dim=1)
        prev = torch.where(t < lens, ptr, tag)
        tag = torch.where(prev < 0, tag, prev)
    path[0] = tag
    path = torch.cat(path, dim=1)
    inside = torch.arange(T, device=emission.device)[None, :] < lens
    path = torch.where(inside, path, 0)
    if label is not None:
        agree = (path == _squeeze_label(label).long()).long()
        return {"ViterbiPath": torch.where(inside, agree, 0)}
    return {"ViterbiPath": path}
