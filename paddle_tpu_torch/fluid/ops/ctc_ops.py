"""CTC ops (reference paddle/fluid/operators/{warpctc,ctc_align}_op.*) —
the counterpart of ``paddle_tpu/fluid/ops/ctc_ops.py``.

The reference dlopens Baidu warp-ctc (platform/dynload/warpctc); the JAX
package computes the loss as the standard log-space alpha recursion, a
``lax.scan`` over time under ``vmap`` over the batch. Here the recursion is
a Python loop over T on [N, S] tensors (the batch at once), with the JAX
op's finite NEG_INF and its ``lse``: with a true -inf, torch's logsumexp
gives NaN gradients. The loss's gradient is autograd's. On ``meta``
(shape inference) ``warpctc`` returns its output shapes without stepping.
"""
from __future__ import annotations

import torch

from ..registry import register_op
from .common import one

NEG_INF = -1e30


def _lse(a, b):
    """log(exp(a) + exp(b)) that stays finite at NEG_INF (the JAX op's:
    ``torch.maximum`` splits a tie's gradient evenly, as ``jnp.maximum``
    does, where ``clamp`` would not)."""
    m_ok = torch.maximum(torch.maximum(a, b), a.new_full((), NEG_INF))
    return m_ok + torch.log(torch.exp(a - m_ok) + torch.exp(b - m_ok))


def _ctc_loss(logp, label, in_len, lab_len, blank):
    """logp [N, T, C] log-probs, label [N, L] int, lengths [N]. Returns
    -log p(l|x) [N].

    Standard extended-label alpha recursion (Graves 2006): S = 2L+1 states
    interleaving blanks; transitions self / prev / prev-prev (skip only
    between distinct non-blank labels)."""
    N, T, C = logp.shape
    L = label.shape[1]
    S = 2 * L + 1
    dev = logp.device
    # extended label sequence: [blank, l0, blank, l1, ..., blank]
    ext = torch.full((N, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = torch.clamp(label.long(), 0, C - 1)
    ext_m2 = torch.cat([ext.new_full((N, 2), -1), ext[:, :-2]], dim=1)
    can_skip = (ext != blank) & (ext != ext_m2)
    s_idx = torch.arange(S, device=dev)[None, :]
    lab_len = lab_len.reshape(-1, 1).long()
    in_len = in_len.reshape(-1, 1).long()
    valid_s = s_idx < 2 * lab_len + 1
    lp = torch.take_along_dim(logp, ext[:, None, :], dim=2)  # [N, T, S]
    neg = logp.new_full((), NEG_INF)

    alpha = torch.where(s_idx == 0, lp[:, 0], neg)
    alpha = torch.where((s_idx == 1) & (lab_len > 0), lp[:, 0], alpha)
    alpha = torch.where(valid_s, alpha, neg)
    pad1, pad2 = logp.new_full((N, 1), NEG_INF), logp.new_full((N, 2),
                                                              NEG_INF)
    for t in range(1, T):
        prev1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        prev2 = torch.cat([pad2, alpha[:, :-2]], dim=1)
        acc = _lse(alpha, prev1)
        acc = torch.where(can_skip, _lse(acc, prev2), acc)
        new = torch.where(valid_s, acc + lp[:, t], neg)
        alpha = torch.where(t < in_len, new, alpha)
    end_blank = torch.clamp(2 * lab_len, 0, S - 1)      # final blank
    end_label = torch.clamp(2 * lab_len - 1, 0, S - 1)  # final label
    ll = _lse(torch.take_along_dim(alpha, end_blank, dim=1),
              torch.where(lab_len > 0,
                          torch.take_along_dim(alpha, end_label, dim=1), neg))
    return -ll[:, 0]


@register_op("warpctc", no_grad=("Label", "LogitsLength", "LabelLength"),
             ref="paddle/fluid/operators/warpctc_op.cc")
def warpctc(ctx, ins, attrs):
    """Inputs: Logits [N, T, C] raw activations (softmax applied inside, as
    warp-ctc does), Label [N, L] padded with -1 (or blank), optional
    LogitsLength [N] / LabelLength [N]. Output Loss [N, 1]; WarpCTCGrad is
    zeros (the gradient is autograd's)."""
    logits = one(ins, "Logits")
    label = one(ins, "Label")
    in_len = one(ins, "LogitsLength")
    lab_len = one(ins, "LabelLength")
    blank = int(attrs.get("blank", 0))
    N, T, _ = logits.shape
    if logits.device.type == "meta":
        return {"Loss": logits.new_empty((N, 1)),
                "WarpCTCGrad": torch.zeros_like(logits)}
    if label.ndim == 3 and label.shape[-1] == 1:
        label = label[..., 0]
    if in_len is None:
        in_len = torch.full((N,), T, dtype=torch.int32, device=logits.device)
    if lab_len is None:
        lab_len = ((label >= 0) & (label != blank)).sum(1, dtype=torch.int32)
    loss = _ctc_loss(torch.log_softmax(logits, dim=-1), label, in_len,
                     lab_len, blank)
    if bool(attrs.get("norm_by_times", False)):
        loss = loss / torch.clamp(in_len.reshape(-1).to(loss.dtype), min=1.0)
    return {"Loss": loss.reshape(-1, 1),
            "WarpCTCGrad": torch.zeros_like(logits)}


def left_pack(x, keep):
    """The kept entries of each row of ``x`` [N, L] moved to its front in
    order, -1 after them (int32), and the count kept a row: a scatter into
    an [N, L+1] buffer whose last column takes every dropped entry and is
    cut away."""
    N, L = x.shape
    pos = torch.cumsum(keep.to(torch.long), dim=1) - 1
    dest = torch.where(keep, pos, L)
    src = torch.where(keep, x.to(torch.int32), -1)
    out = torch.full((N, L + 1), -1, dtype=torch.int32, device=x.device)
    return out.scatter_(1, dest, src)[:, :L], keep.sum(1, dtype=torch.int32)


@register_op("ctc_align", no_grad=("Input", "InputLength"),
             ref="paddle/fluid/operators/ctc_align_op.cc")
def ctc_align(ctx, ins, attrs):
    """CTC greedy-decode post-processing: merge repeats, drop blanks.
    Input [N, T] argmax'd token ids; Output [N, T] int32 left-packed with
    -1 pad (the reference emits variable-length LoD; dense pad is the
    static equivalent), OutputLength [N, 1] int32."""
    x = one(ins, "Input")
    in_len = one(ins, "InputLength")
    blank = int(attrs.get("blank", 0))
    if x.ndim == 3 and x.shape[-1] == 1:
        x = x[..., 0]
    x = x.to(torch.int32)
    N, T = x.shape
    keep = x != blank
    if in_len is not None:
        keep &= torch.arange(T, device=x.device)[None, :] \
            < in_len.reshape(-1, 1)
    if bool(attrs.get("merge_repeated", True)):
        prev = torch.cat([x.new_full((N, 1), -1), x[:, :-1]], dim=1)
        keep &= x != prev
    out, count = left_pack(x, keep)
    return {"Output": out, "OutputLength": count.reshape(-1, 1)}
