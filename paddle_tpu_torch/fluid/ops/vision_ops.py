"""Vision-file ops (reference paddle/fluid/operators/{row_conv,lstmp}_op.*):
the counterpart of ``paddle_tpu/fluid/ops/vision_ops.py`` for the two ops
the text paths run, ``row_conv`` and ``lstmp``. As in the JAX package's
``lstm``, the recurrence is a Python loop over the time steps (the JAX op's
``lax.scan``) and its gradient is autograd's; on ``meta`` (shape
inference) it returns the output shapes without stepping."""
from __future__ import annotations

import torch

from ..registry import register_op
from .common import one
from .sequence_ops import _ACTS, _full_lengths, _mask


@register_op("row_conv", no_grad=("Lengths",),
             ref="paddle/fluid/operators/row_conv_op.cc")
def row_conv(ctx, ins, attrs):
    """Lookahead row convolution (DeepSpeech2): out[t] = sum_{k<ctx}
    x[t+k] * w[k]. X [N, T, D] padded (reference is LoD); the window stops
    at each sequence's REAL end — lookahead must not read pad frames."""
    x = one(ins, "X")
    w = one(ins, "Filter")
    lengths = one(ins, "Lengths")
    T = x.shape[1]
    if lengths is not None:
        x = x * _mask(lengths, T, x.dtype)[:, :, None]
    out = torch.zeros_like(x)
    for k in range(min(w.shape[0], T)):  # lookahead past T is all-pad: zero
        shifted = torch.nn.functional.pad(x[:, k:], (0, 0, 0, k))
        out = out + shifted * w[k][None, None, :]
    return {"Out": out}


@register_op("lstmp", no_grad=("Lengths",),
             ref="paddle/fluid/operators/lstmp_op.cc")
def lstmp(ctx, ins, attrs):
    """LSTM with recurrent projection: like lstm but the recurrent state fed
    back is r_t = proj_activation(h_t @ ProjWeight); Weight is [P, 4H],
    ProjWeight [H, P], Bias [1, 4H] or [1, 7H] with peepholes. Unlike
    ``gru``, ``is_reverse`` reverses each sequence's VALID prefix (index
    len-1-t for t < len), as the JAX op does, so padding stays at the
    tail."""
    x = one(ins, "Input")            # [N, T, 4H] pre-activated
    w = one(ins, "Weight")           # [P, 4H]
    proj_w = one(ins, "ProjWeight")  # [H, P]
    bias = one(ins, "Bias")
    h0, c0 = one(ins, "H0"), one(ins, "C0")
    lengths = one(ins, "Lengths")
    use_peepholes = bool(attrs.get("use_peepholes", False))
    is_reverse = bool(attrs.get("is_reverse", False))
    g_act = _ACTS[attrs.get("gate_activation", "sigmoid")]
    c_act = _ACTS[attrs.get("cell_activation", "tanh")]
    cand_act = _ACTS[attrs.get("candidate_activation", "tanh")]
    # reference lstmp_op.h applies proj_activation to r_t BEFORE feedback
    p_act = _ACTS[attrs.get("proj_activation", "tanh")]

    N, T, H4 = x.shape
    H = H4 // 4
    P = proj_w.shape[1]
    w_ic = w_fc = w_oc = x.new_zeros((1, H))
    if bias is not None:
        x = x + (bias[:, :4 * H] if bias.ndim == 2 else bias[None, :4 * H])
        if use_peepholes and bias.shape[-1] >= 7 * H:
            w_ic = bias[..., 4 * H:5 * H].reshape(1, H)
            w_fc = bias[..., 5 * H:6 * H].reshape(1, H)
            w_oc = bias[..., 6 * H:7 * H].reshape(1, H)
    r = x.new_zeros((N, P)) if h0 is None else p_act(h0 @ proj_w)
    r0 = r
    c = x.new_zeros((N, H)) if c0 is None else c0
    if x.device.type == "meta":
        proj, cell = x.new_empty((N, T, P)), x.new_empty((N, T, H))
        return {"Projection": proj, "Cell": cell, "BatchedProjection": proj,
                "BatchedCell": cell, "BatchedInput": x,
                "BatchedHidden": cell, "OrderedP0": r0}
    if lengths is None:
        lengths = _full_lengths(x)
    t_idx = torch.arange(T, device=x.device)[None, :]
    lens = lengths.reshape(-1, 1).long()
    if is_reverse:
        rev_idx = torch.where(t_idx < lens, lens - 1 - t_idx, t_idx)
        x = torch.take_along_dim(x, rev_idx[:, :, None], dim=1)
    valid = (t_idx < lens)[:, :, None]  # [N, T, 1]
    rs, cs = [], []
    for t in range(T):
        g = x[:, t] + r @ w
        i = g_act(g[:, :H] + w_ic * c)
        f = g_act(g[:, H:2 * H] + w_fc * c)
        c_new = f * c + i * cand_act(g[:, 2 * H:3 * H])
        o = g_act(g[:, 3 * H:] + w_oc * c_new)
        r_new = p_act((o * c_act(c_new)) @ proj_w)
        r = torch.where(valid[:, t], r_new, r)
        c = torch.where(valid[:, t], c_new, c)
        rs.append(r)
        cs.append(c)
    proj = torch.stack(rs, dim=1)
    cell = torch.stack(cs, dim=1)
    if is_reverse:
        proj = torch.take_along_dim(proj, rev_idx[:, :, None], dim=1)
        cell = torch.take_along_dim(cell, rev_idx[:, :, None], dim=1)
    return {"Projection": torch.where(valid, proj, torch.zeros_like(proj)),
            "Cell": torch.where(valid, cell, torch.zeros_like(cell)),
            "BatchedProjection": proj, "BatchedCell": cell,
            "BatchedInput": x, "BatchedHidden": cell, "OrderedP0": r0}
