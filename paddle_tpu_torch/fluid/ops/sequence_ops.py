"""Sequence ops on the padded + lengths representation — the counterpart
of ``paddle_tpu/fluid/ops/sequence_ops.py`` (``_mask``,
``_context_windows``, ``sequence_pool``, ``sequence_conv``,
``sequence_expand``, ``sequence_reverse``, ``sequence_slice``,
``sequence_concat``, ``sequence_reshape``, ``sequence_erase``, ``lstm``,
``gru``, ``lstm_unit``, ``gru_unit``, ``lod_rank_table``,
``reorder_lod_tensor_by_rank``, ``lod_reset``, ``context_project``),
computed with torch ops.

A "sequence batch" is a padded dense tensor [N, T, ...] plus a lengths
vector [N] (int32) carried in the companion variable `<name>@LEN` (see
layers/sequence.py); masking replaces the reference's LoD offset tables
(lod_tensor.h:44-110). The JAX package computes ``lstm`` and ``gru`` with
``jax.lax.scan``; here the same recurrences are Python loops over the time
steps, and the generic autograd grad differentiates them. A recurrent op
run for shape inference (on ``meta``) returns its output shapes without
stepping.

Reference op files: sequence_pool_op.cc, sequence_conv_op.cc,
sequence_expand_op.cc, sequence_slice_op.cc, sequence_concat_op.cc,
lstm_op.cc (+math/lstm_compute), gru_op.cc (+math/gru_compute),
lod_rank_table_op.cc, reorder_lod_tensor_by_rank_op.cc, lod_reset_op.cc.
"""
from __future__ import annotations

import numpy as np
import torch

from ..registry import register_op
from .common import one


def _mask(lengths, T, dtype=torch.float32):
    # [N, T] 1.0 where t < len
    return (torch.arange(T, device=lengths.device)[None, :]
            < lengths[:, None]).to(dtype)


def _full_lengths(x):
    """[N] int32 lengths of T for a batch with no lengths companion."""
    return torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                      device=x.device)


def _context_windows(x, ctx_len, ctx_start, lengths):
    """[N, T, D] -> [N, T, ctx_len*D]: concat each timestep with its
    neighbours, zero past the tensor AND past each sequence's real length
    (reference math/context_project.*). The one implementation under both
    sequence_conv and the standalone context_project op."""
    T = x.shape[1]
    if lengths is not None:
        x = x * _mask(lengths, T, x.dtype)[:, :, None]
    t = torch.arange(T, device=x.device)
    cols = []
    for k in range(ctx_len):
        off = ctx_start + k
        valid = ((t + off >= 0) & (t + off < T)).to(x.dtype)[None, :, None]
        cols.append(torch.roll(x, -off, dims=1) * valid)
    return torch.cat(cols, dim=-1)


@register_op("sequence_pool", no_grad=("Lengths",),
             ref="paddle/fluid/operators/sequence_pool_op.cc")
def sequence_pool(ctx, ins, attrs):
    x = one(ins, "X")  # [N, T, D]
    lengths = one(ins, "Lengths")
    pool_type = str(attrs.get("pooltype", "AVERAGE")).upper()
    N, T = x.shape[0], x.shape[1]
    if lengths is None:
        lengths = torch.full((N,), T, dtype=torch.int32, device=x.device)
    m = _mask(lengths, T, x.dtype)[:, :, None]
    safe_len = torch.clamp(lengths, min=1).to(x.dtype)[:, None]
    if pool_type == "AVERAGE":
        out = torch.sum(x * m, dim=1) / safe_len
    elif pool_type == "SUM":
        out = torch.sum(x * m, dim=1)
    elif pool_type == "SQRT":
        out = torch.sum(x * m, dim=1) / torch.sqrt(safe_len)
    elif pool_type == "MAX":
        # amax spreads a tie's gradient evenly, as jnp.max's vjp does
        # (torch.max(dim) gives it all to one index)
        neg = torch.finfo(x.dtype).min
        out = torch.amax(torch.where(m > 0, x, torch.full_like(x, neg)),
                         dim=1)
    elif pool_type == "LAST":
        idx = torch.clamp(lengths - 1, min=0).long()
        out = torch.take_along_dim(x, idx[:, None, None], dim=1)[:, 0]
    elif pool_type == "FIRST":
        out = x[:, 0]
    else:
        raise ValueError(f"unknown pooltype {pool_type}")
    return {"Out": out,
            "MaxIndex": torch.zeros((N,), dtype=torch.int32,
                                    device=x.device)}


@register_op("sequence_conv", no_grad=("Lengths",),
             ref="paddle/fluid/operators/sequence_conv_op.cc")
def sequence_conv(ctx, ins, attrs):
    """Context-window projection (reference math/context_project.*): for each
    timestep, concat [t+start, t+start+len) rows (zero-padded at edges) and
    multiply by the filter [ctx_len*D, out_dim]."""
    x = one(ins, "X")  # [N, T, D]
    ctx_len = int(attrs.get("contextLength", 3))
    ctx_start = int(attrs.get("contextStart", -((ctx_len - 1) // 2)))
    ctx_mat = _context_windows(x, ctx_len, ctx_start, one(ins, "Lengths"))
    return {"Out": ctx_mat @ one(ins, "Filter")}


@register_op("sequence_expand", no_grad=("Y", "YLengths"),
             ref="paddle/fluid/operators/sequence_expand_op.cc")
def sequence_expand(ctx, ins, attrs):
    """Broadcast per-sequence rows of X across the timesteps of Y
    (padded-form equivalent of the reference's LoD expand)."""
    x = one(ins, "X")  # [N, D] or [N, 1, D]
    if x.ndim == 2:
        x = x[:, None, :]
    return {"Out": x.expand(x.shape[0], one(ins, "Y").shape[1], x.shape[2])}


@register_op("sequence_reverse", no_grad=("Lengths",),
             ref="paddle/fluid/operators/sequence_reverse_op.h")
def sequence_reverse(ctx, ins, attrs):
    """Reverse each sequence's VALID prefix in place: out[n, t] =
    x[n, len_n-1-t] for t < len_n; padding rows stay where they are (so
    the lengths companion still describes the output)."""
    x = one(ins, "X")
    lengths = one(ins, "Lengths")
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    if lengths is None:
        src = (T - 1 - t).expand(x.shape[0], T)
    else:
        l = lengths.reshape(-1, 1).long()
        src = torch.where(t < l, l - 1 - t, t)
    src = src.reshape(tuple(src.shape) + (1,) * (x.ndim - 2))
    return {"Out": torch.take_along_dim(x, src, dim=1)}


@register_op("sequence_slice", no_grad=("Offset", "Length"),
             ref="paddle/fluid/operators/sequence_slice_op.cc")
def sequence_slice(ctx, ins, attrs):
    """Offset/Length may carry k windows per sequence ([N] or [N, k]);
    the kept region is the union of the windows (the reference's k-window
    form emitted a nested sequence; the masked model keeps [N, T, ...])."""
    x = one(ins, "X")
    N, T = x.shape[0], x.shape[1]
    off = one(ins, "Offset").reshape(N, -1)[:, None, :]  # [N, 1, k]
    ln = one(ins, "Length").reshape(N, -1)[:, None, :]
    t = torch.arange(T, device=x.device)[None, :, None]  # [1, T, 1]
    keep = ((t >= off) & (t < off + ln)).any(-1)  # [N, T]
    keep = keep.reshape(tuple(keep.shape) + (1,) * (x.ndim - 2))
    return {"Out": x * keep.to(x.dtype)}


@register_op("sequence_concat", no_grad=("Lengths",),
             ref="paddle/fluid/operators/sequence_concat_op.cc")
def sequence_concat(ctx, ins, attrs):
    """Concatenate along time per-sample: each input's valid rows are packed
    behind the previous input's valid rows (not behind its padding). Rows
    past a length go to an overflow slot at T_out that is cut away (the
    JAX op's ``mode="drop"`` scatter)."""
    xs = [v for v in ins.get("X", []) if v is not None]
    lens = ins.get("Lengths", [])
    if not lens:
        return {"Out": torch.cat(xs, dim=1)}
    N = xs[0].shape[0]
    T_out = sum(x.shape[1] for x in xs)
    dev = xs[0].device
    out = xs[0].new_zeros((N, T_out + 1) + tuple(xs[0].shape[2:]))
    offset = torch.zeros((N, 1), dtype=torch.long, device=dev)
    for i, x in enumerate(xs):
        T_i = x.shape[1]
        li = lens[i] if i < len(lens) and lens[i] is not None else \
            _full_lengths(x)
        li = li.reshape(-1, 1).long()
        t = torch.arange(T_i, device=dev)[None, :]
        dest = torch.where(t < li, offset + t, T_out)
        rows = torch.arange(N, device=dev)[:, None].expand(N, T_i)
        out = out.index_put((rows, dest), x)
        offset = offset + li
    return {"Out": out[:, :T_out]}


@register_op("sequence_reshape",
             ref="paddle/fluid/operators/sequence_reshape_op.cc")
def sequence_reshape(ctx, ins, attrs):
    x = one(ins, "X")
    return {"Out": x.reshape(x.shape[0], -1, int(attrs["new_dim"]))}


@register_op("sequence_erase", no_grad=("X",),
             ref="paddle/fluid/operators/sequence_erase_op.cc")
def sequence_erase(ctx, ins, attrs):
    """Mask out listed tokens (int sequences): erased positions are replaced
    by 0 and do not shrink the padded tensor (static shapes)."""
    x = one(ins, "X")
    tokens = torch.as_tensor(list(attrs.get("tokens", [])), dtype=x.dtype,
                             device=x.device)
    erase = (x[..., None] == tokens).any(-1)
    return {"Out": torch.where(erase, torch.zeros_like(x), x)}


_ACTS = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu,
         "identity": lambda v: v}


@register_op("lstm", no_grad=("Lengths",),
             ref="paddle/fluid/operators/lstm_op.cc, math/lstm_compute.*")
def lstm(ctx, ins, attrs):
    """Fused LSTM over time. Input is the pre-projected gate activations
    [N, T, 4H] (the reference's dynamic_lstm also takes the x-projection
    as input, layers/nn.py:277); Weight [H, 4H] is the recurrent
    projection; Bias [4H] or [7H] with peepholes. Gate order i, f, c, o
    (reference lstm_op.cc). As in the JAX op, ``candidate_activation``
    applies to the cell gate and ``cell_activation`` to c before the
    output gate. Past a sequence's length h and c stay frozen, and
    Hidden / Cell are zero there."""
    x = one(ins, "Input")
    w = one(ins, "Weight")
    bias = one(ins, "Bias")
    lengths = one(ins, "Lengths")
    h0, c0 = one(ins, "H0"), one(ins, "C0")
    use_peepholes = bool(attrs.get("use_peepholes", False))
    is_reverse = bool(attrs.get("is_reverse", False))
    g_act = _ACTS[attrs.get("gate_activation", "sigmoid")]
    c_act = _ACTS[attrs.get("candidate_activation", "tanh")]
    d_act = _ACTS[attrs.get("cell_activation", "tanh")]

    N, T, H4 = x.shape
    H = H4 // 4
    if bias is not None:
        x = x + bias[:4 * H][None, None, :]
        if use_peepholes:
            w_ic, w_fc, w_oc = (bias[4 * H:5 * H], bias[5 * H:6 * H],
                                bias[6 * H:7 * H])
    if x.device.type == "meta":  # shape inference: no need to step
        cell = x.new_empty((N, T, H))
        return {"Hidden": x.new_empty((N, T, H)), "Cell": cell,
                "BatchGate": x, "BatchCellPreAct": cell}
    h = torch.zeros((N, H), dtype=x.dtype, device=x.device) \
        if h0 is None else h0
    c = torch.zeros((N, H), dtype=x.dtype, device=x.device) \
        if c0 is None else c0
    if lengths is None:
        lengths = torch.full((N,), T, dtype=torch.int32, device=x.device)
    valid = (torch.arange(T, device=x.device)[:, None]
             < lengths[None, :])[:, :, None]  # [T, N, 1]

    hs, cs = [None] * T, [None] * T
    for t in (range(T - 1, -1, -1) if is_reverse else range(T)):
        gates = x[:, t] + h @ w  # [N, 4H]
        gi, gf, gc, go = torch.chunk(gates, 4, dim=1)
        if use_peepholes:
            gi = gi + c * w_ic[None, :]
            gf = gf + c * w_fc[None, :]
        i = g_act(gi)
        f = g_act(gf)
        c_new = f * c + i * c_act(gc)
        if use_peepholes:
            go = go + c_new * w_oc[None, :]
        o = g_act(go)
        h_new = o * d_act(c_new)
        h = torch.where(valid[t], h_new, h)
        c = torch.where(valid[t], c_new, c)
        hs[t], cs[t] = h, c
    hidden = torch.stack(hs, dim=1)
    cell = torch.stack(cs, dim=1)
    mask = _mask(lengths, T, x.dtype)[:, :, None]
    return {"Hidden": hidden * mask, "Cell": cell * mask,
            "BatchGate": x, "BatchCellPreAct": cell}


@register_op("gru", no_grad=("Lengths",),
             ref="paddle/fluid/operators/gru_op.cc, math/gru_compute.*")
def gru(ctx, ins, attrs):
    """Fused GRU: Input [N, T, 3H] pre-projected, Weight [H, 3H] packs
    [H, 2H] (update|reset) + [H, H] (candidate) like the reference gru
    layout; h = (1-u)*h_prev + u*candidate (reference gru_compute).
    ``is_reverse`` walks the PADDED time axis backwards, as the JAX op's
    flip of the whole axis does; past a sequence's length h stays frozen
    and Hidden is zero there."""
    x = one(ins, "Input")
    w = one(ins, "Weight")
    bias = one(ins, "Bias")
    lengths = one(ins, "Lengths")
    h0 = one(ins, "H0")
    is_reverse = bool(attrs.get("is_reverse", False))
    g_act = _ACTS[attrs.get("gate_activation", "sigmoid")]
    c_act = _ACTS[attrs.get("activation", "tanh")]

    N, T, H3 = x.shape
    H = H3 // 3
    if bias is not None:
        x = x + bias[None, None, :]
    if x.device.type == "meta":
        hidden = x.new_empty((N, T, H))
        return {"Hidden": hidden, "BatchGate": x,
                "BatchResetHiddenPrev": hidden, "BatchHidden": hidden}
    h = x.new_zeros((N, H)) if h0 is None else h0
    if lengths is None:
        lengths = _full_lengths(x)
    valid = (torch.arange(T, device=x.device)[:, None]
             < lengths[None, :])[:, :, None]  # [T, N, 1]
    w_ur, w_c = w[:, :2 * H], w[:, 2 * H:]
    hs = [None] * T
    for t in (range(T - 1, -1, -1) if is_reverse else range(T)):
        xt = x[:, t]
        ur = h @ w_ur
        u = g_act(xt[:, :H] + ur[:, :H])
        r = g_act(xt[:, H:2 * H] + ur[:, H:])
        c = c_act(xt[:, 2 * H:] + (r * h) @ w_c)
        h = torch.where(valid[t], (1.0 - u) * h + u * c, h)
        hs[t] = h
    hidden = torch.stack(hs, dim=1)
    mask = _mask(lengths, T, x.dtype)[:, :, None]
    return {"Hidden": hidden * mask, "BatchGate": x,
            "BatchResetHiddenPrev": hidden, "BatchHidden": hidden}


@register_op("lstm_unit", ref="paddle/fluid/operators/lstm_unit_op.cc")
def lstm_unit(ctx, ins, attrs):
    """One LSTM cell step on pre-projected gates X [N, 4H] (i, f, c, o)."""
    gi, gf, gc, go = torch.chunk(one(ins, "X"), 4, dim=1)
    forget_bias = float(attrs.get("forget_bias", 0.0))
    c = (torch.sigmoid(gf + forget_bias) * one(ins, "C_prev")
         + torch.sigmoid(gi) * torch.tanh(gc))
    return {"C": c, "H": torch.sigmoid(go) * torch.tanh(c)}


# gru_unit names its activations by integer code (reference gru_unit_op.h)
_ACT_CODES = {0: _ACTS["identity"], 1: torch.sigmoid, 2: torch.tanh,
              3: torch.relu}


@register_op("gru_unit", ref="paddle/fluid/operators/gru_unit_op.cc")
def gru_unit(ctx, ins, attrs):
    """One GRU cell step: Input [N, 3H] (the x-projection), HiddenPrev
    [N, H], Weight [H, 3H] packed as in ``gru``, Bias [1, 3H]."""
    x = one(ins, "Input")
    h_prev = one(ins, "HiddenPrev")
    w = one(ins, "Weight")
    bias = one(ins, "Bias")
    g_act = _ACT_CODES.get(int(attrs.get("gate_activation", 1)),
                           torch.sigmoid)
    c_act = _ACT_CODES.get(int(attrs.get("activation", 2)), torch.tanh)
    H = h_prev.shape[1]
    if bias is not None:
        x = x + bias.reshape(1, -1)
    ur = h_prev @ w[:, :2 * H]
    u = g_act(x[:, :H] + ur[:, :H])
    r = g_act(x[:, H:2 * H] + ur[:, H:])
    c = c_act(x[:, 2 * H:] + (r * h_prev) @ w[:, 2 * H:])
    return {"Hidden": (1.0 - u) * h_prev + u * c, "Gate": x,
            "ResetHiddenPrev": r * h_prev}


@register_op("lod_rank_table", no_grad=("X", "Lengths"),
             ref="paddle/fluid/operators/lod_rank_table_op.cc")
def lod_rank_table(ctx, ins, attrs):
    """The permutation that sorts the batch by DESCENDING length, ties in
    batch order (the reference's LoDRankTable; the JAX package's
    ``argsort(-lengths, stable=True)``), int32."""
    lengths = one(ins, "Lengths").to(torch.int32)
    return {"Out": torch.argsort(-lengths, stable=True).to(torch.int32)}


@register_op("reorder_lod_tensor_by_rank", no_grad=("RankTable",),
             ref="paddle/fluid/operators/reorder_lod_tensor_by_rank_op.cc")
def reorder_lod_tensor_by_rank(ctx, ins, attrs):
    x, rank = one(ins, "X"), one(ins, "RankTable")
    return {"Out": x.index_select(0, rank.long())}


@register_op("lod_reset", no_grad=("XLengths", "Y", "YLengths"),
             ref="paddle/fluid/operators/lod_reset_op.cc")
def lod_reset(ctx, ins, attrs):
    """Repartition a token stream under new sequence boundaries.

    The reference reinterprets a LoD tensor's flat rows under a new offset
    vector (from attr `target_lod` or input Y's lod). Padded+lengths
    equivalent: X's valid tokens are flattened in order, then re-chunked
    into the target partition and re-padded. X may be dense ([total, ...]
    lod_level 0, no XLengths) or padded+lengths; the target comes from the
    static `target_lod` offsets or from Y (padded shape) + YLengths.

    As in the JAX op, a dense X must hold exactly the target's last offset
    in rows; for a padded X the token count is a run-time value, and a
    target that claims more tokens than X holds reads zero-filled rows."""
    x = one(ins, "X")
    in_lens = one(ins, "XLengths")
    y = one(ins, "Y")
    y_lens = one(ins, "YLengths")
    target = attrs.get("target_lod")
    dev = x.device

    # 1) flat token stream (bound = total slots; valid tokens lead)
    if in_lens is None:
        flat = x if x.ndim >= 2 else x[:, None]
        cap = flat.shape[0]
    else:
        N, T = x.shape[0], x.shape[1]
        cap = N * T
        item = tuple(x.shape[2:])
        lens = in_lens.reshape(-1, 1).long()
        starts = torch.cumsum(lens, dim=0) - lens
        t = torch.arange(T, device=dev)[None, :]
        dest = torch.where(t < lens, starts + t, cap)
        flat = x.new_zeros((cap + 1,) + item).index_put(
            (dest.reshape(-1),), x.reshape((cap,) + item))[:cap]

    # 2) target partition
    if target is not None:
        offsets = np.asarray(target, dtype=np.int64)
        lens_np = np.diff(offsets)
        if in_lens is None and int(offsets[-1]) != int(flat.shape[0]):
            # the reference enforces last offset == row count
            # (lod_reset_op.cc InferShape)
            raise ValueError(
                f"lod_reset: target_lod ends at {int(offsets[-1])} but X "
                f"has {int(flat.shape[0])} rows")
        new_lens = torch.as_tensor(lens_np, dtype=torch.int32, device=dev)
        out_n, out_t = int(lens_np.shape[0]), int(lens_np.max(initial=1))
    elif y_lens is not None:
        new_lens = y_lens.to(torch.int32)
        out_n = y_lens.shape[0]
        out_t = y.shape[1] if y is not None and y.ndim >= 2 else x.shape[1]
    else:
        raise ValueError("lod_reset needs target_lod or Y")

    # 3) gather into the new padding
    nl = new_lens.reshape(-1, 1).long()
    u = torch.arange(out_t, device=dev)[None, :]
    src = torch.clamp(torch.cumsum(nl, dim=0) - nl + u, 0, cap - 1)
    gathered = flat[src.reshape(-1)].reshape(
        (out_n, out_t) + tuple(flat.shape[1:]))
    mask = (u < nl).reshape((out_n, out_t) + (1,) * (gathered.ndim - 2))
    return {"Out": gathered * mask.to(gathered.dtype),
            "OutLengths": new_lens}


@register_op("context_project", no_grad=("Lengths",),
             ref="paddle/fluid/operators/math/context_project.h")
def context_project(ctx, ins, attrs):
    """Concat each timestep with its neighbours over the time axis
    (reference math/context_project, the engine under sequence_conv and
    the legacy context_projection): [N, T, D] -> [N, T, ctx_len*D], zero
    padding past the ends."""
    ctx_len = int(attrs.get("context_length", 3))
    # same default start as sequence_conv (one reference, one convention)
    start = int(attrs.get("context_start", -((ctx_len - 1) // 2)))
    return {"Out": _context_windows(one(ins, "X"), ctx_len, start,
                                    one(ins, "Lengths"))}
