"""Vision-file ops (reference paddle/fluid/operators/{maxout,norm,unpool,
spp,roi_pool,row_conv,conv_shift,bilinear_tensor_product,lstmp,
pool_with_index,bilinear_interp,sampling_id}_op.* and
pool_op.cc's 3-D path): the counterpart of
``paddle_tpu/fluid/ops/vision_ops.py``. The pools, resizes and ROI pool
are dense NC(D)HW with static shapes, batched over every image and ROI
(no host loop); the index outputs come from PyTorch's max pools with
their indices, mapped back to the unpadded positions. As in the JAX
package's ``lstm``, ``lstmp``'s recurrence is a Python loop over the
time steps (the JAX op's ``lax.scan``) and its gradient is autograd's;
on ``meta`` (shape inference) it returns the output shapes without
stepping."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..registry import register_op
from .common import one
from .nn_ops import _pool_nd
from .sequence_ops import _ACTS, _full_lengths, _mask


@register_op("maxout", ref="paddle/fluid/operators/maxout_op.cc")
def maxout(ctx, ins, attrs):
    """The max over each run of ``groups`` channels. ``amax`` splits the
    gradient evenly among tied entries, as ``jnp.max``'s does."""
    x = one(ins, "X")  # [N, C, H, W]
    groups = int(attrs["groups"])
    n, c, h, w = x.shape
    return {"Out": x.reshape(n, c // groups, groups, h, w).amax(dim=2)}


def _tuple_n(v, n):
    v = list(v) if isinstance(v, (list, tuple)) else [v]
    if len(v) == 1:
        v = v * n
    return [int(a) for a in v]


def _pool_args(x, attrs, nd):
    """(ksize, strides, paddings) of a pool op; a global pool's window is
    the whole map."""
    if bool(attrs.get("global_pooling", False)):
        return list(x.shape[2:]), [1] * nd, [0] * nd
    return (_tuple_n(attrs.get("ksize", [2] * nd), nd),
            _tuple_n(attrs.get("strides", [1] * nd), nd),
            _tuple_n(attrs.get("paddings", [0] * nd), nd))


@register_op("pool3d", ref="paddle/fluid/operators/pool_op.cc")
def pool3d(ctx, ins, attrs):
    x = one(ins, "X")  # [N, C, D, H, W]
    return {"Out": _pool_nd(
        x, str(attrs.get("pooling_type", "max")),
        _tuple_n(attrs.get("ksize", [2, 2, 2]), 3),
        _tuple_n(attrs.get("strides", [1, 1, 1]), 3),
        _tuple_n(attrs.get("paddings", [0, 0, 0]), 3),
        bool(attrs.get("global_pooling", False)),
        bool(attrs.get("exclusive", True)),
        ceil_mode=bool(attrs.get("ceil_mode", False)))}


def _max_pool_with_index(x, ksize, strides, paddings):
    """(pooled, Mask) over the spatial dims of x [N, C, *spatial]: Mask
    holds the flat position of each window's max over the UNPADDED
    spatial dims (row-major), int32, and -1 for a window that lies wholly
    in padding (its value -inf). The first position of a tie wins, as in
    the JAX op's reduce. The padding is explicit (-inf), and the
    positions pad with -1, so PyTorch's indices into the padded map
    translate back by one gather."""
    nd = x.ndim - 2
    pad = []
    for i in reversed(range(nd)):
        pad += [paddings[i], paddings[i]]
    spatial = x.shape[2:]
    pos = torch.arange(math.prod(spatial), dtype=torch.int32,
                       device=x.device).reshape(spatial)
    pos = F.pad(pos[None, None], pad, value=-1).reshape(-1)
    max_pool = F.max_pool2d if nd == 2 else F.max_pool3d
    vals, idx = max_pool(F.pad(x, pad, value=-math.inf), ksize, strides,
                         return_indices=True)
    return vals, pos[idx]


@register_op("max_pool2d_with_index",
             ref="paddle/fluid/operators/pool_with_index_op.cc")
def max_pool2d_with_index(ctx, ins, attrs):
    x = one(ins, "X")
    vals, mask = _max_pool_with_index(x, *_pool_args(x, attrs, 2))
    return {"Out": vals, "Mask": mask}


@register_op("max_pool3d_with_index",
             ref="paddle/fluid/operators/pool_with_index_op.cc")
def max_pool3d_with_index(ctx, ins, attrs):
    """Mask holds flat D*H*W positions."""
    x = one(ins, "X")  # [N, C, D, H, W]
    vals, mask = _max_pool_with_index(x, *_pool_args(x, attrs, 3))
    return {"Out": vals, "Mask": mask}


@register_op("unpool", no_grad=("Indices",),
             ref="paddle/fluid/operators/unpool_op.cc")
def unpool(ctx, ins, attrs):
    """Max-unpool: each pooled value written (``set``) at its flat H*W
    position, the positions clipped into the map as the JAX op clips
    them; where two land on one cell, either may win, in both
    packages."""
    x = one(ins, "X")                 # [N, C, h, w]
    indices = one(ins, "Indices")     # [N, C, h, w] flat H*W positions
    ksize = _tuple_n(attrs.get("ksize", [2, 2]), 2)
    strides = _tuple_n(attrs.get("strides", ksize), 2)
    paddings = _tuple_n(attrs.get("paddings", [0, 0]), 2)
    n, c, h, w = x.shape
    H = (h - 1) * strides[0] - 2 * paddings[0] + ksize[0]
    W = (w - 1) * strides[1] - 2 * paddings[1] + ksize[1]
    flat_i = indices.reshape(n, c, h * w).long().clamp(0, H * W - 1)
    out = x.new_zeros((n, c, H * W)).scatter(2, flat_i,
                                              x.reshape(n, c, h * w))
    return {"Out": out.reshape(n, c, H, W)}


@register_op("spp", ref="paddle/fluid/operators/spp_op.cc")
def spp(ctx, ins, attrs):
    """Spatial pyramid pooling: the flattened pools at 1x1 .. 2^(L-1)
    square bins, concatenated; window ceil(H / bins), padding
    (k * bins - H + 1) // 2, which can exceed half the window on a small
    map (``_pool_nd`` pads explicitly), averages inclusive."""
    x = one(ins, "X")
    levels = int(attrs.get("pyramid_height", 3))
    ptype = str(attrs.get("pooling_type", "max"))
    n, _, h, w = x.shape
    outs = []
    for level in range(levels):
        bins = 2 ** level
        kh, kw = -(-h // bins), -(-w // bins)
        ph, pw = (kh * bins - h + 1) // 2, (kw * bins - w + 1) // 2
        pooled = _pool_nd(x, ptype, [kh, kw], [kh, kw], [ph, pw], False,
                          False)
        outs.append(pooled.reshape(n, -1))
    return {"Out": torch.cat(outs, dim=1)}


def _bin_masks(lo_roi, scale, extent, pooled):
    """[R, pooled, extent] membership of each map row (column) in each
    ROI's bins: ROI edges rounded half to even, the bin size (edge + 1
    cells, at least 1) / pooled in float32, bin b covering [lo +
    floor(b * size), lo + ceil((b + 1) * size)) clipped to the map."""
    lo = torch.round(lo_roi[0] * scale).to(torch.int32)
    hi = torch.round(lo_roi[1] * scale).to(torch.int32)
    size = torch.clamp(hi - lo + 1, min=1).to(torch.float32)
    # a tensor divisor: PyTorch's CUDA division by a host scalar
    # multiplies by its reciprocal, which can move a bin edge
    size = size / size.new_tensor(float(pooled))
    b = torch.arange(pooled, dtype=torch.float32,
                     device=lo.device)[None, :]
    start = (lo[:, None] + torch.floor(b * size[:, None])).to(torch.int32)
    end = (lo[:, None] + torch.ceil((b + 1) * size[:, None])).to(torch.int32)
    cells = torch.arange(extent, device=lo.device)[None, None, :]
    return ((cells >= start.clamp(0, extent)[:, :, None])
            & (cells < end.clamp(0, extent)[:, :, None]))


@register_op("roi_pool", no_grad=("ROIs",),
             ref="paddle/fluid/operators/roi_pool_op.cc")
def roi_pool(ctx, ins, attrs):
    """Max-pool each ROI [R, 5] (batch index, x1, y1, x2, y2 in input
    scale) into a pooled_height x pooled_width grid, all ROIs at once
    with bin masks; an empty bin gives 0. The bin max is taken over the
    columns (a loop over the pooled width) and then the rows: the same
    maximum as the JAX op's one masked max over both, and with ``amax``
    the same gradient but where a bin's maximum is tied across rows.
    Argmax is all zero, int32, as in the JAX op."""
    x = one(ins, "X")  # [N, C, H, W]
    rois = one(ins, "ROIs")
    pooled_h = int(attrs.get("pooled_height", 1))
    pooled_w = int(attrs.get("pooled_width", 1))
    scale = float(attrs.get("spatial_scale", 1.0))
    _, c, h, w = x.shape
    r = rois.shape[0]
    argmax = torch.zeros((r, c, pooled_h, pooled_w), dtype=torch.int32,
                         device=x.device)
    if x.device.type == "meta":
        return {"Out": x.new_empty((r, c, pooled_h, pooled_w)),
                "Argmax": argmax}
    h_in = _bin_masks((rois[:, 2], rois[:, 4]), scale, h, pooled_h)
    w_in = _bin_masks((rois[:, 1], rois[:, 3]), scale, w, pooled_w)
    fmap = x[rois[:, 0].to(torch.int64)]  # [R, C, H, W]
    neg = torch.tensor(-math.inf, dtype=x.dtype, device=x.device)
    cols = torch.stack(
        [torch.where(w_in[:, j, None, None, :], fmap, neg).amax(dim=3)
         for j in range(pooled_w)], dim=3)             # [R, C, H, pw]
    out = torch.where(h_in[:, None, :, :, None], cols[:, :, None],
                      neg).amax(dim=3)                 # [R, C, ph, pw]
    return {"Out": torch.where(torch.isfinite(out), out,
                               torch.zeros_like(out)),
            "Argmax": argmax}


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


def _align_corners_axis(x, out_n, axis):
    """One spatial axis resampled with the reference's align-corners
    ratio (in - 1) / (out - 1) in float32: corners map to corners; a side
    of 1 reads index 0."""
    in_n = x.shape[axis]
    if out_n == in_n:
        return x
    if out_n == 1 or in_n == 1:
        return x.index_select(axis, torch.zeros(out_n, dtype=torch.int64,
                                                device=x.device))
    src = torch.arange(out_n, dtype=torch.float32,
                       device=x.device) * ((in_n - 1) / (out_n - 1))
    lo = torch.floor(src).to(torch.int64)
    hi = torch.clamp(lo + 1, max=in_n - 1)
    shape = [1] * x.ndim
    shape[axis] = out_n
    frac = (src - lo).to(x.dtype).reshape(shape)
    return (x.index_select(axis, lo) * (1 - frac)
            + x.index_select(axis, hi) * frac)


@register_op("bilinear_interp",
             ref="paddle/fluid/operators/bilinear_interp_op.cc")
def bilinear_interp(ctx, ins, attrs):
    """Bilinear resize of NCHW maps to (out_h, out_w), align-corners
    (bilinear_interp_op.h: ratio (in - 1) / (out - 1)), as two separable
    lerps."""
    x = one(ins, "X")
    out = _align_corners_axis(x, int(attrs["out_h"]), 2)
    return {"Out": _align_corners_axis(out, int(attrs["out_w"]), 3)}


@register_op("nearest_interp",
             ref="paddle/fluid/operators/math/unpooling.cc (legacy upsample)")
def nearest_interp(ctx, ins, attrs):
    """Nearest-neighbour resize of NCHW maps to (out_h, out_w): source
    row i * in // out in integers (``F.interpolate`` multiplies by a
    float scale and can pick the next row at an exact boundary)."""
    x = one(ins, "X")
    out_h, out_w = int(attrs["out_h"]), int(attrs["out_w"])
    h, w = x.shape[2], x.shape[3]
    hi = torch.arange(out_h, device=x.device) * h // out_h
    wi = torch.arange(out_w, device=x.device) * w // out_w
    return {"Out": x.index_select(2, hi).index_select(3, wi)}


@register_op("norm", ref="paddle/fluid/operators/norm_op.cc")
def norm(ctx, ins, attrs):
    """Cross-channel L2 normalisation with a learned scale a channel
    (SSD's conv4_3 norm layer): X [N, C, H, W], Scale [C]."""
    x, scale = one(ins, "X"), one(ins, "Scale")
    eps = float(attrs.get("epsilon", 1e-10))
    l2 = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True) + eps)
    return {"Out": x / l2 * scale.reshape(1, -1, 1, 1)}


@register_op("conv_shift", ref="paddle/fluid/operators/conv_shift_op.cc")
def conv_shift(ctx, ins, attrs):
    """Circular 1-D correlation (the Neural Turing Machine's shift): X
    [B, M], Y [B, N] with N odd and N <= M;
    out[b, i] = sum_j x[b, (i + j - N // 2) mod M] y[b, j]."""
    x, y = one(ins, "X"), one(ins, "Y")
    m, n = x.shape[1], y.shape[1]
    idx = (torch.arange(m, device=x.device)[:, None]
           + torch.arange(n, device=x.device)[None, :] - n // 2) % m
    return {"Out": torch.einsum("bmn,bn->bm", x[:, idx], y)}


@register_op("bilinear_tensor_product",
             ref="paddle/fluid/operators/bilinear_tensor_product_op.cc")
def bilinear_tensor_product(ctx, ins, attrs):
    """out[:, k] = x W_k y^T + bias: X [B, M], Y [B, N], Weight
    [K, M, N], Bias [1, K]."""
    x, y, w = one(ins, "X"), one(ins, "Y"), one(ins, "Weight")
    bias = one(ins, "Bias")
    out = torch.einsum("bm,kmn,bn->bk", x, w, y)
    if bias is not None:
        out = out + bias.reshape(1, -1)
    return {"Out": out}


@register_op("sampling_id", needs_rng=True,
             ref="paddle/fluid/operators/sampling_id_op.cc")
def sampling_id(ctx, ins, attrs):
    """One int64 index a row, drawn from the row's distribution X (rows
    need not sum to 1): the Gumbel-max draw of ``jax.random.categorical``
    over log(max(X, 1e-30)), from ``ctx.rng``."""
    x = one(ins, "X")
    logits = torch.log(torch.clamp(x.to(torch.float32), min=1e-30))
    u = torch.rand(logits.shape, generator=ctx.rng(attrs),
                   device=ctx.device)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    return {"Out": torch.argmax(logits + gumbel, dim=-1)}
