"""Tensor-manipulation ops (reference paddle/fluid/operators/{reshape,
transpose,concat,split,cast,fill_constant,assign,assign_value,
lookup_table,one_hot,top_k,arg_max,expand,gather,scatter,multiplex,
split_ids,split_selected_rows,...}_op.*) — the counterpart of
``paddle_tpu/fluid/ops/tensor_ops.py``."""
from __future__ import annotations

import numpy as np
import torch

from ..registry import register_op
from ..selected_rows import SelectedRows, is_selected_rows
from .common import dtype_of, many, one


@register_op("reshape", ref="paddle/fluid/operators/reshape_op.cc")
def reshape(ctx, ins, attrs):
    x = one(ins, "X")
    shape = [int(s) for s in attrs["shape"]]
    # reference semantics: 0 means "copy this dim from input"
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return {"Out": x.reshape(shape)}


@register_op("transpose", ref="paddle/fluid/operators/transpose_op.cc")
def transpose(ctx, ins, attrs):
    return {"Out": one(ins, "X").permute([int(a) for a in attrs["axis"]])}


@register_op("concat", ref="paddle/fluid/operators/concat_op.cc")
def concat(ctx, ins, attrs):
    return {"Out": torch.cat(many(ins, "X"), dim=int(attrs.get("axis", 0)))}


@register_op("split", ref="paddle/fluid/operators/split_op.cc")
def split(ctx, ins, attrs):
    x = one(ins, "X")
    axis = int(attrs.get("axis", 0))
    sections = [int(s) for s in attrs.get("sections") or []]
    if not sections:
        num = int(attrs.get("num", 0))
        if x.shape[axis] % num:
            raise ValueError(f"split: dim {axis} of extent {x.shape[axis]} "
                             f"does not divide into {num} equal parts")
        sections = [x.shape[axis] // num] * num
    return {"Out": list(torch.split(x, sections, dim=axis))}


@register_op("cast", ref="paddle/fluid/operators/cast_op.cc")
def cast(ctx, ins, attrs):
    """X in ``out_dtype`` (to nearest even into bfloat16). Its gradient
    is the generic one: autograd through ``Tensor.to`` casts the output's
    gradient back to X's dtype, as the JAX package's ``astype`` VJP."""
    return {"Out": one(ins, "X").to(dtype_of(attrs, "out_dtype"))}


@register_op("assign", ref="paddle/fluid/operators/assign_op.cc")
def assign(ctx, ins, attrs):
    # values are never written in place, so the alias is a copy
    return {"Out": one(ins, "X")}


def _literal(ctx, values, attrs):
    """The attr's flat ``values`` as a tensor of the attrs' shape and
    dtype on the op's device."""
    dtype = dtype_of(attrs)
    shape = [int(s) for s in attrs["shape"]]
    if ctx.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    vals = np.asarray(values, dtype=np.float64 if dtype.is_floating_point
                      else np.int64).reshape(shape)
    return torch.as_tensor(vals).to(device=ctx.device, dtype=dtype)


@register_op("assign_value", ref="paddle/fluid/operators/assign_value_op.cc")
def assign_value(ctx, ins, attrs):
    return {"Out": _literal(ctx, attrs["values"], attrs)}


@register_op("fill_constant", ref="paddle/fluid/operators/fill_constant_op.cc")
def fill_constant(ctx, ins, attrs):
    shape = [int(s) for s in attrs["shape"]]
    return {"Out": torch.full(shape, float(attrs.get("value", 0.0)),
                              dtype=dtype_of(attrs), device=ctx.device)}


@register_op("fill_constant_batch_size_like",
             ref="paddle/fluid/operators/fill_constant_batch_size_like_op.cc")
def fill_constant_batch_size_like(ctx, ins, attrs):
    inp = one(ins, "Input")
    shape = [int(s) for s in attrs["shape"]]
    shape[int(attrs.get("output_dim_idx", 0))] = \
        inp.shape[int(attrs.get("input_dim_idx", 0))]
    return {"Out": torch.full(shape, float(attrs.get("value", 0.0)),
                              dtype=dtype_of(attrs), device=ctx.device)}


@register_op("fill_zeros_like",
             ref="paddle/fluid/operators/fill_zeros_like_op.cc")
def fill_zeros_like(ctx, ins, attrs):
    return {"Out": torch.zeros_like(one(ins, "X"))}


@register_op("fill", ref="paddle/fluid/operators/fill_op.cc")
def fill(ctx, ins, attrs):
    """Out holds the literal values of the ``value`` attr."""
    return {"Out": _literal(ctx, attrs["value"], attrs)}


@register_op("shape", ref="paddle/fluid/operators/shape_op.cc")
def shape_op(ctx, ins, attrs):
    return {"Out": torch.tensor(list(one(ins, "Input").shape),
                                dtype=torch.int64, device=ctx.device)}


@register_op("increment", ref="paddle/fluid/operators/increment_op.cc")
def increment(ctx, ins, attrs):
    """X + step in X's dtype, out of place (the layer names X as the
    output, so the new value takes X's name)."""
    x = one(ins, "X")
    step = float(attrs.get("step", 1.0))
    return {"Out": x + (step if x.is_floating_point() else int(step))}


@register_op("expand", ref="paddle/fluid/operators/expand_op.cc")
def expand(ctx, ins, attrs):
    return {"Out": one(ins, "X").tile([int(t) for t in attrs["expand_times"]])}


@register_op("pad", ref="paddle/fluid/operators/pad_op.cc")
def pad(ctx, ins, attrs):
    """``paddings`` [before_0, after_0, before_1, ...] per dim, filled
    with ``pad_value``."""
    x = one(ins, "X")
    p = [int(v) for v in attrs["paddings"]]
    pairs = []
    for d in reversed(range(x.ndim)):  # F.pad lists the last dim first
        pairs += [p[2 * d], p[2 * d + 1]]
    return {"Out": torch.nn.functional.pad(
        x, pairs, value=float(attrs.get("pad_value", 0.0)))}


@register_op("crop", ref="paddle/fluid/operators/crop_op.cc")
def crop(ctx, ins, attrs):
    """The ``shape`` window at ``offsets``; a -1 in ``shape`` keeps the
    rest of that dim. Offsets clamp so the window fits, as
    ``jax.lax.dynamic_slice``'s do."""
    x = one(ins, "X")
    offsets = [int(v) for v in attrs.get("offsets", [0] * x.ndim)]
    shape = [x.shape[d] - offsets[d] if int(v) == -1 else int(v)
             for d, v in enumerate(attrs["shape"])]
    for d, (o, n) in enumerate(zip(offsets, shape)):
        x = x.narrow(d, min(max(o, 0), x.shape[d] - n), n)
    return {"Out": x}


@register_op("sequence_mask", no_grad=("X", "MaxLenRef"),
             ref="paddle/fluid/operators/sequence_ops (era: created for "
                 "padding)")
def sequence_mask(ctx, ins, attrs):
    """Y[i, t] = t < X[i], over ``maxlen`` columns or the time extent of
    the padded MaxLenRef [N, T, ...]."""
    x = one(ins, "X")
    maxlen = int(attrs.get("maxlen", -1))
    if maxlen < 0 and ins.get("MaxLenRef"):
        maxlen = ins["MaxLenRef"][0].shape[1]
    if maxlen < 0:
        raise ValueError("sequence_mask requires a static `maxlen` attr (or "
                         "a MaxLenRef input)")
    rng = torch.arange(maxlen, device=x.device)
    return {"Y": (rng[None, :] < x[:, None]).to(
        dtype_of(attrs, "out_dtype", "int64"))}


@register_op("batch_gather", no_grad=("Index",),
             ref="paddle/fluid/operators (beam parent gather; "
                 "take_along_axis)")
def batch_gather(ctx, ins, attrs):
    """X [B, K, ...], Index [B, K'] -> Out [B, K', ...]: a gather along
    axis 1 per batch row (beam search's parent states)."""
    x, idx = one(ins, "X"), one(ins, "Index")
    idx = idx.long().reshape(tuple(idx.shape) + (1,) * (x.ndim - 2))
    return {"Out": torch.take_along_dim(
        x, idx.expand(tuple(idx.shape[:2]) + tuple(x.shape[2:])), dim=1)}


@register_op("max_sequence_len", no_grad=("Lengths",),
             ref="paddle/fluid/operators/max_sequence_len_op.cc")
def max_sequence_len(ctx, ins, attrs):
    """The batch's longest length, int32 [1], from the lengths companion
    (the JAX package's op; the reference reads its LoDRankTable)."""
    lengths = one(ins, "Lengths")
    if lengths is None:
        raise ValueError(
            "max_sequence_len needs the Lengths input — build it with "
            "layers.max_sequence_len(x) on a sequence var")
    return {"Out": lengths.max().reshape(1).to(torch.int32)}


@register_op("lod_tensor_to_array", no_grad=("RankTable",),
             ref="paddle/fluid/operators/lod_tensor_to_array_op.cc")
def lod_tensor_to_array(ctx, ins, attrs):
    """[N, T, ...] -> the time-major array [T, N, ...]."""
    return {"Out": one(ins, "X").transpose(0, 1)}


@register_op("array_to_lod_tensor", no_grad=("RankTable",),
             ref="paddle/fluid/operators/array_to_lod_tensor_op.cc")
def array_to_lod_tensor(ctx, ins, attrs):
    """The inverse of lod_tensor_to_array: [T, N, ...] -> [N, T, ...]."""
    return {"Out": one(ins, "X").transpose(0, 1)}


def _print(x, attrs, phase):
    summarize = int(attrs.get("summarize", 20))
    head = x.detach().reshape(-1)
    n = head.numel() if summarize < 0 else min(summarize, head.numel())
    parts = [str(attrs.get("message") or ""), f"[{phase}]",
             f"shape={tuple(x.shape)} dtype={x.dtype}"]
    if x.is_floating_point():
        xf = x.detach().float()
        parts.append(f"min={xf.min().item()} max={xf.max().item()} "
                     f"mean={xf.mean().item()} "
                     f"nan={int(torch.isnan(xf).sum().item())}")
    parts.append(f"data[:{n}]={head[:n].tolist()}")
    print(" ".join(p for p in parts if p), flush=True)


def _print_grad(ctx, fwd_ins, fwd_outs, out_grads, attrs):
    g = out_grads["Out"][0]
    if g is not None and attrs.get("print_phase", "both") in ("backward",
                                                             "both"):
        _print(g, attrs, "backward")
    return {"GRAD@In": g}


@register_op("print", grad=_print_grad,
             ref="paddle/fluid/operators/print_op.cc")
def print_op(ctx, ins, attrs):
    """A tensor tap: In passes through unchanged, and each run prints its
    shape, dtype, statistics and first ``summarize`` values on the host
    (one device sync). The custom grad passes the gradient through, and
    prints it under print_phase 'backward' or 'both'."""
    x = one(ins, "In")
    if ctx.device.type != "meta" and \
            attrs.get("print_phase", "both") in ("forward", "both"):
        _print(x, attrs, "forward")
    return {"Out": x}


def _squeezed_ids(ids):
    if ids.ndim >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    return ids.long()


def _lookup_table_grad(ctx, fwd_ins, fwd_outs, out_grads, attrs):
    """Grad W. With ``is_sparse`` a SelectedRows of the batch's ids and
    their rows' output gradients (padding rows zeroed) that never builds
    the dense [V, D] gradient (reference lookup_table_grad's SelectedRows
    kernel; the optimizer ops apply it row by row). Dense: the rows'
    output gradients scatter-added into a zero table (``jnp.take``'s
    vjp)."""
    w, ids = fwd_ins["W"][0], fwd_ins["Ids"][0]
    dy = out_grads["Out"][0]
    if dy is None:
        return {}
    padding_idx = int(attrs.get("padding_idx", -1))
    flat_ids = _squeezed_ids(ids).reshape(-1)
    flat_dy = dy.reshape((flat_ids.shape[0],) + tuple(w.shape[1:])).to(w.dtype)
    if padding_idx != -1:
        flat_dy = torch.where((flat_ids == padding_idx)[:, None],
                              torch.zeros_like(flat_dy), flat_dy)
    if bool(attrs.get("is_sparse", False)):
        return {"GRAD@W": SelectedRows(flat_ids, flat_dy, w.shape[0]),
                "GRAD@Ids": None}
    # index_put_ with accumulate sorts the ids and sums each row in one
    # order; index_add_ adds with atomics on the card, so repeated ids
    # (every sequence's start token) changed the last bits from run to run
    dw = torch.zeros_like(w).index_put_((flat_ids,), flat_dy, accumulate=True)
    return {"GRAD@W": dw, "GRAD@Ids": None}


@register_op("lookup_table", no_grad=("Ids",), grad=_lookup_table_grad,
             ref="paddle/fluid/operators/lookup_table_op.cc")
def lookup_table(ctx, ins, attrs):
    w, ids = one(ins, "W"), one(ins, "Ids")
    padding_idx = int(attrs.get("padding_idx", -1))
    ids = _squeezed_ids(ids)
    out = w[ids]
    if padding_idx != -1:
        out = torch.where((ids == padding_idx)[..., None],
                          torch.zeros_like(out), out)
    return {"Out": out}


@register_op("top_k", ref="paddle/fluid/operators/top_k_op.cc")
def top_k(ctx, ins, attrs):
    """The k largest along the last dim, largest first, with int64
    indices. Ties: ``jax.lax.top_k`` puts the lower index first;
    ``torch.topk`` promises no order among equal values."""
    vals, idx = torch.topk(one(ins, "X"), int(attrs["k"]), dim=-1)
    return {"Out": vals, "Indices": idx}


@register_op("arg_max", no_grad=("X",),
             ref="paddle/fluid/operators/arg_minmax (era: argmax via top_k)")
def arg_max(ctx, ins, attrs):
    """int64 index of the largest value along ``axis``; a tie goes to the
    lowest index, as ``jnp.argmax``'s does."""
    return {"Out": torch.argmax(one(ins, "X"), dim=int(attrs.get("axis", 0)))}



@register_op("arg_min", no_grad=("X",),
             ref="paddle/fluid/operators/arg_minmax (era: argmin via top_k)")
def arg_min(ctx, ins, attrs):
    """int64 index of the smallest value along ``axis``; a tie goes to
    the lowest index, as ``jnp.argmin``'s does."""
    return {"Out": torch.argmin(one(ins, "X"), dim=int(attrs.get("axis", 0)))}


@register_op("one_hot", ref="paddle/fluid/operators/one_hot_op.cc")
def one_hot(ctx, ins, attrs):
    """float32 rows with a 1 at each id (a trailing ids dim of 1
    squeezed); an id outside [0, depth) gives a zero row, as
    ``jax.nn.one_hot``'s does."""
    x = _squeezed_ids(one(ins, "X"))
    depth = int(attrs["depth"])
    return {"Out": (x[..., None] == torch.arange(depth, device=x.device)
                    ).to(torch.float32)}


@register_op("gather", no_grad=("Index",),
             ref="paddle/fluid/operators/gather_op.cc")
def gather(ctx, ins, attrs):
    """The rows of X at Index (a trailing index dim of 1 squeezed)."""
    return {"Out": one(ins, "X")[_squeezed_ids(one(ins, "Index"))]}


@register_op("scatter", no_grad=("Ids",),
             ref="paddle/fluid/operators/scatter_op.cc")
def scatter(ctx, ins, attrs):
    """X with the rows at Ids overwritten by Updates (out of place). With
    a repeated id neither package says which update lands."""
    x, updates = one(ins, "X"), one(ins, "Updates")
    return {"Out": x.index_put((_squeezed_ids(one(ins, "Ids")),), updates)}


@register_op("multiplex", no_grad=("Ids",),
             ref="paddle/fluid/operators/multiplex_op.cc")
def multiplex(ctx, ins, attrs):
    """Row i of the output is row i of ``X[Ids[i]]``."""
    xs = torch.stack(many(ins, "X"), dim=0)
    ids = _squeezed_ids(one(ins, "Ids"))
    idx = ids.reshape((1, -1) + (1,) * (xs.ndim - 2)).expand(
        (1,) + tuple(xs.shape[1:]))
    return {"Out": torch.take_along_dim(xs, idx, dim=0)[0]}


@register_op("label_smooth", ref="paddle/fluid/operators/label_smooth_op.cc")
def label_smooth(ctx, ins, attrs):
    """``(1 - eps) * X + eps * PriorDist``, or ``eps / K`` over the last
    dim's K classes without a prior."""
    x = one(ins, "X")
    eps = float(attrs.get("epsilon", 0.0))
    dist = one(ins, "PriorDist")
    if dist is not None:
        return {"Out": (1 - eps) * x + eps * dist}
    return {"Out": (1 - eps) * x + eps / x.shape[-1]}


@register_op("is_empty", ref="paddle/fluid/operators/is_empty_op.cc")
def is_empty(ctx, ins, attrs):
    """A bool scalar: X holds no element."""
    return {"Out": torch.tensor(one(ins, "X").numel() == 0,
                                device=ctx.device)}


@register_op("reverse", ref="paddle/fluid/operators (reverse capability)")
def reverse(ctx, ins, attrs):
    axes = attrs.get("axis", [0])
    if not isinstance(axes, (list, tuple)):
        axes = [axes]
    return {"Out": torch.flip(one(ins, "X"), [int(a) for a in axes])}


@register_op("split_ids", no_grad=("Ids",),
             ref="paddle/fluid/operators/split_ids_op.cc")
def split_ids(ctx, ins, attrs):
    """Ids to ``num_shards`` shards by ``id % num_shards`` (the pserver
    sharding rule of a distributed embedding). Static shapes, as in the
    JAX package: each shard keeps the input's extent, -1 where the id
    belongs to another shard."""
    ids = one(ins, "Ids").reshape(-1)
    n = int(attrs["num_shards"])
    return {"Out": [torch.where(ids % n == s, ids, torch.full_like(ids, -1))
                    for s in range(n)]}


@register_op("split_selected_rows", no_grad=("X",),
             ref="paddle/fluid/operators/split_selected_rows_op.cc")
def split_selected_rows(ctx, ins, attrs):
    """A SelectedRows split by contiguous row sections
    (``height_sections``), as the reference ships a sparse gradient to
    the pservers that own each slice of the table. Static shapes: every
    output keeps the input's N entries, a row outside its section reads
    -1 with a zero value."""
    x = one(ins, "X")
    sections = [int(s) for s in attrs["height_sections"]]
    if not is_selected_rows(x):
        raise ValueError("split_selected_rows expects a SelectedRows input")
    outs = []
    start = 0
    for sec in sections:
        in_sec = (x.rows >= start) & (x.rows < start + sec)
        rows = torch.where(in_sec, x.rows - start, torch.full_like(x.rows, -1))
        vals = torch.where(
            in_sec.reshape((-1,) + (1,) * (x.value.ndim - 1)), x.value,
            torch.zeros_like(x.value))
        outs.append(SelectedRows(rows, vals, sec))
        start += sec
    return {"Out": outs}
