"""NN ops (reference paddle/fluid/operators/{conv,conv_transpose,
batch_norm,layer_norm,softmax,pool,lrn,norm,sequence_softmax,
im2sequence}_op.cc, conv_mkldnn_op.cc): the ones the Transformer, the
image-classification and detection training, the fused ResNet inference
and the text paths run.
Layouts are NC(D)HW, as in the JAX package. The convolutions,
``batch_norm`` and the pools are what the JAX package leaves to XLA:
here cuDNN (``F.conv*``) and PyTorch's own CUDA ops on a card. Under
FLAGS['amp'] every convolution and ``conv2d_bn_relu`` take bfloat16
operands (``amp_operands``), as the JAX package's do."""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from ...kernels.conv_bn_relu import fused_conv_bn_relu
from ...kernels.layer_norm import fused_layer_norm
from .. import core
from ..registry import register_op
from .common import amp_operands, one, restored


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return [int(x) for x in v]
    return [int(v)] * n


def _conv_args(attrs, nd=2):
    return (_pair(attrs.get("strides", [1] * nd), nd),
            _pair(attrs.get("paddings", [0] * nd), nd),
            _pair(attrs.get("dilations", [1] * nd), nd),
            int(attrs.get("groups", 1) or 1))


def _conv_algorithms(x):
    """On a card, cuDNN's deterministic algorithms only: its default
    choice may take a backward algorithm that sums with atomics, and the
    same step from the same state must give bitwise the same result."""
    if x.is_cuda:
        return core.DETERMINISTIC_CUDNN.held()
    return contextlib.nullcontext()


def _conv_operands(ins, attrs, nd, depthwise):
    """Input and Filter through ``amp_operands``, the restore dtype and
    the (strides, paddings, dilations, groups) of the op; a depthwise
    conv takes one group a channel, as the JAX op does."""
    x, w, restore = amp_operands(one(ins, "Input"), one(ins, "Filter"))
    strides, paddings, dilations, groups = _conv_args(attrs, nd)
    if depthwise:
        groups = x.shape[1]
    return x, w, restore, (strides, paddings, dilations, groups)


def _conv_grad(nd, transposed=False, depthwise=False):
    """The grad emitter of a convolution op: dInput and dFilter in one
    ``convolution_backward`` call — what autograd would call — under the
    forward's algorithm choice. Under FLAGS['amp'] it runs on the
    forward's bfloat16 operands with the cotangent rounded to bfloat16,
    and dInput and dFilter come back float32: the JAX ``vjp`` through
    the casts of ``amp_operands``."""
    def grad(ctx, fwd_ins, fwd_outs, out_grads, attrs):
        x, w, restore, (strides, paddings, dilations, groups) = \
            _conv_operands(fwd_ins, attrs, nd, depthwise)
        dy = out_grads["Output"][0].to(x.dtype)
        with _conv_algorithms(x):
            dx, dw, _ = torch.ops.aten.convolution_backward(
                dy, x, w, None, strides, paddings, dilations, transposed,
                [0] * nd, groups, [True, True, False])
        return {"GRAD@Input": restored(dx, restore),
                "GRAD@Filter": restored(dw, restore)}
    return grad


def _conv(ins, attrs, nd, depthwise=False):
    """NC(D)HW input, O I/groups (D)HW filter, symmetric padding, as the
    JAX package's ``conv_general_dilated``: cuDNN on a card, in full
    float32 under the Executor's default ``matmul_precision``; under
    FLAGS['amp'] in bfloat16 (float32 accumulation), the output restored
    to float32."""
    x, w, restore, args = _conv_operands(ins, attrs, nd, depthwise)
    conv = F.conv2d if nd == 2 else F.conv3d
    with _conv_algorithms(x):
        out = conv(x, w, None, *args)
    return {"Output": restored(out, restore)}


@register_op("conv2d", grad=_conv_grad(2),
             ref="paddle/fluid/operators/conv_op.cc")
def conv2d(ctx, ins, attrs):
    """NCHW input, OIHW filter (``[F, C/groups, KH, KW]``); see
    ``_conv``."""
    return _conv(ins, attrs, 2)


def _input_filter_operands(ins, attrs):
    """conv2d_input_filter as one grouped convolution: the batch folded
    into the channels (``[1, N*C, H, W]``), the filter as that
    convolution's weight, and its (stride, padding, transposed, groups).
    ``trans=True`` keeps the JAX op's ``[F, C]`` filter (see
    ``conv2d_input_filter``): the transposed convolution's ``[in, out]``
    weight is its ``[C, F]`` transpose."""
    x, f = one(ins, "X"), one(ins, "Filter")
    n, c, h, w = x.shape
    nf, k = f.shape[1], f.shape[-1]
    trans = bool(attrs.get("trans", False))
    wg = (f.transpose(1, 2).reshape(n * c, nf, k, k) if trans
          else f.reshape(n * nf, c, k, k))
    return (x.reshape(1, n * c, h, w), wg, int(attrs.get("stride", 1)),
            int(attrs.get("padding", 0)), trans, n)


def _input_filter_grad(ctx, fwd_ins, fwd_outs, out_grads, attrs):
    """dX and dFilter in one ``convolution_backward`` call under the
    forward's algorithm choice (deterministic on a card), as the
    convolutions' grad emitter."""
    x, f = one(fwd_ins, "X"), one(fwd_ins, "Filter")
    xg, wg, s, p, trans, n = _input_filter_operands(fwd_ins, attrs)
    dy = out_grads["Out"][0]
    dy = dy.reshape(1, -1, dy.shape[2], dy.shape[3]).to(xg.dtype)
    with _conv_algorithms(xg):
        dx, dw, _ = torch.ops.aten.convolution_backward(
            dy, xg, wg, None, [s, s], [p, p], [1, 1], trans, [0, 0], n,
            [True, True, False])
    if trans:
        dw = dw.reshape(n, x.shape[1], f.shape[1], *f.shape[3:]) \
            .transpose(1, 2)
    return {"GRAD@X": dx.reshape(x.shape),
            "GRAD@Filter": dw.reshape(f.shape)}


@register_op("conv2d_input_filter", grad=_input_filter_grad,
             ref="legacy ConvOperator/conv_operator (proj_conf with a "
                 "computed filter layer, trainer/config_parser.py "
                 "parse_operator)")
def conv2d_input_filter(ctx, ins, attrs):
    """Convolve X ``[N, C, H, W]`` with a COMPUTED per-sample filter
    ``[N, F, C, k, k]`` (both inputs differentiable). The batch folds
    into the channels: one convolution with ``groups = N``, sample n's
    channels meeting only its own filter. ``trans=True`` is the adjoint,
    as the JAX op computes it: the filter stays ``[F, C]`` (a correlation
    with the spatially flipped filter over the stride-dilated input,
    padded ``k - 1 - p``), and the output side is
    ``(H - 1) * s - 2p + k``."""
    xg, wg, s, p, trans, n = _input_filter_operands(ins, attrs)
    with _conv_algorithms(xg):
        if trans:
            out = F.conv_transpose2d(xg, wg, None, s, p, 0, n)
        else:
            out = F.conv2d(xg, wg, None, s, p, 1, n)
    return {"Out": out.reshape(n, -1, out.shape[2], out.shape[3])}


@register_op("depthwise_conv2d", grad=_conv_grad(2, depthwise=True),
             ref="paddle/fluid/operators/conv_op.cc (depthwise)")
def depthwise_conv2d(ctx, ins, attrs):
    """conv2d with one group a channel, whatever ``groups`` says (the
    JAX op sets it from the input)."""
    return _conv(ins, attrs, 2, depthwise=True)


@register_op("conv3d", grad=_conv_grad(3),
             ref="paddle/fluid/operators/conv_op.cc")
def conv3d(ctx, ins, attrs):
    return _conv(ins, attrs, 3)


def _conv_transpose_nd(ins, attrs, nd):
    """conv{2,3}d_transpose: the adjoint of the convolution, filter
    ``[in_c, out_c/groups, *k]`` (the reference's layout, which is
    ``F.conv_transpose{2,3}d``'s own), output extent ``(in - 1) * s - 2p
    + d * (k - 1) + 1``. The JAX package builds it from a dilated
    correlation with the flipped filter; cuDNN computes the same
    function."""
    x, w, restore, (strides, paddings, dilations, groups) = \
        _conv_operands(ins, attrs, nd, False)
    conv = F.conv_transpose2d if nd == 2 else F.conv_transpose3d
    with _conv_algorithms(x):
        out = conv(x, w, None, strides, paddings, 0, groups, dilations)
    return {"Output": restored(out, restore)}


@register_op("conv2d_transpose", grad=_conv_grad(2, transposed=True),
             ref="paddle/fluid/operators/conv_transpose_op.cc")
def conv2d_transpose(ctx, ins, attrs):
    return _conv_transpose_nd(ins, attrs, 2)


@register_op("conv3d_transpose", grad=_conv_grad(3, transposed=True),
             ref="paddle/fluid/operators/conv_transpose_op.cc")
def conv3d_transpose(ctx, ins, attrs):
    return _conv_transpose_nd(ins, attrs, 3)


@register_op("batch_norm", no_grad=("Mean", "Variance"),
             ref="paddle/fluid/operators/batch_norm_op.cc")
def batch_norm(ctx, ins, attrs):
    """The JAX package's five outputs. Training: Y normalised by the
    batch's mean and biased variance; MeanOut/VarianceOut (the same
    variables as Mean/Variance) ``stat * momentum + batch * (1 -
    momentum)``; SavedMean the batch mean, SavedVariance the inverse std
    ``1/sqrt(var + eps)``. ``is_test``: Y from Mean/Variance, which pass
    through, and zero Saved*. ``F.batch_norm``'s own running update is
    not used: it weights the batch by ``momentum`` and keeps the
    unbiased variance. Only Y carries a gradient."""
    x = one(ins, "X")
    scale, bias = one(ins, "Scale"), one(ins, "Bias")
    mean, var = one(ins, "Mean"), one(ins, "Variance")
    eps = float(attrs.get("epsilon", 1e-5))
    momentum = float(attrs.get("momentum", 0.9))
    is_test = bool(attrs.get("is_test", False))
    # channels at dim 1: NCHW as it is, NHWC (any rank) as [rows, C]
    xc = x if str(attrs.get("data_layout", "NCHW")) == "NCHW" \
        else x.reshape(-1, x.shape[-1])
    if is_test:
        y, _, _ = torch.native_batch_norm(xc, scale, bias, mean, var, False,
                                          0.0, eps)
        return {"Y": y.reshape(x.shape), "MeanOut": mean,
                "VarianceOut": var, "SavedMean": torch.zeros_like(mean),
                "SavedVariance": torch.zeros_like(var)}
    y, batch_mean, inv_std = torch.native_batch_norm(
        xc, scale, bias, None, None, True, 0.0, eps)
    batch_mean, inv_std = batch_mean.detach(), inv_std.detach()
    batch_var = inv_std.pow(-2) - eps
    return {"Y": y.reshape(x.shape),
            "MeanOut": mean * momentum + batch_mean * (1.0 - momentum),
            "VarianceOut": var * momentum + batch_var * (1.0 - momentum),
            "SavedMean": batch_mean, "SavedVariance": inv_std}


@register_op("layer_norm", ref="paddle/fluid/operators/layer_norm_op.cc")
def layer_norm(ctx, ins, attrs):
    """Through the K1 router on every device: the hand-written kernel on
    a card, its plain version on the CPU. Mean and Variance are [rows]
    over the leading dims, the variance rebuilt from the kernel's rstd.

    This is the JAX package's kernel branch, its Pallas ``_ln_kernel``
    (``paddle_tpu/fluid/ops/pallas_kernels/layer_norm.py:16-24``), which
    the JAX op takes single-device when kernels are enabled
    (``paddle_tpu/fluid/ops/nn_ops.py:296-302``): on float32 the jnp
    branch computes the same function. On bfloat16 X, Scale and Bias it
    does not: the port widens to float32, normalizes, rounds Y once to
    bfloat16 and returns float32 Mean and Variance; the jnp branch the
    JAX op takes at its default flags off a TPU (``:304-318``) computes
    in bfloat16 and returns bfloat16 Y, Mean and Variance, a third of Y
    a bfloat16 step or so apart and less accurate against float64
    (``tests/test_torch_bf16_routes.py``).

    Under a ParallelExecutor mesh the kernel runs through ``local_map``
    on the row shards (``mesh_ops.layer_norm``): X keeps its batch
    sharding, Scale and Bias are replicated."""
    from ...parallel.api import current_mesh
    from . import mesh_ops

    x, scale, bias = one(ins, "X"), one(ins, "Scale"), one(ins, "Bias")
    eps = float(attrs.get("epsilon", 1e-5))
    begin = int(attrs.get("begin_norm_axis", 1))
    mesh = current_mesh()
    if mesh_ops.mesh_operands(mesh, x, scale, bias):
        y, mean, var = mesh_ops.layer_norm(mesh, x, scale, bias, eps, begin)
    else:
        y, mean, var = fused_layer_norm(x, scale, bias, eps=eps,
                                        begin_norm_axis=begin)
    return {"Y": y, "Mean": mean, "Variance": var}


@register_op("conv2d_bn_relu",
             ref="paddle/fluid/operators/conv_mkldnn_op.cc (the "
                 "alternate-kernel axis) + inference conv+bn fuse passes")
def conv2d_bn_relu(ctx, ins, attrs):
    """Fused conv + folded-bn affine + relu (the ResNet inference hot
    chain). Scale/Shift are the per-output-channel folded statistics
    (``kernels.conv_bn_relu.fold_bn``). Through the K5 router on every
    device: the hand-written kernel on a card, its plain version on the
    CPU — the function the JAX package computes with its Pallas kernel
    under ``use_pallas_kernels=True`` and with XLA's conv otherwise.
    There is no routing flag.

    Under FLAGS['amp'] X and Filter go to bfloat16 (``amp_operands``)
    and K5's bfloat16 form runs: the product accumulates in float32, the
    float32 Scale/Shift affine and the relu apply to the accumulator, and
    the output rounds once to bfloat16, then is restored to float32. That
    is the JAX package's Pallas branch (``use_pallas_kernels=True``,
    ``paddle_tpu/fluid/ops/nn_ops.py:69-80``, ``_gemm_epilogue_kernel``
    at ``paddle_tpu/fluid/ops/pallas_kernels/conv_bn_relu.py:49-54``).
    Its XLA branch, which the JAX op takes at its default flags
    (``nn_ops.py:82-94``), rounds the convolution's output to bfloat16
    before the affine instead: a different function (half the outputs
    apart by under a bfloat16 ulp of the max, as accurate against
    float64; ``tests/test_torch_bf16_routes.py``) that the port does not
    compute.

    Under a ParallelExecutor mesh the kernel runs through ``local_map``
    on the batch shards of X (``mesh_ops.conv_bn_relu``), Filter, Scale
    and Shift replicated."""
    from ...parallel.api import current_mesh
    from . import mesh_ops

    x, w, restore = amp_operands(one(ins, "X"), one(ins, "Filter"))
    scale, shift = one(ins, "Scale"), one(ins, "Shift")
    stride = int(attrs.get("stride", 1))
    padding = int(attrs.get("padding", 0))
    relu = bool(attrs.get("relu", True))
    mesh = current_mesh()
    if mesh_ops.mesh_operands(mesh, x, w, scale, shift):
        out = mesh_ops.conv_bn_relu(mesh, x, w, scale, shift, stride,
                                    padding, relu)
    else:
        out = fused_conv_bn_relu(x, w, scale, shift, stride=stride,
                                 padding=padding, relu=relu)
    return {"Out": restored(out, restore)}


def _ceil_extra(dim, k, s, p):
    """Extra hi-side padding so the window count matches ceil mode
    (reference pool_op.cc PoolOutputSize with ceil_mode: one more output
    when stride doesn't divide; the extra region is implicit padding).
    Clamp: the last window must START inside input+left-padding — a window
    living entirely in padding is dropped (torch clamps identically),
    otherwise max pools emit -inf and exclusive avgs divide 0/0."""
    span = dim + 2 * p - k
    ceil_out = -(-span // s) + 1
    if (ceil_out - 1) * s >= dim + p:
        ceil_out -= 1
    return max((ceil_out - 1) * s + k - (dim + 2 * p), 0)


def _pool_nd(x, pooling_type, ksize, strides, paddings, global_pooling,
             exclusive, ceil_mode=False):
    """The JAX package's ``_pool_nd`` over the spatial dims of x [N, C,
    *spatial] (two or three): max pooling pads with -inf, average
    pooling sums the window and divides by the count of real cells
    (``exclusive``) or by the window size. The padding is explicit, so
    any padding works (``F.max_pool*d`` refuses more than half the
    window)."""
    nd = x.ndim - 2
    if global_pooling:
        ksize = list(x.shape[2:])
        paddings = [0] * nd
        strides = [1] * nd
    extra = [_ceil_extra(x.shape[2 + i], ksize[i], strides[i], paddings[i])
             if ceil_mode else 0 for i in range(nd)]
    # F.pad lists the last dim first: (w lo, w hi, h lo, h hi, ...)
    pad = []
    for i in reversed(range(nd)):
        pad += [paddings[i], paddings[i] + extra[i]]
    if pooling_type == "max":
        low = (-math.inf if x.is_floating_point()
               else torch.iinfo(x.dtype).min)
        max_pool = F.max_pool2d if nd == 2 else F.max_pool3d
        return max_pool(F.pad(x, pad, value=low), ksize, strides)
    avg_pool = F.avg_pool2d if nd == 2 else F.avg_pool3d

    def window_sum(t):
        return avg_pool(F.pad(t, pad), ksize, strides, divisor_override=1)

    s = window_sum(x)
    if exclusive:
        return s / window_sum(torch.ones_like(x[:1, :1]))
    return s / float(math.prod(ksize))


@register_op("pool2d", ref="paddle/fluid/operators/pool_op.cc")
def pool2d(ctx, ins, attrs):
    out = _pool_nd(
        one(ins, "X"),
        str(attrs.get("pooling_type", "max")),
        _pair(attrs.get("ksize", [2, 2])),
        _pair(attrs.get("strides", [1, 1])),
        _pair(attrs.get("paddings", [0, 0])),
        bool(attrs.get("global_pooling", False)),
        bool(attrs.get("exclusive", True)),
        ceil_mode=bool(attrs.get("ceil_mode", False)),
    )
    return {"Out": out}


@register_op("softmax", ref="paddle/fluid/operators/softmax_op.cc")
def softmax(ctx, ins, attrs):
    return {"Out": torch.softmax(one(ins, "X"), dim=-1)}


@register_op("sequence_softmax", no_grad=("Lengths",),
             ref="paddle/fluid/operators/sequence_softmax_op.cc")
def sequence_softmax(ctx, ins, attrs):
    """Softmax within each sequence over the time axis; padded positions get
    zero probability (the reference softmaxes per LoD segment)."""
    x = one(ins, "X")
    lengths = one(ins, "Lengths")
    if lengths is None:
        return {"Out": torch.softmax(x, dim=1 if x.ndim > 1 else 0)}
    valid = (torch.arange(x.shape[1], device=x.device)[None, :]
             < lengths[:, None])
    valid = valid.reshape(tuple(valid.shape) + (1,) * (x.ndim - 2))
    out = torch.softmax(x.masked_fill(~valid, float("-inf")), dim=1)
    return {"Out": torch.where(valid, out, torch.zeros_like(out))}


@register_op("lrn", ref="paddle/fluid/operators/lrn_op.cc")
def lrn(ctx, ins, attrs):
    """Local response norm across channels, as the JAX op: Out = X /
    MidOut^beta, MidOut = k + alpha * (the sum of x^2 over n channels,
    the window padded (n // 2, n - 1 - n // 2) so an even n keeps the
    channel count). ``alpha`` is not divided by ``n``, which
    ``F.local_response_norm`` does. The op's default ``k`` is 2.0; the
    layer passes 1.0."""
    x = one(ins, "X")
    n = int(attrs.get("n", 5))
    k = float(attrs.get("k", 2.0))
    alpha = float(attrs.get("alpha", 1e-4))
    beta = float(attrs.get("beta", 0.75))
    half = n // 2
    sq = F.pad(torch.square(x), (0, 0, 0, 0, half, n - 1 - half))
    acc = F.avg_pool3d(sq[:, None], (n, 1, 1), 1, divisor_override=1)[:, 0]
    mid = k + alpha * acc
    return {"Out": x / torch.pow(mid, beta), "MidOut": mid}


@register_op("l2_normalize", ref="paddle/fluid/operators/norm_op.cc")
def l2_normalize(ctx, ins, attrs):
    """X over its L2 norm along ``axis``, the norm held at ``epsilon``
    from below by ``torch.maximum`` (a tie splits the gradient, as
    ``jnp.maximum``'s does)."""
    x = one(ins, "X")
    axis = int(attrs.get("axis", -1))
    eps = float(attrs.get("epsilon", 1e-10))
    norm = torch.sqrt(torch.sum(torch.square(x), dim=axis, keepdim=True))
    return {"Out": x / torch.maximum(norm, norm.new_tensor(eps)),
            "Norm": norm}


@register_op("im2sequence", ref="paddle/fluid/operators/im2sequence_op.cc")
def im2sequence(ctx, ins, attrs):
    """Image patches as a sequence: X [N, C, H, W] -> [N * oh * ow,
    C * kh * kw], each row one patch (channel-major, as the JAX op's
    ``conv_general_dilated_patches``); paddings [up, left, down, right]."""
    x = one(ins, "X")
    kernels = _pair(attrs.get("kernels", [1, 1]))
    strides = _pair(attrs.get("strides", [1, 1]))
    up, left, down, right = [int(p) for p in
                             attrs.get("paddings", [0, 0, 0, 0])]
    x = F.pad(x, (left, right, up, down))
    patches = F.unfold(x, kernels, stride=strides)  # [N, C*kh*kw, L]
    return {"Out": patches.transpose(1, 2).reshape(-1, patches.shape[1])}

