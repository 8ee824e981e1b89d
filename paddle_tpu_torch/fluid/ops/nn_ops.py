"""NN ops (reference paddle/fluid/operators/{conv,batch_norm,layer_norm,
softmax,pool,sequence_softmax,im2sequence}_op.cc, conv_mkldnn_op.cc): the
ones the Transformer, the image-classification training, the fused ResNet
inference and the text paths run.
Layouts are NCHW, as in the JAX package. ``conv2d``, ``batch_norm`` and
``pool2d`` are what the JAX package leaves to XLA: here cuDNN
(``F.conv2d``) and PyTorch's own CUDA ops on a card. Under
FLAGS['amp'] ``conv2d`` and ``conv2d_bn_relu`` take bfloat16 operands
(``amp_operands``), as the JAX package's do."""
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


def _conv_args(attrs):
    return (_pair(attrs.get("strides", [1, 1])),
            _pair(attrs.get("paddings", [0, 0])),
            _pair(attrs.get("dilations", [1, 1])),
            int(attrs.get("groups", 1) or 1))


def _conv_algorithms(x):
    """On a card, cuDNN's deterministic algorithms only: its default
    choice may take a backward algorithm that sums with atomics, and the
    same step from the same state must give bitwise the same result."""
    if x.is_cuda:
        return core.DETERMINISTIC_CUDNN.held()
    return contextlib.nullcontext()


def _conv2d_grad(ctx, fwd_ins, fwd_outs, out_grads, attrs):
    """dInput and dFilter in one ``convolution_backward`` call — what
    autograd would call — under the forward's algorithm choice. Under
    FLAGS['amp'] it runs on the forward's bfloat16 operands with the
    cotangent rounded to bfloat16, and dInput and dFilter come back
    float32: the JAX ``vjp`` through the casts of ``amp_operands``."""
    x, w, restore = amp_operands(fwd_ins["Input"][0], fwd_ins["Filter"][0])
    dy = out_grads["Output"][0].to(x.dtype)
    strides, paddings, dilations, groups = _conv_args(attrs)
    with _conv_algorithms(x):
        dx, dw, _ = torch.ops.aten.convolution_backward(
            dy, x, w, None, strides, paddings, dilations, False, [0, 0],
            groups, [True, True, False])
    return {"GRAD@Input": restored(dx, restore),
            "GRAD@Filter": restored(dw, restore)}


@register_op("conv2d", grad=_conv2d_grad,
             ref="paddle/fluid/operators/conv_op.cc")
def conv2d(ctx, ins, attrs):
    """NCHW input, OIHW filter (``[F, C/groups, KH, KW]``), symmetric
    padding, as the JAX package's ``conv_general_dilated``. cuDNN on a
    card, in full float32 under the Executor's default
    ``matmul_precision``; under FLAGS['amp'] in bfloat16 (float32
    accumulation), the output restored to float32."""
    x, w, restore = amp_operands(one(ins, "Input"), one(ins, "Filter"))
    strides, paddings, dilations, groups = _conv_args(attrs)
    with _conv_algorithms(x):
        out = F.conv2d(x, w, None, strides, paddings, dilations, groups)
    return {"Output": restored(out, restore)}


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
    (``tests/test_torch_bf16_routes.py``)."""
    y, mean, var = fused_layer_norm(
        one(ins, "X"), one(ins, "Scale"), one(ins, "Bias"),
        eps=float(attrs.get("epsilon", 1e-5)),
        begin_norm_axis=int(attrs.get("begin_norm_axis", 1)))
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
    compute."""
    x, w, restore = amp_operands(one(ins, "X"), one(ins, "Filter"))
    out = fused_conv_bn_relu(
        x, w, one(ins, "Scale"), one(ins, "Shift"),
        stride=int(attrs.get("stride", 1)),
        padding=int(attrs.get("padding", 0)),
        relu=bool(attrs.get("relu", True)))
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


def _pool2d(x, pooling_type, ksize, strides, paddings, global_pooling,
            exclusive, ceil_mode=False):
    """The JAX package's ``_pool_nd`` for two spatial dims: max pooling
    pads with -inf, average pooling sums the window and divides by the
    count of real cells (``exclusive``) or by the window size."""
    if global_pooling:
        ksize = list(x.shape[2:4])
        paddings = [0, 0]
        strides = [1, 1]
    extra = [_ceil_extra(x.shape[2 + i], ksize[i], strides[i], paddings[i])
             if ceil_mode else 0 for i in range(2)]
    # F.pad lists the last dim first: (w lo, w hi, h lo, h hi)
    pad = (paddings[1], paddings[1] + extra[1],
           paddings[0], paddings[0] + extra[0])
    if pooling_type == "max":
        low = (-math.inf if x.is_floating_point()
               else torch.iinfo(x.dtype).min)
        return F.max_pool2d(F.pad(x, pad, value=low), ksize, strides)

    def window_sum(t):
        return F.avg_pool2d(F.pad(t, pad), ksize, strides,
                            divisor_override=1)

    s = window_sum(x)
    if exclusive:
        return s / window_sum(torch.ones_like(x[:1, :1]))
    return s / float(ksize[0] * ksize[1])


@register_op("pool2d", ref="paddle/fluid/operators/pool_op.cc")
def pool2d(ctx, ins, attrs):
    out = _pool2d(
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

