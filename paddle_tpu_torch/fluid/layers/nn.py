"""NN layer functions (reference python/paddle/fluid/layers/nn.py — fc:83,
embedding:218, conv2d:1150, batch_norm:1508, pool2d:1455,
layer_norm:1597, dropout:876, softmax_with_cross_entropy:3165, ...): the
ones the Transformer, fit_a_line, the image-classification training
(ResNet, LeNet, VGG), fused ResNet inference and the control-flow
programs (DynamicRNN LSTM, machine translation, seq2seq) and the text
chapters (``lstm_unit``, ``cos_sim``, ``edit_distance``, ``chunk_eval``,
``warpctc``, ``row_conv``, ``im2sequence``) and the image and detection
programs (``conv2d_transpose``, ``lrn``, ``pad``, ``l2_normalize``,
``smooth_l1``, ``split``) call, and the rest of Fluid's layers over the
ops the port has (``nce``, ``hsigmoid``, ``one_hot``, ``label_smooth``,
``sigmoid_cross_entropy_with_logits``, ``multiplex``, ``prelu``,
``dot_product_attention``, ``lookup_table``) and ``moe``, copied from
``paddle_tpu/fluid/layers/nn.py``."""
from __future__ import annotations

import numpy as np

from ..initializer import ConstantInitializer, NormalInitializer
from ..layer_helper import LayerHelper

__all__ = [
    "fc", "embedding", "conv2d", "conv2d_bn_relu", "pool2d", "batch_norm",
    "layer_norm", "dropout", "softmax", "accuracy", "topk",
    "softmax_with_cross_entropy", "square_error_cost", "mean", "mul",
    "matmul", "reshape", "transpose", "ring_attention", "elementwise_add",
    "elementwise_sub", "elementwise_mul", "elementwise_div",
    "elementwise_max", "elementwise_min", "elementwise_pow",
    "cross_entropy", "reduce_sum", "reduce_mean", "reduce_max",
    "reduce_min", "reduce_prod", "scale", "expand", "clip", "clip_by_norm",
    "autoincreased_step_counter", "im2sequence", "cos_sim", "edit_distance",
    "chunk_eval", "warpctc", "row_conv", "lstm_unit", "conv2d_transpose",
    "lrn", "pad", "l2_normalize", "smooth_l1", "split", "one_hot",
    "lookup_table", "label_smooth", "sigmoid_cross_entropy_with_logits",
    "prelu", "hsigmoid", "dot_product_attention", "nce", "multiplex",
    "moe",
]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, is_test=False, name=None):
    """Fully-connected (reference layers/nn.py:83): mul per input + sum +
    bias + activation."""
    helper = LayerHelper(
        "fc", input=input, size=size, param_attr=param_attr,
        bias_attr=bias_attr, act=act, name=name,
    )
    dtype = (input[0] if isinstance(input, (list, tuple)) else input).dtype
    inputs = input if isinstance(input, (list, tuple)) else [input]
    param_attrs = helper.multiple_param_attr(len(inputs))

    mul_results = []
    for inp, attr in zip(inputs, param_attrs):
        input_shape = inp.shape
        param_shape = [
            int(np.prod(input_shape[num_flatten_dims:]))
        ] + [size]
        w = helper.create_parameter(attr, param_shape, dtype)
        tmp = helper.create_variable_for_type_inference(dtype)
        helper.append_op(
            type="mul",
            inputs={"X": [inp], "Y": [w]},
            outputs={"Out": [tmp]},
            attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1},
        )
        mul_results.append(tmp)

    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(dtype)
        helper.append_op(
            type="sum", inputs={"X": mul_results}, outputs={"Out": [pre_bias]}
        )
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    out = helper.append_activation(pre_act)
    if num_flatten_dims >= 2:
        # time axis survives the flatten -> still a sequence
        from .sequence import _propagate_lengths

        _propagate_lengths(inputs[0], out)
    return out


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """reference layers/nn.py:218 → lookup_table op."""
    helper = LayerHelper("embedding", param_attr=param_attr)
    w = helper.create_parameter(helper.param_attr, size, dtype)
    tmp = helper.create_variable_for_type_inference(dtype)
    padding_idx = -1 if padding_idx is None else (
        padding_idx if padding_idx >= 0 else size[0] + padding_idx
    )
    if input.shape is not None:
        s = list(input.shape)
        if s and s[-1] == 1:
            s = s[:-1]  # the op squeezes the trailing ids dim
        tmp.desc.shape = s + [size[1]]
    helper.append_op(
        type="lookup_table",
        inputs={"W": [w], "Ids": [input]},
        outputs={"Out": [tmp]},
        attrs={"is_sparse": is_sparse, "is_distributed": is_distributed,
               "padding_idx": padding_idx},
    )
    from .sequence import _propagate_lengths

    _propagate_lengths(input, tmp)
    return tmp


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           use_mkldnn=False, act=None, name=None):
    """reference layers/nn.py:1150. Filter layout [out_c, in_c/groups, kh, kw]."""
    helper = LayerHelper(
        "conv2d", param_attr=param_attr, bias_attr=bias_attr, act=act, name=name
    )
    dtype = input.dtype
    num_channels = input.shape[1]
    groups = groups or 1
    if num_channels % groups != 0:
        raise ValueError("num_channels must be divisible by groups")

    def _pair(v):
        return list(v) if isinstance(v, (list, tuple)) else [v, v]

    filter_size = _pair(filter_size)
    stride = _pair(stride)
    padding = _pair(padding)
    dilation = _pair(dilation)

    filter_shape = [num_filters, num_channels // groups] + filter_size
    std = (2.0 / (filter_size[0] * filter_size[1] * num_channels)) ** 0.5
    w = helper.create_parameter(
        helper.param_attr, filter_shape, dtype,
        default_initializer=NormalInitializer(0.0, std),
    )
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="conv2d",
        inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={
            "strides": stride, "paddings": padding, "dilations": dilation,
            "groups": groups, "use_cudnn": use_cudnn,
        },
    )
    pre_act = _append_channel_bias(helper, pre_bias)
    return helper.append_activation(pre_act)


def conv2d_bn_relu(input, num_filters, filter_size, stride=1, padding=0,
                   param_attr=None, scale_attr=None, shift_attr=None,
                   relu=True, name=None):
    """Fused conv + per-channel affine + relu — the inference-bn fold of
    the ResNet hot chain (reference conv+bn fuse passes; alternate-kernel
    axis conv_mkldnn_op.cc). Scale/Shift are learnable parameters here;
    to run a trained conv+batch_norm pair through the fused op, assign
    them the folded statistics (kernels.conv_bn_relu.fold_bn)."""
    helper = LayerHelper("conv2d_bn_relu", param_attr=param_attr, name=name)
    dtype = input.dtype
    num_channels = int(input.shape[1])
    kh, kw = (filter_size, filter_size) if isinstance(filter_size, int) \
        else (int(filter_size[0]), int(filter_size[1]))
    std = (2.0 / (kh * kw * num_channels)) ** 0.5
    w = helper.create_parameter(
        helper.param_attr, [num_filters, num_channels, kh, kw], dtype,
        default_initializer=NormalInitializer(0.0, std))
    scale = helper.create_parameter(
        scale_attr, [num_filters], "float32",
        default_initializer=ConstantInitializer(1.0))
    shift = helper.create_parameter(
        shift_attr, [num_filters], "float32", is_bias=True,
        default_initializer=ConstantInitializer(0.0))
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="conv2d_bn_relu",
        inputs={"X": [input], "Filter": [w], "Scale": [scale],
                "Shift": [shift]},
        outputs={"Out": [out]},
        attrs={"stride": int(stride), "padding": int(padding),
               "relu": bool(relu)},
    )
    return out


def _append_channel_bias(helper, pre_bias):
    bias_attr = helper.bias_attr
    if bias_attr is False:
        return pre_bias
    num_filters = pre_bias.shape[1]
    b = helper.create_parameter(
        bias_attr, [num_filters], pre_bias.dtype, is_bias=True
    )
    out = helper.create_variable_for_type_inference(pre_bias.dtype)
    helper.append_op(
        type="elementwise_add",
        inputs={"X": [pre_bias], "Y": [b]},
        outputs={"Out": [out]},
        attrs={"axis": 1},
    )
    return out


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    """reference layers/nn.py:1710. Filter layout [in_c, out_c/groups,
    kh, kw] (the conv_transpose convention — conv2d's is flipped). With
    no ``filter_size``, the filter that gives ``output_size``."""
    helper = LayerHelper(
        "conv2d_transpose", param_attr=param_attr, bias_attr=bias_attr,
        act=act, name=name,
    )
    dtype = input.dtype

    def _pair(v):
        return list(v) if isinstance(v, (list, tuple)) else [v, v]

    stride = _pair(stride)
    padding = _pair(padding)
    dilation = _pair(dilation)
    if filter_size is None:
        if output_size is None:
            raise ValueError("output_size must be set when filter_size is None")
        output_size = _pair(output_size)
        h_in, w_in = input.shape[2], input.shape[3]
        filter_size = [
            (output_size[0] - (h_in - 1) * stride[0] + 2 * padding[0] - 1)
            // dilation[0] + 1,
            (output_size[1] - (w_in - 1) * stride[1] + 2 * padding[1] - 1)
            // dilation[1] + 1,
        ]
    else:
        filter_size = _pair(filter_size)
    groups = groups or 1
    if num_filters % groups != 0:
        raise ValueError("num_filters must be divisible by groups")
    if input.shape[1] % groups != 0:
        raise ValueError(
            f"input channels ({input.shape[1]}) must be divisible by "
            f"groups ({groups})")
    filter_shape = [input.shape[1], num_filters // groups] + filter_size
    w = helper.create_parameter(helper.param_attr, filter_shape, dtype)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="conv2d_transpose",
        inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": stride, "paddings": padding,
               "dilations": dilation, "groups": groups},
    )
    pre_act = _append_channel_bias(helper, pre_bias)
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1, pool_padding=0,
           global_pooling=False, use_cudnn=True, ceil_mode=False, name=None):
    """reference layers/nn.py:1455."""
    helper = LayerHelper("pool2d", name=name)

    def _pair(v):
        return list(v) if isinstance(v, (list, tuple)) else [v, v]

    if ceil_mode and not global_pooling:
        # Deliberate divergence from the reference (pool_op.cc:33
        # PoolOutputSize), as in the JAX package: a last window living
        # entirely in right padding is clamped away (as torch does) — for
        # padding > ksize/2 the output would be one element smaller than
        # the reference's. Those configs are degenerate (a window of pure
        # padding pools nothing), so reject them at build time rather
        # than silently differ.
        for k, p in zip(_pair(pool_size), _pair(pool_padding)):
            if k > 0 and p * 2 > k:
                raise ValueError(
                    f"pool2d(ceil_mode=True) requires padding <= ksize/2 "
                    f"(got ksize={k}, padding={p}): larger padding would "
                    "create a final window made entirely of padding, where "
                    "this backend's output size deliberately diverges from "
                    "the reference's PoolOutputSize"
                )
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="pool2d",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={
            "pooling_type": pool_type,
            "ksize": _pair(pool_size),
            "strides": _pair(pool_stride),
            "paddings": _pair(pool_padding),
            "global_pooling": global_pooling,
            "ceil_mode": ceil_mode,
        },
    )
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, name=None, moving_mean_name=None,
               moving_variance_name=None, do_model_average_for_mean_and_var=False):
    """reference layers/nn.py:1508: creates scale/bias params + moving
    mean/variance persistable stats updated in-place by the op."""
    helper = LayerHelper(
        "batch_norm", param_attr=param_attr, bias_attr=bias_attr, name=name
    )
    dtype = input.dtype
    channels = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    shape = [channels]

    scale = helper.create_parameter(
        helper.param_attr, shape, dtype,
        default_initializer=ConstantInitializer(1.0),
    )
    bias = helper.create_parameter(helper.bias_attr, shape, dtype, is_bias=True)

    mean = helper.create_global_variable(
        name=moving_mean_name, shape=shape, dtype=dtype, persistable=True
    )
    helper.set_variable_initializer(mean, ConstantInitializer(0.0))
    variance = helper.create_global_variable(
        name=moving_variance_name, shape=shape, dtype=dtype, persistable=True
    )
    helper.set_variable_initializer(variance, ConstantInitializer(1.0))
    mean.stop_gradient = True
    variance.stop_gradient = True

    saved_mean = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)

    helper.append_op(
        type="batch_norm",
        inputs={
            "X": [input], "Scale": [scale], "Bias": [bias],
            "Mean": [mean], "Variance": [variance],
        },
        outputs={
            "Y": [out], "MeanOut": [mean], "VarianceOut": [variance],
            "SavedMean": [saved_mean], "SavedVariance": [saved_var],
        },
        attrs={
            "momentum": momentum, "epsilon": epsilon, "is_test": is_test,
            "data_layout": data_layout,
        },
    )
    helper.kwargs["act"] = act
    return helper.append_activation(out)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1, epsilon=1e-5,
               param_attr=None, bias_attr=None, act=None, name=None):
    """reference layers/nn.py:1597."""
    helper = LayerHelper(
        "layer_norm", param_attr=param_attr, bias_attr=bias_attr, act=act,
        name=name,
    )
    dtype = input.dtype
    param_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": [input]}
    if scale:
        s = helper.create_parameter(
            helper.param_attr, param_shape, dtype,
            default_initializer=ConstantInitializer(1.0),
        )
        inputs["Scale"] = [s]
    if shift:
        b = helper.create_parameter(
            helper.bias_attr, param_shape, dtype, is_bias=True
        )
        inputs["Bias"] = [b]
    mean_out = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    var_out = helper.create_variable_for_type_inference(dtype, stop_gradient=True)
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="layer_norm",
        inputs=inputs,
        outputs={"Y": [out], "Mean": [mean_out], "Variance": [var_out]},
        attrs={"epsilon": epsilon, "begin_norm_axis": begin_norm_axis},
    )
    return helper.append_activation(out)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None):
    """reference layers/nn.py:876."""
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    mask = helper.create_variable_for_type_inference(x.dtype, stop_gradient=True)
    helper.append_op(
        type="dropout",
        inputs={"X": [x]},
        outputs={"Out": [out], "Mask": [mask]},
        attrs={
            "dropout_prob": dropout_prob, "is_test": is_test,
            "seed": seed if seed is not None else 0,
        },
    )
    return out


def softmax(input, use_cudnn=True, name=None):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="softmax", inputs={"X": [input]}, outputs={"Out": [out]})
    return out


def cross_entropy(input, label, soft_label=False):
    """reference layers/nn.py:922."""
    helper = LayerHelper("cross_entropy")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="cross_entropy",
        inputs={"X": [input], "Label": [label]},
        outputs={"Y": [out]},
        attrs={"soft_label": soft_label},
    )
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False):
    """reference layers/nn.py:3165."""
    helper = LayerHelper("softmax_with_cross_entropy")
    softmax_out = helper.create_variable_for_type_inference(logits.dtype)
    loss = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op(
        type="softmax_with_cross_entropy",
        inputs={"Logits": [logits], "Label": [label]},
        outputs={"Softmax": [softmax_out], "Loss": [loss]},
        attrs={"soft_label": soft_label},
    )
    return loss


def square_error_cost(input, label):
    """reference layers/nn.py (square_error_cost): (input-label)^2 via
    elementwise_sub + square ops."""
    helper = LayerHelper("square_error_cost")
    minus_out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="elementwise_sub",
        inputs={"X": [input], "Y": [label]},
        outputs={"Out": [minus_out]},
    )
    square_out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="square", inputs={"X": [minus_out]}, outputs={"Out": [square_out]}
    )
    return square_out


def accuracy(input, label, k=1, correct=None, total=None):
    """reference layers/metric.py accuracy: top_k + accuracy op."""
    helper = LayerHelper("accuracy")
    topk_out, topk_indices = topk(input, k=k)
    acc_out = helper.create_variable_for_type_inference(dtype="float32")
    correct = correct or helper.create_variable_for_type_inference(dtype="int32")
    total = total or helper.create_variable_for_type_inference(dtype="int32")
    helper.append_op(
        type="accuracy",
        inputs={"Out": [topk_out], "Indices": [topk_indices], "Label": [label]},
        outputs={"Accuracy": [acc_out], "Correct": [correct], "Total": [total]},
    )
    return acc_out


def topk(input, k, name=None):
    helper = LayerHelper("top_k", name=name)
    values = helper.create_variable_for_type_inference(dtype=input.dtype)
    indices = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op(
        type="top_k",
        inputs={"X": [input]},
        outputs={"Out": [values], "Indices": [indices]},
        attrs={"k": k},
    )
    values.stop_gradient = True
    indices.stop_gradient = True
    return values, indices


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="mul",
        inputs={"X": [x], "Y": [y]},
        outputs={"Out": [out]},
        attrs={"x_num_col_dims": x_num_col_dims, "y_num_col_dims": y_num_col_dims},
    )
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    """reference layers/nn.py:2458."""
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="matmul",
        inputs={"X": [x], "Y": [y]},
        outputs={"Out": [out]},
        attrs={"transpose_X": transpose_x, "transpose_Y": transpose_y,
               "alpha": alpha},
    )
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=True, name=None):
    """reference layers/nn.py:3354."""
    helper = LayerHelper("reshape", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out_shape = list(shape)
    if x.shape is not None:
        # 0 = copy this dim from input (reference reshape semantics)
        out_shape = [
            x.shape[i] if s == 0 and i < len(x.shape) else s
            for i, s in enumerate(out_shape)
        ]
    out.desc.shape = out_shape
    helper.append_op(
        type="reshape", inputs={"X": [x]}, outputs={"Out": [out]},
        attrs={"shape": list(shape)},
    )
    return helper.append_activation(out)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="transpose", inputs={"X": [x]}, outputs={"Out": [out]},
        attrs={"axis": list(perm)},
    )
    return out


def ring_attention(q, k, v, causal=False, scale=0.0, impl="ring",
                   seq_axis="sp", batch_axis="dp", head_axis="", name=None):
    """Fused flash attention. q/k/v: [batch, seq, heads, head_dim].

    Flash attention (the op's K2/K3 kernels). Under a ParallelExecutor
    mesh the kernels run on `(batch_axis, None, head_axis, None)` shards;
    a mesh holding `seq_axis` runs sequence parallelism, `impl` 'ring'
    (K/V blocks rotate over the axis's ranks) or 'ulysses' (all-to-all
    heads <-> sequence).
    """
    helper = LayerHelper("ring_attention", name=name)
    out = helper.create_variable_for_type_inference(dtype=q.dtype)
    helper.append_op(
        type="ring_attention",
        inputs={"Q": [q], "K": [k], "V": [v]},
        outputs={"Out": [out]},
        attrs={"causal": causal, "scale": scale, "impl": impl,
               "seq_axis": seq_axis, "batch_axis": batch_axis,
               "head_axis": head_axis},
    )
    return out


def _reduce_layer(op_type):
    def layer(input, dim=None, keep_dim=False, name=None):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(input.dtype)
        if dim is None:
            attrs = {"dim": [0], "keep_dim": keep_dim, "reduce_all": True}
        else:
            dims = dim if isinstance(dim, (list, tuple)) else [dim]
            attrs = {"dim": list(dims), "keep_dim": keep_dim, "reduce_all": False}
        helper.append_op(
            type=op_type, inputs={"X": [input]}, outputs={"Out": [out]}, attrs=attrs
        )
        return out

    layer.__name__ = op_type
    return layer


reduce_sum = _reduce_layer("reduce_sum")
reduce_mean = _reduce_layer("reduce_mean")
reduce_max = _reduce_layer("reduce_max")
reduce_min = _reduce_layer("reduce_min")
reduce_prod = _reduce_layer("reduce_prod")


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="clip", inputs={"X": [x]}, outputs={"Out": [out]},
        attrs={"min": min, "max": max},
    )
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="clip_by_norm", inputs={"X": [x]}, outputs={"Out": [out]},
        attrs={"max_norm": max_norm},
    )
    return out


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """reference layers/nn.py:3323 — a persistable int64 counter, set to
    ``begin - 1`` by the startup program and incremented by an
    ``increment`` op prepended to the main program's global block, so
    every op of a step reads the step's value; it drives the LR
    schedules."""
    helper = LayerHelper("global_step_counter")
    counter_name = counter_name or "@STEP_COUNTER@"
    counter = helper.create_global_variable(
        name=counter_name, dtype="int64", shape=[1], persistable=True
    )
    helper.set_variable_initializer(counter, ConstantInitializer(begin - 1))
    helper.main_program.global_block().prepend_op(
        type="increment",
        inputs={"X": [counter]},
        outputs={"Out": [counter]},
        attrs={"step": float(step)},
    )
    counter.stop_gradient = True
    return counter


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", act=act, name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="scale", inputs={"X": [x]}, outputs={"Out": [out]},
        attrs={"scale": scale, "bias": bias, "bias_after_scale": bias_after_scale},
    )
    return helper.append_activation(out)


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="expand", inputs={"X": [x]}, outputs={"Out": [out]},
        attrs={"expand_times": list(expand_times)},
    )
    return out


def _elementwise_layer(op_type):
    def layer(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, act=act, name=name)
        out = helper.create_variable_for_type_inference(x.dtype)
        if x.shape is not None:
            # broadcast keeps x's shape (y broadcasts onto x in the
            # reference's axis semantics) — lets downstream layers (fc)
            # see dims at build time
            out.desc.shape = list(x.shape)
        helper.append_op(
            type=op_type, inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]},
            attrs={"axis": axis},
        )
        return helper.append_activation(out)

    layer.__name__ = op_type
    return layer


elementwise_add = _elementwise_layer("elementwise_add")
elementwise_sub = _elementwise_layer("elementwise_sub")
elementwise_mul = _elementwise_layer("elementwise_mul")
elementwise_div = _elementwise_layer("elementwise_div")
elementwise_max = _elementwise_layer("elementwise_max")
elementwise_min = _elementwise_layer("elementwise_min")
elementwise_pow = _elementwise_layer("elementwise_pow")


def im2sequence(input, filter_size=1, stride=1, padding=0, name=None):
    helper = LayerHelper("im2sequence", name=name)

    def _pair(v):
        return list(v) if isinstance(v, (list, tuple)) else [v, v]

    # paddings normalize to [up, left, down, right] (reference
    # im2sequence_op.cc): scalar -> same all round, [ph, pw] -> symmetric
    if not isinstance(padding, (list, tuple)):
        padding = [padding] * 4
    elif len(padding) == 2:
        padding = [padding[0], padding[1], padding[0], padding[1]]
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="im2sequence", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"kernels": _pair(filter_size), "strides": _pair(stride),
               "paddings": list(padding)},
    )
    return out


def cos_sim(X, Y):
    helper = LayerHelper("cos_sim")
    out = helper.create_variable_for_type_inference(X.dtype)
    xnorm = helper.create_variable_for_type_inference(X.dtype)
    ynorm = helper.create_variable_for_type_inference(X.dtype)
    helper.append_op(
        type="cos_sim", inputs={"X": [X], "Y": [Y]},
        outputs={"Out": [out], "XNorm": [xnorm], "YNorm": [ynorm]},
    )
    return out


def edit_distance(input, label, normalized=False, ignored_tokens=None,
                  name=None):
    """reference layers/nn.py edit_distance — returns (distances [N,1],
    sequence_num [1]). `ignored_tokens` filtering is folded into the op via
    the attr (dense layout: ignored tokens must be padding-equivalent)."""
    helper = LayerHelper("edit_distance", name=name)
    out = helper.create_variable_for_type_inference(dtype="float32")
    seq_num = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op(
        type="edit_distance",
        inputs={"Hyps": [input], "Refs": [label]},
        outputs={"Out": [out], "SequenceNum": [seq_num]},
        attrs={"normalized": normalized,
               "ignored_tokens": list(ignored_tokens or [])},
    )
    return out, seq_num


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None, seq_length=None):
    """reference layers/nn.py chunk_eval — returns (precision, recall,
    f1_score, num_infer_chunks, num_label_chunks, num_correct_chunks)."""
    helper = LayerHelper("chunk_eval")
    precision = helper.create_variable_for_type_inference(dtype="float32")
    recall = helper.create_variable_for_type_inference(dtype="float32")
    f1_score = helper.create_variable_for_type_inference(dtype="float32")
    num_infer_chunks = helper.create_variable_for_type_inference(dtype="int64")
    num_label_chunks = helper.create_variable_for_type_inference(dtype="int64")
    num_correct_chunks = helper.create_variable_for_type_inference(dtype="int64")
    inputs = {"Inference": [input], "Label": [label]}
    if seq_length is not None:
        inputs["SeqLength"] = [seq_length]
    helper.append_op(
        type="chunk_eval",
        inputs=inputs,
        outputs={
            "Precision": [precision],
            "Recall": [recall],
            "F1-Score": [f1_score],
            "NumInferChunks": [num_infer_chunks],
            "NumLabelChunks": [num_label_chunks],
            "NumCorrectChunks": [num_correct_chunks],
        },
        attrs={"num_chunk_types": num_chunk_types,
               "chunk_scheme": chunk_scheme,
               "excluded_chunk_types": list(excluded_chunk_types or [])},
    )
    return (precision, recall, f1_score, num_infer_chunks, num_label_chunks,
            num_correct_chunks)


def warpctc(input, label, blank=0, norm_by_times=False):
    """CTC loss (reference layers/nn.py:2726 -> warpctc op, which links
    warp-ctc; here the emitter computes the exact CTC forward in log
    space). input: [N, T, C] raw logits; label: [N, L] padded. Returns
    per-example loss [N, 1]."""
    from .sequence import seq_lengths_of

    helper = LayerHelper("warpctc")
    loss = helper.create_variable_for_type_inference(input.dtype)
    grad = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"Logits": [input], "Label": [label]}
    in_len = seq_lengths_of(input)
    if in_len is not None:
        inputs["LogitsLength"] = [in_len]
    lab_len = seq_lengths_of(label)
    if lab_len is not None:
        inputs["LabelLength"] = [lab_len]
    helper.append_op(
        type="warpctc", inputs=inputs,
        outputs={"Loss": [loss], "WarpCTCGrad": [grad]},
        attrs={"blank": int(blank), "norm_by_times": bool(norm_by_times)},
    )
    return loss


def row_conv(input, future_context_size, param_attr=None, act=None):
    """Lookahead row convolution (reference layers/nn.py row_conv, the
    DeepSpeech2 streaming op): out[t] = sum_k x[t+k] w[k]."""
    from .sequence import _propagate_lengths, seq_lengths_of

    helper = LayerHelper("row_conv", param_attr=param_attr, act=act)
    filter_shape = [int(future_context_size) + 1, int(input.shape[-1])]
    w = helper.create_parameter(helper.param_attr, shape=filter_shape,
                                dtype=input.dtype)
    out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"X": [input], "Filter": [w]}
    lens = seq_lengths_of(input)
    if lens is not None:
        inputs["Lengths"] = [lens]
    helper.append_op(type="row_conv", inputs=inputs,
                     outputs={"Out": [out]})
    _propagate_lengths(input, out)
    return helper.append_activation(out)


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """One LSTM step (reference layers/nn.py lstm_unit): projects
    [x_t, h_prev] to the 4H gates with an fc, then applies the fused cell.
    Returns (hidden_t, cell_t)."""
    helper = LayerHelper("lstm_unit_layer", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    size = int(cell_t_prev.shape[-1])
    gates = fc(input=[x_t, hidden_t_prev], size=4 * size,
               param_attr=param_attr, bias_attr=bias_attr)
    c = helper.create_variable_for_type_inference(x_t.dtype)
    h = helper.create_variable_for_type_inference(x_t.dtype)
    helper.append_op(
        type="lstm_unit",
        inputs={"X": [gates], "C_prev": [cell_t_prev]},
        outputs={"C": [c], "H": [h]},
        attrs={"forget_bias": float(forget_bias)},
    )
    return h, c


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    dim = dim if dim >= 0 else len(input.shape) + dim
    if isinstance(num_or_sections, int):
        num = num_or_sections
        sections = []
    else:
        num = 0
        sections = list(num_or_sections)
    n_out = num if num else len(sections)
    outs = [
        helper.create_variable_for_type_inference(input.dtype)
        for _ in range(n_out)
    ]
    helper.append_op(
        type="split", inputs={"X": [input]}, outputs={"Out": outs},
        attrs={"num": num, "sections": sections, "axis": dim},
    )
    return outs


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    norm = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="l2_normalize", inputs={"X": [x]},
        outputs={"Out": [out], "Norm": [norm]},
        attrs={"axis": axis, "epsilon": epsilon},
    )
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper("smooth_l1_loss")
    diff = helper.create_variable_for_type_inference(x.dtype)
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": [x], "Y": [y]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight]
    helper.append_op(
        type="smooth_l1_loss", inputs=inputs,
        outputs={"Diff": [diff], "Out": [out]},
        attrs={"sigma": sigma if sigma is not None else 1.0},
    )
    return out


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    helper = LayerHelper("lrn", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    mid = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="lrn", inputs={"X": [input]},
        outputs={"Out": [out], "MidOut": [mid]},
        attrs={"n": n, "k": k, "alpha": alpha, "beta": beta},
    )
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="pad", inputs={"X": [x]}, outputs={"Out": [out]},
        attrs={"paddings": list(paddings), "pad_value": float(pad_value)},
    )
    return out


lookup_table = embedding


def one_hot(input, depth):
    """reference layers/nn.py:3284."""
    helper = LayerHelper("one_hot")
    out = helper.create_variable_for_type_inference(dtype="float32")
    helper.append_op(
        type="one_hot", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"depth": depth},
    )
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32", name=None):
    helper = LayerHelper("label_smooth", name=name)
    out = helper.create_variable_for_type_inference(dtype)
    inputs = {"X": [label]}
    if prior_dist is not None:
        inputs["PriorDist"] = [prior_dist]
    helper.append_op(
        type="label_smooth", inputs=inputs, outputs={"Out": [out]},
        attrs={"epsilon": float(epsilon)},
    )
    return out


def sigmoid_cross_entropy_with_logits(x, label, name=None):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="sigmoid_cross_entropy_with_logits",
        inputs={"X": [x], "Label": [label]},
        outputs={"Out": [out]},
    )
    return out


def prelu(x, mode="all", param_attr=None, name=None):
    """mode: 'all' (one alpha), 'channel' (alpha per channel, dim 1),
    'element' (alpha per element of x.shape[1:]) — reference prelu_op.cc."""
    helper = LayerHelper("prelu", param_attr=param_attr, name=name)
    if mode == "channel":
        alpha_shape = [int(x.shape[1])]
    elif mode == "element":
        alpha_shape = [int(d) for d in x.shape[1:]]
    else:
        alpha_shape = [1]
    alpha = helper.create_parameter(
        helper.param_attr, alpha_shape, x.dtype,
        default_initializer=ConstantInitializer(0.25),
    )
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="prelu", inputs={"X": [x], "Alpha": [alpha]},
        outputs={"Out": [out]}, attrs={"mode": mode},
    )
    return out


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None,
             name=None):
    """Hierarchical sigmoid cost over a complete binary tree of
    `num_classes` leaves (reference hierarchical_sigmoid_op.cc + legacy
    trainer_config_helpers hsigmoid): O(log K) per sample instead of a
    K-way softmax. Returns Cost [N, 1]."""
    helper = LayerHelper("hsigmoid", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    d = int(input.shape[-1])
    w = helper.create_parameter(helper.param_attr,
                                [num_classes - 1, d], input.dtype)
    inputs = {"X": [input], "W": [w], "Label": [label]}
    if bias_attr is not False:
        b = helper.create_parameter(helper.bias_attr, [num_classes - 1],
                                    input.dtype, is_bias=True)
        inputs["Bias"] = [b]
    cost = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="hierarchical_sigmoid", inputs=inputs,
        outputs={"Cost": [cost]}, attrs={"num_classes": num_classes},
    )
    return cost


def dot_product_attention(querys, keys, values):
    """reference nets.py scaled_dot_product_attention (simplified)."""
    product = matmul(querys, keys, transpose_y=True)
    attn = softmax(product)
    return matmul(attn, values), attn


def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=None):
    """Noise-contrastive estimation loss (reference layers/nn.py:2836 ->
    nce op). Returns per-example cost [N, 1]."""
    helper = LayerHelper("nce", param_attr=param_attr, bias_attr=bias_attr)
    dim = int(input.shape[-1])
    weight = helper.create_parameter(
        helper.param_attr, shape=[int(num_total_classes), dim],
        dtype=input.dtype)
    cost = helper.create_variable_for_type_inference(input.dtype)
    sample_logits = helper.create_variable_for_type_inference(input.dtype)
    sample_labels = helper.create_variable_for_type_inference("int64")
    inputs = {"Input": [input], "Label": [label], "Weight": [weight]}
    if helper.bias_attr is not False:  # bias_attr=False opts out
        inputs["Bias"] = [helper.create_parameter(
            helper.bias_attr, shape=[int(num_total_classes)],
            dtype=input.dtype, is_bias=True)]
    if sample_weight is not None:
        inputs["SampleWeight"] = [sample_weight]
    n_neg = 10 if num_neg_samples is None else int(num_neg_samples)
    if n_neg < 1:
        raise ValueError(f"num_neg_samples must be >= 1, got {n_neg}")
    helper.append_op(
        type="nce", inputs=inputs,
        outputs={"Cost": [cost], "SampleLogits": [sample_logits],
                 "SampleLabels": [sample_labels]},
        attrs={"num_total_classes": int(num_total_classes),
               "num_neg_samples": n_neg},
    )
    return cost


def multiplex(inputs, index):
    """Row-wise select among candidate tensors by per-row index (reference
    layers/nn.py multiplex -> multiplex op)."""
    helper = LayerHelper("multiplex")
    out = helper.create_variable_for_type_inference(inputs[0].dtype)
    helper.append_op(
        type="multiplex",
        inputs={"X": list(inputs), "Ids": [index]},
        outputs={"Out": [out]},
    )
    return out


def moe(input, num_experts, d_ff, capacity_factor=1.25, ep_axis="ep",
        name=None):
    """Mixture-of-experts FFN layer (Switch-style top-1 routing, moe_ffn op).

    input: [..., d]. Creates router weights [d, E] and expert weight stacks
    `<name>.experts.w1` [E, d, d_ff] / `<name>.experts.w2` [E, d_ff, d];
    under a ParallelExecutor mesh with `ep_axis` (plan_moe_ep) the expert
    stacks shard over it. Returns (out, aux_loss) — add a small multiple of
    aux_loss to the training loss for load balancing. The JAX package's
    capability extension; no 2018 reference counterpart.
    """
    helper = LayerHelper("moe", name=name)
    dtype = input.dtype
    d = input.shape[-1]
    base = name or helper.name or "moe"
    from ..param_attr import ParamAttr

    router_w = helper.create_parameter(
        ParamAttr(name=f"{base}.router.w"), [d, num_experts], dtype
    )
    w1 = helper.create_parameter(
        ParamAttr(name=f"{base}.experts.w1"), [num_experts, d, d_ff], dtype
    )
    w2 = helper.create_parameter(
        ParamAttr(name=f"{base}.experts.w2"), [num_experts, d_ff, d], dtype
    )
    out = helper.create_variable_for_type_inference(dtype)
    aux = helper.create_variable_for_type_inference("float32")
    helper.append_op(
        type="moe_ffn",
        inputs={"X": [input], "RouterW": [router_w], "W1": [w1], "W2": [w2]},
        outputs={"Out": [out], "AuxLoss": [aux]},
        attrs={"capacity_factor": capacity_factor, "ep_axis": ep_axis},
    )
    return out, aux
