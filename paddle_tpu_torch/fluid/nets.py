"""Composite network helpers (reference python/paddle/fluid/nets.py): the
image-classification ones, ``glu``, ``scaled_dot_product_attention`` and
the text chapters' ``sequence_conv_pool``, copied from
``paddle_tpu/fluid/nets.py``."""
from __future__ import annotations

from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group", "glu",
           "scaled_dot_product_attention", "sequence_conv_pool"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, act, param_attr=None, pool_type="max",
                         use_cudnn=True, use_mkldnn=False):
    conv_out = layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        param_attr=param_attr, act=act,
    )
    return layers.pool2d(
        input=conv_out, pool_size=pool_size, pool_type=pool_type,
        pool_stride=pool_stride,
    )


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True,
                   use_mkldnn=False):
    tmp = input
    if not isinstance(conv_num_filter, (list, tuple)):
        raise TypeError("conv_num_filter must be a list or tuple")

    def _expand(v):
        return v if isinstance(v, (list, tuple)) else [v] * len(conv_num_filter)

    conv_padding = _expand(conv_padding)
    conv_filter_size = _expand(conv_filter_size)
    param_attr = _expand(param_attr)
    conv_with_batchnorm = _expand(conv_with_batchnorm)
    conv_batchnorm_drop_rate = _expand(conv_batchnorm_drop_rate)

    for i in range(len(conv_num_filter)):
        local_conv_act = conv_act
        if conv_with_batchnorm[i]:
            local_conv_act = None
        tmp = layers.conv2d(
            input=tmp, num_filters=conv_num_filter[i],
            filter_size=conv_filter_size[i], padding=conv_padding[i],
            param_attr=param_attr[i], act=local_conv_act,
        )
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            drop_rate = conv_batchnorm_drop_rate[i]
            if abs(drop_rate) > 1e-5:
                tmp = layers.dropout(x=tmp, dropout_prob=drop_rate)
    return layers.pool2d(
        input=tmp, pool_size=pool_size, pool_type=pool_type,
        pool_stride=pool_stride,
    )


def glu(input, dim=-1):
    """Gated linear unit: the first half of ``dim`` times the sigmoid of
    the second."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(x=a, y=layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """reference nets.py:345 — multi-head scaled dot-product attention on
    [batch, seq, dim] tensors."""
    if not (len(queries.shape) == len(keys.shape) == len(values.shape) == 3):
        raise ValueError("inputs must be 3-D [batch, seq, dim]")
    d_k = queries.shape[-1] // num_heads

    def _split_heads(x):
        if num_heads == 1:
            return x
        reshaped = layers.reshape(
            x, shape=[0, 0, num_heads, x.shape[-1] // num_heads]
        )
        return layers.transpose(reshaped, perm=[0, 2, 1, 3])

    def _combine_heads(x):
        if num_heads == 1:
            return x
        t = layers.transpose(x, perm=[0, 2, 1, 3])
        return layers.reshape(t, shape=[0, 0, t.shape[2] * t.shape[3]])

    q, k, v = _split_heads(queries), _split_heads(keys), _split_heads(values)
    scaled_q = layers.scale(q, scale=d_k ** -0.5)
    product = layers.matmul(scaled_q, k, transpose_y=True)
    weights = layers.softmax(product)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate)
    ctx = layers.matmul(weights, v)
    return _combine_heads(ctx)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max"):
    """reference python/paddle/fluid/nets.py sequence_conv_pool — text-conv
    building block used by the sentiment book chapter."""
    conv_out = layers.sequence_conv(
        input=input, num_filters=num_filters, filter_size=filter_size,
        param_attr=param_attr, act=act,
    )
    return layers.sequence_pool(input=conv_out, pool_type=pool_type)
