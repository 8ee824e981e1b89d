"""ResNet for ImageNet/cifar10 (reference benchmark/fluid/resnet.py:90-173 —
conv_bn_layer/shortcut/bottleneck/layer_warp structure), a copy of
``paddle_tpu/models/resnet.py`` on the port's layers.

``fused=False`` (the training form) builds each chain as ``conv2d``
(cuDNN on a card) + ``batch_norm``. ``fused=True`` builds every
conv+bn(+relu) chain as the single ``conv2d_bn_relu`` op (the K5 kernel
on a card, its plain version on the CPU) — the inference-serving form,
where bn is a frozen per-channel affine (reference inference conv+bn
fuse passes / conv_mkldnn_op.cc). The two forms of one model function
pair one to one, in program order: a trained network's conv filters and
``kernels.conv_bn_relu.fold_bn`` of its batch-norm statistics fill the
fused form's Filter/Scale/Shift."""
from __future__ import annotations

from ..fluid import layers


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act="relu",
                  is_test=False, fused=False):
    if fused:
        return layers.conv2d_bn_relu(
            input, num_filters=ch_out, filter_size=filter_size,
            stride=stride, padding=padding, relu=(act == "relu"))
    conv = layers.conv2d(
        input=input, num_filters=ch_out, filter_size=filter_size,
        stride=stride, padding=padding, act=None, bias_attr=False,
    )
    return layers.batch_norm(input=conv, act=act, is_test=is_test)


def shortcut(input, ch_out, stride, is_test=False, fused=False):
    ch_in = input.shape[1]
    if ch_in != ch_out:
        return conv_bn_layer(input, ch_out, 1, stride, 0, act=None,
                             is_test=is_test, fused=fused)
    return input


def basicblock(input, ch_out, stride, is_test=False, fused=False):
    short = shortcut(input, ch_out, stride, is_test=is_test, fused=fused)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1, is_test=is_test,
                          fused=fused)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, act=None, is_test=is_test,
                          fused=fused)
    return layers.elementwise_add(x=short, y=conv2, act="relu")


def bottleneck(input, ch_out, stride, is_test=False, fused=False):
    short = shortcut(input, ch_out * 4, stride, is_test=is_test, fused=fused)
    conv1 = conv_bn_layer(input, ch_out, 1, stride, 0, is_test=is_test,
                          fused=fused)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, is_test=is_test,
                          fused=fused)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, act=None,
                          is_test=is_test, fused=fused)
    return layers.elementwise_add(x=short, y=conv3, act="relu")


def layer_warp(block_func, input, ch_out, count, stride, is_test=False,
               fused=False):
    res_out = block_func(input, ch_out, stride, is_test=is_test, fused=fused)
    for _ in range(1, count):
        res_out = block_func(res_out, ch_out, 1, is_test=is_test,
                             fused=fused)
    return res_out


def resnet_imagenet(input, class_dim=1000, depth=50, is_test=False,
                    fused=False):
    cfg = {
        18: ([2, 2, 2, 1], basicblock),
        34: ([3, 4, 6, 3], basicblock),
        50: ([3, 4, 6, 3], bottleneck),
        101: ([3, 4, 23, 3], bottleneck),
        152: ([3, 8, 36, 3], bottleneck),
    }
    stages, block_func = cfg[depth]
    conv1 = conv_bn_layer(input, ch_out=64, filter_size=7, stride=2,
                          padding=3, is_test=is_test, fused=fused)
    pool1 = layers.pool2d(input=conv1, pool_type="max", pool_size=3,
                          pool_stride=2, pool_padding=1)
    res1 = layer_warp(block_func, pool1, 64, stages[0], 1, is_test=is_test,
                      fused=fused)
    res2 = layer_warp(block_func, res1, 128, stages[1], 2, is_test=is_test,
                      fused=fused)
    res3 = layer_warp(block_func, res2, 256, stages[2], 2, is_test=is_test,
                      fused=fused)
    res4 = layer_warp(block_func, res3, 512, stages[3], 2, is_test=is_test,
                      fused=fused)
    pool2 = layers.pool2d(input=res4, pool_size=7, pool_type="avg",
                          global_pooling=True)
    return layers.fc(input=pool2, size=class_dim)


def resnet_cifar10(input, class_dim=10, depth=32, is_test=False,
                   fused=False):
    assert (depth - 2) % 6 == 0
    n = (depth - 2) // 6
    conv1 = conv_bn_layer(input, ch_out=16, filter_size=3, stride=1,
                          padding=1, is_test=is_test, fused=fused)
    res1 = layer_warp(basicblock, conv1, 16, n, 1, is_test=is_test,
                      fused=fused)
    res2 = layer_warp(basicblock, res1, 32, n, 2, is_test=is_test,
                      fused=fused)
    res3 = layer_warp(basicblock, res2, 64, n, 2, is_test=is_test,
                      fused=fused)
    pool = layers.pool2d(input=res3, pool_size=8, pool_type="avg",
                         global_pooling=True)
    return layers.fc(input=pool, size=class_dim)


def build_train(img, label, class_dim=1000, depth=50, variant="imagenet",
                is_test=False, fused=False):
    """Returns (avg_cost, accuracy, prediction)."""
    model = resnet_imagenet if variant == "imagenet" else resnet_cifar10
    logits = model(img, class_dim=class_dim, depth=depth, is_test=is_test,
                   fused=fused)
    cost = layers.softmax_with_cross_entropy(logits=logits, label=label)
    avg_cost = layers.mean(cost)
    prediction = layers.softmax(logits)
    acc = layers.accuracy(input=prediction, label=label)
    return avg_cost, acc, prediction
