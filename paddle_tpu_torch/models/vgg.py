"""VGG-16 (reference benchmark/fluid/vgg.py vgg16_bn_drop), a copy of
``paddle_tpu/models/vgg.py`` on the port's layers."""
from __future__ import annotations

from ..fluid import layers, nets


def vgg16_bn_drop(input, class_dim=1000):
    def conv_block(inp, num_filter, groups, dropouts):
        return nets.img_conv_group(
            input=inp,
            pool_size=2,
            pool_stride=2,
            conv_num_filter=[num_filter] * groups,
            conv_filter_size=3,
            conv_act="relu",
            conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=dropouts,
            pool_type="max",
        )

    conv1 = conv_block(input, 64, 2, [0.3, 0])
    conv2 = conv_block(conv1, 128, 2, [0.4, 0])
    conv3 = conv_block(conv2, 256, 3, [0.4, 0.4, 0])
    conv4 = conv_block(conv3, 512, 3, [0.4, 0.4, 0])
    conv5 = conv_block(conv4, 512, 3, [0.4, 0.4, 0])

    drop = layers.dropout(x=conv5, dropout_prob=0.5)
    fc1 = layers.fc(input=drop, size=512, act=None)
    bn = layers.batch_norm(input=fc1, act="relu", data_layout="NHWC")
    drop2 = layers.dropout(x=bn, dropout_prob=0.5)
    fc2 = layers.fc(input=drop2, size=512, act=None)
    return layers.fc(input=fc2, size=class_dim)


def build_train(img, label, class_dim=1000):
    logits = vgg16_bn_drop(img, class_dim=class_dim)
    cost = layers.softmax_with_cross_entropy(logits=logits, label=label)
    avg_cost = layers.mean(cost)
    prediction = layers.softmax(logits)
    acc = layers.accuracy(input=prediction, label=label)
    return avg_cost, acc, prediction
