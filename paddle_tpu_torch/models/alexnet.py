"""AlexNet (reference benchmark/alexnet.py, legacy v2 benchmark suite), a
copy of ``paddle_tpu/models/alexnet.py`` on the port's layers.

The reference's legacy-GPU table (benchmark/README.md:33-40) trains this
network at batch 128 on 224x224 images. The standard one-tower AlexNet
(5 conv + 3 fc, LRN after conv1/conv2); the original two-tower split's
grouped convolutions are folded into full convs, as in the reference
benchmark config.
"""
from __future__ import annotations

from ..fluid import layers


def alexnet(img, class_dim=1000):
    """img: [-1, 3, 224, 224] -> logits [-1, class_dim]."""
    conv1 = layers.conv2d(
        input=img, num_filters=96, filter_size=11, stride=4, padding=1,
        act="relu",
    )
    norm1 = layers.lrn(input=conv1, n=5, alpha=1e-4, beta=0.75)
    pool1 = layers.pool2d(
        input=norm1, pool_size=3, pool_stride=2, pool_type="max")

    conv2 = layers.conv2d(
        input=pool1, num_filters=256, filter_size=5, padding=2, act="relu")
    norm2 = layers.lrn(input=conv2, n=5, alpha=1e-4, beta=0.75)
    pool2 = layers.pool2d(
        input=norm2, pool_size=3, pool_stride=2, pool_type="max")

    conv3 = layers.conv2d(
        input=pool2, num_filters=384, filter_size=3, padding=1, act="relu")
    conv4 = layers.conv2d(
        input=conv3, num_filters=384, filter_size=3, padding=1, act="relu")
    conv5 = layers.conv2d(
        input=conv4, num_filters=256, filter_size=3, padding=1, act="relu")
    pool5 = layers.pool2d(
        input=conv5, pool_size=3, pool_stride=2, pool_type="max")

    fc6 = layers.fc(input=pool5, size=4096, act="relu")
    drop6 = layers.dropout(x=fc6, dropout_prob=0.5)
    fc7 = layers.fc(input=drop6, size=4096, act="relu")
    drop7 = layers.dropout(x=fc7, dropout_prob=0.5)
    return layers.fc(input=drop7, size=class_dim)


def build_train(img, label, class_dim=1000):
    logits = alexnet(img, class_dim=class_dim)
    cost = layers.softmax_with_cross_entropy(logits=logits, label=label)
    avg_cost = layers.mean(cost)
    prediction = layers.softmax(logits)
    acc = layers.accuracy(input=prediction, label=label)
    return avg_cost, acc, prediction
