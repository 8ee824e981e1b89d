"""GoogLeNet / Inception-v1 (reference benchmark/googlenet.py, legacy
suite), a copy of ``paddle_tpu/models/googlenet.py`` on the port's
layers.

The reference's legacy-GPU table (benchmark/README.md:48-52) trains this
at batch 128 on 224x224 images. Standard Inception-v1: stem, 9 inception
blocks with 1x1/3x3/5x5/pool-proj branches concatenated on channels,
global average pool, one classifier head (the paper's two auxiliary
heads are left out, as in the reference benchmark config).
"""
from __future__ import annotations

from ..fluid import layers


def _inception(x, c1, c3r, c3, c5r, c5, proj):
    b1 = layers.conv2d(input=x, num_filters=c1, filter_size=1, act="relu")
    b3 = layers.conv2d(input=x, num_filters=c3r, filter_size=1, act="relu")
    b3 = layers.conv2d(input=b3, num_filters=c3, filter_size=3, padding=1,
                       act="relu")
    b5 = layers.conv2d(input=x, num_filters=c5r, filter_size=1, act="relu")
    b5 = layers.conv2d(input=b5, num_filters=c5, filter_size=5, padding=2,
                       act="relu")
    bp = layers.pool2d(input=x, pool_size=3, pool_stride=1, pool_padding=1,
                       pool_type="max")
    bp = layers.conv2d(input=bp, num_filters=proj, filter_size=1, act="relu")
    return layers.concat([b1, b3, b5, bp], axis=1)


def googlenet(img, class_dim=1000):
    """img: [-1, 3, 224, 224] -> logits [-1, class_dim]."""
    x = layers.conv2d(input=img, num_filters=64, filter_size=7, stride=2,
                      padding=3, act="relu")
    x = layers.pool2d(input=x, pool_size=3, pool_stride=2, pool_type="max")
    x = layers.conv2d(input=x, num_filters=64, filter_size=1, act="relu")
    x = layers.conv2d(input=x, num_filters=192, filter_size=3, padding=1,
                      act="relu")
    x = layers.pool2d(input=x, pool_size=3, pool_stride=2, pool_type="max")

    x = _inception(x, 64, 96, 128, 16, 32, 32)      # 3a
    x = _inception(x, 128, 128, 192, 32, 96, 64)    # 3b
    x = layers.pool2d(input=x, pool_size=3, pool_stride=2, pool_type="max")

    x = _inception(x, 192, 96, 208, 16, 48, 64)     # 4a
    x = _inception(x, 160, 112, 224, 24, 64, 64)    # 4b
    x = _inception(x, 128, 128, 256, 24, 64, 64)    # 4c
    x = _inception(x, 112, 144, 288, 32, 64, 64)    # 4d
    x = _inception(x, 256, 160, 320, 32, 128, 128)  # 4e
    x = layers.pool2d(input=x, pool_size=3, pool_stride=2, pool_type="max")

    x = _inception(x, 256, 160, 320, 32, 128, 128)  # 5a
    x = _inception(x, 384, 192, 384, 48, 128, 128)  # 5b
    x = layers.pool2d(input=x, pool_type="avg", global_pooling=True)
    x = layers.dropout(x=x, dropout_prob=0.4)
    return layers.fc(input=x, size=class_dim)


def build_train(img, label, class_dim=1000):
    logits = googlenet(img, class_dim=class_dim)
    cost = layers.softmax_with_cross_entropy(logits=logits, label=label)
    avg_cost = layers.mean(cost)
    prediction = layers.softmax(logits)
    acc = layers.accuracy(input=prediction, label=label)
    return avg_cost, acc, prediction
