"""SmallNet — the Caffe `cifar10_quick` convnet the reference benchmarks as
"SmallNet" (reference benchmark/smallnet_mnist_cifar.py; table at
benchmark/README.md:56-61, batch 128), a copy of
``paddle_tpu/models/smallnet.py`` on the port's layers.

3 conv/pool stages + 2 fc; cifar-scale [3, 32, 32] input.
"""
from __future__ import annotations

from ..fluid import layers


def smallnet(img, class_dim=10):
    """img: [-1, 3, 32, 32] -> logits [-1, class_dim]."""
    x = layers.conv2d(input=img, num_filters=32, filter_size=5, padding=2)
    x = layers.pool2d(input=x, pool_size=3, pool_stride=2, pool_type="max")
    x = layers.relu(x)
    x = layers.conv2d(input=x, num_filters=32, filter_size=5, padding=2,
                      act="relu")
    x = layers.pool2d(input=x, pool_size=3, pool_stride=2, pool_type="avg")
    x = layers.conv2d(input=x, num_filters=64, filter_size=5, padding=2,
                      act="relu")
    x = layers.pool2d(input=x, pool_size=3, pool_stride=2, pool_type="avg")
    x = layers.fc(input=x, size=64)
    return layers.fc(input=x, size=class_dim)


def build_train(img, label, class_dim=10):
    logits = smallnet(img, class_dim=class_dim)
    cost = layers.softmax_with_cross_entropy(logits=logits, label=label)
    avg_cost = layers.mean(cost)
    prediction = layers.softmax(logits)
    acc = layers.accuracy(input=prediction, label=label)
    return avg_cost, acc, prediction
