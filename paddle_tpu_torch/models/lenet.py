"""MNIST LeNet-5-style convnet (reference benchmark/fluid/mnist.py
cnn_model), a copy of ``paddle_tpu/models/lenet.py`` on the port's
layers."""
from __future__ import annotations

from ..fluid import layers, nets


def build(img, label):
    """img: [-1, 1, 28, 28], label: [-1, 1] int64.
    Returns (avg_cost, accuracy, prediction)."""
    conv1 = nets.simple_img_conv_pool(
        input=img, filter_size=5, num_filters=20, pool_size=2, pool_stride=2,
        act="relu",
    )
    conv2 = nets.simple_img_conv_pool(
        input=conv1, filter_size=5, num_filters=50, pool_size=2, pool_stride=2,
        act="relu",
    )
    fc1 = layers.fc(input=conv2, size=500, act="relu")
    logits = layers.fc(input=fc1, size=10)
    cost = layers.softmax_with_cross_entropy(logits=logits, label=label)
    avg_cost = layers.mean(cost)
    prediction = layers.softmax(logits)
    acc = layers.accuracy(input=prediction, label=label)
    return avg_cost, acc, prediction
