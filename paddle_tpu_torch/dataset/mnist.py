"""MNIST reader creators (reference python/paddle/dataset/mnist.py).

Looks for the standard IDX files under `common.DATA_HOME/mnist`; otherwise
serves deterministic synthetic digits with the real shapes ([784] floats in
[-1,1], int label 0-9)."""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from . import common

TRAIN_SIZE = 60000
TEST_SIZE = 10000


def _load_idx(images_path, labels_path):
    with gzip.open(labels_path, "rb") as f:
        magic, num = struct.unpack(">II", f.read(8))
        labels = np.frombuffer(f.read(), dtype=np.uint8)
    with gzip.open(images_path, "rb") as f:
        magic, num, rows, cols = struct.unpack(">IIII", f.read(16))
        images = np.frombuffer(f.read(), dtype=np.uint8).reshape(num, rows * cols)
    return images, labels


def _reader_creator(split: str, limit: int):
    data_dir = os.path.join(common.data_home(), "mnist")
    prefix = "train" if split == "train" else "t10k"
    images_path = os.path.join(data_dir, f"{prefix}-images-idx3-ubyte.gz")
    labels_path = os.path.join(data_dir, f"{prefix}-labels-idx1-ubyte.gz")

    if os.path.exists(images_path) and os.path.exists(labels_path):
        def reader():
            images, labels = _load_idx(images_path, labels_path)
            for i in range(images.shape[0]):
                yield (images[i].astype(np.float32) / 127.5 - 1.0,
                       int(labels[i]))

        return reader

    def synthetic_reader():
        g = common.rng("mnist", split)
        n = min(limit, 2048)
        images = g.standard_normal((n, 784)).astype(np.float32).clip(-1, 1)
        labels = g.integers(0, 10, size=n)
        # embed a weak class signal so models can actually learn
        for i in range(n):
            images[i, labels[i] * 78:(labels[i] + 1) * 78] += 1.5
        for i in range(n):
            yield images[i], int(labels[i])

    return synthetic_reader


def train():
    return _reader_creator("train", TRAIN_SIZE)


def test():
    return _reader_creator("test", TEST_SIZE)
