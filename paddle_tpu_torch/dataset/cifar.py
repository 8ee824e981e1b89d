"""CIFAR-10/100 (reference python/paddle/dataset/cifar.py). Serves the
REAL wire format when the original tarballs sit under
`data_home()/cifar/` — a .tar.gz of python-pickled batch dicts
({'data': uint8 [N, 3072], 'labels' or 'fine_labels': [N]}, py2 pickles,
so keys decode as BYTES under encoding='bytes') — else a synthetic
fallback: [3072] floats in [0,1], labels with a planted channel-mean
signal."""
from __future__ import annotations

import os
import pickle
import tarfile

import numpy as np

from . import common

CIFAR10_TAR = "cifar-10-python.tar.gz"
CIFAR100_TAR = "cifar-100-python.tar.gz"


def _real_reader(tar_path: str, sub_name: str):
    """Stream every batch member whose name contains `sub_name`
    (reference cifar.py:47 reader_creator): unpickle, yield
    (pixels/255 float32 [3072], int label). `fine_labels` carries the
    CIFAR-100 class."""

    def reader():
        with tarfile.open(tar_path, mode="r") as f:
            names = sorted(m.name for m in f
                           if sub_name in m.name and m.isfile())
            for name in names:
                batch = pickle.load(f.extractfile(name), encoding="bytes")
                data = batch.get(b"data", batch.get("data"))
                labels = batch.get(b"labels", batch.get("labels"))
                if labels is None:
                    labels = batch.get(b"fine_labels",
                                       batch.get("fine_labels"))
                assert data is not None and labels is not None, name
                data = np.asarray(data, dtype=np.uint8)
                for sample, label in zip(data, labels):
                    yield (sample / 255.0).astype(np.float32), int(label)

    return reader


def _reader_creator(split: str, num_classes: int):
    tar_name = CIFAR10_TAR if num_classes == 10 else CIFAR100_TAR
    tar_path = os.path.join(common.data_home(), "cifar", tar_name)
    if os.path.exists(tar_path):
        if num_classes == 10:
            # cifar-10 batches: data_batch_1..5 / test_batch
            sub = "data_batch" if split == "train" else "test_batch"
        else:
            # cifar-100: single 'train' / 'test' members
            sub = split
        return _real_reader(tar_path, sub)

    def reader():
        g = common.rng(f"cifar{num_classes}", split)
        n = 1024
        images = g.random((n, 3 * 32 * 32), dtype=np.float32)
        labels = g.integers(0, num_classes, size=n)
        images[np.arange(n), labels % 3072] += 0.5
        for i in range(n):
            yield images[i], int(labels[i])

    return reader


def train10():
    return _reader_creator("train", 10)


def test10():
    return _reader_creator("test", 10)


def train100():
    return _reader_creator("train", 100)


def test100():
    return _reader_creator("test", 100)
