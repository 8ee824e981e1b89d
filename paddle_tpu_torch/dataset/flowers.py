"""102-flowers (reference python/paddle/dataset/flowers.py): 3x224x224 images,
102 classes. Synthetic fallback. A copy of
``paddle_tpu/dataset/flowers.py``: the same seeded samples."""
from __future__ import annotations

import numpy as np

from . import common


def _reader_creator(split: str):
    def reader():
        g = common.rng("flowers", split)
        for _ in range(256):
            img = g.random((3, 224, 224), dtype=np.float32)
            label = int(g.integers(0, 102))
            yield img, label

    return reader


def train(mapper=None, buffered_size=1024, use_xmap=True):
    return _reader_creator("train")


def test(mapper=None, buffered_size=1024, use_xmap=True):
    return _reader_creator("test")


def valid(mapper=None, buffered_size=1024, use_xmap=True):
    return _reader_creator("valid")
