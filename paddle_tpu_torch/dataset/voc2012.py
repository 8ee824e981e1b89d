"""PASCAL VOC2012 segmentation (reference python/paddle/dataset/voc2012.py):
(image [3,H,W] float32, segmentation label [H,W] int32). Synthetic 64x64
fallback: labels are thresholded channel blobs so a seg net can learn. A copy of
``paddle_tpu/dataset/voc2012.py``: the same seeded samples."""
from __future__ import annotations

import numpy as np

from . import common

NUM_CLASSES = 21
H = W = 64


def _reader_creator(split: str):
    def reader():
        g = common.rng("voc2012", split)
        for _ in range(64):
            img = g.random((3, H, W), dtype=np.float32)
            cls = int(g.integers(1, NUM_CLASSES))
            mask = (img.mean(axis=0) > 0.5)
            label = np.where(mask, cls, 0).astype(np.int32)
            yield img, label

    return reader


def train():
    return _reader_creator("train")


def test():
    return _reader_creator("test")


def val():
    return _reader_creator("val")
