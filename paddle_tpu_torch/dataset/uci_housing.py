"""UCI housing (reference python/paddle/dataset/uci_housing.py): 13 features,
1 regression target. Synthetic linear-plus-noise fallback so fit_a_line has a
learnable signal."""
from __future__ import annotations

import numpy as np

from . import common

FEATURE_DIM = 13


def _make(split: str, n: int):
    g = common.rng("uci_housing", "shared")
    w = g.standard_normal(FEATURE_DIM).astype(np.float32)
    b = 2.0
    gs = common.rng("uci_housing", split)
    x = gs.standard_normal((n, FEATURE_DIM)).astype(np.float32)
    y = x @ w + b + 0.1 * gs.standard_normal(n).astype(np.float32)
    return x, y.astype(np.float32)


def train():
    def reader():
        x, y = _make("train", 404)
        for i in range(x.shape[0]):
            yield x[i], y[i:i + 1]

    return reader


def test():
    def reader():
        x, y = _make("test", 102)
        for i in range(x.shape[0]):
            yield x[i], y[i:i + 1]

    return reader
