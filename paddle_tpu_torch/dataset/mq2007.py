"""MQ2007 learning-to-rank (reference python/paddle/dataset/mq2007.py):
query-grouped 46-dim feature vectors with relevance labels, in pointwise /
pairwise / listwise forms. Synthetic fallback: relevance = noisy linear
function of the features so rankers can learn. A copy of
``paddle_tpu/dataset/mq2007.py``: the same seeded samples."""
from __future__ import annotations

import numpy as np

from . import common

FEATURE_DIM = 46


def _make_query(g):
    n_docs = int(g.integers(5, 20))
    feats = g.random((n_docs, FEATURE_DIM), dtype=np.float32)
    w = np.linspace(1.0, 0.1, FEATURE_DIM, dtype=np.float32)
    score = feats @ w + g.normal(0, 0.1, size=n_docs)
    spread = score.max() - score.min()
    rel = np.clip((score - score.min()) / (spread + 1e-6) * 2.99, 0,
                  2).astype(np.int64)
    return rel, feats


def _reader_creator(split: str, format: str):
    def reader():
        g = common.rng("mq2007", split)
        for _ in range(128):
            rel, feats = _make_query(g)
            if format == "listwise":
                yield rel.tolist(), feats
            elif format == "pairwise":
                order = np.argsort(-rel)
                for i in range(len(order)):
                    for j in range(i + 1, len(order)):
                        if rel[order[i]] > rel[order[j]]:
                            yield feats[order[i]], feats[order[j]]
            else:  # pointwise
                for r, f in zip(rel, feats):
                    yield f, int(r)

    return reader


def train(format: str = "pairwise"):
    return _reader_creator("train", format)


def test(format: str = "pairwise"):
    return _reader_creator("test", format)
