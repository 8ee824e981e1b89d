"""NLTK movie-review sentiment (reference python/paddle/dataset/sentiment.py):
(word id sequence, 0/1 label). Synthetic fallback, class-correlated ids. A copy of
``paddle_tpu/dataset/sentiment.py``: the same seeded samples."""
from __future__ import annotations

from . import common

VOCAB_SIZE = 2048


def get_word_dict():
    return {f"w{i}": i for i in range(VOCAB_SIZE)}


def _reader_creator(split: str):
    def reader():
        g = common.rng("sentiment", split)
        for _ in range(400):
            label = int(g.integers(0, 2))
            length = int(g.integers(10, 80))
            ids = g.integers(0, VOCAB_SIZE, size=length)
            ids[::4] = (ids[::4] % 200) + label * 200
            yield ids.tolist(), label

    return reader


def train():
    return _reader_creator("train")


def test():
    return _reader_creator("test")
