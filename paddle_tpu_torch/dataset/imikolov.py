"""PTB-style n-gram language-model dataset (reference
python/paddle/dataset/imikolov.py): yields (w0..w_{n-2}, w_{n-1}) id tuples.
Synthetic fallback: a noisy deterministic word chain so an n-gram model has
real signal to learn."""
from __future__ import annotations

from . import common

WORD_DICT_SIZE = 200


def build_dict(min_word_freq=50):
    return {f"w{i}": i for i in range(WORD_DICT_SIZE)}


def _reader_creator(split: str, n: int):
    def reader():
        g = common.rng("imikolov", split)
        v = WORD_DICT_SIZE
        n_seqs = 256
        for _ in range(n_seqs):
            length = 24
            w = int(g.integers(0, v))
            seq = [w]
            for _ in range(length - 1):
                if g.random() < 0.85:
                    w = (w * 3 + 7) % v
                else:
                    w = int(g.integers(0, v))
                seq.append(w)
            for i in range(len(seq) - n + 1):
                yield tuple(seq[i:i + n])

    return reader


def train(word_idx=None, n=5):
    return _reader_creator("train", n)


def test(word_idx=None, n=5):
    return _reader_creator("test", n)
