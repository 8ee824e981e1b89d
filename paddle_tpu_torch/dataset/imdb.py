"""IMDB sentiment (reference python/paddle/dataset/imdb.py): sequences of
word ids + binary label. Serves the REAL aclImdb_v1.tar.gz wire format
(members aclImdb/{train,test}/{pos,neg}/*.txt, ad-hoc tokenization:
punctuation stripped, lowercased, whitespace split; dict built by
descending frequency then lexical order, '<unk>' appended — reference
imdb.py:36 tokenize / :55 build_dict) when the tarball sits under
`data_home()/imdb/`; else a synthetic fallback with class-correlated
ids."""
from __future__ import annotations

import os
import re
import string
import tarfile

import numpy as np

from . import common

VOCAB_SIZE = 5147
TAR_NAME = "aclImdb_v1.tar.gz"

_PUNCT_TABLE = str.maketrans("", "", string.punctuation)


def _tar_path():
    return os.path.join(common.data_home(), "imdb", TAR_NAME)


def _tokenize(pattern: "re.Pattern"):
    """Yield the token list of every tar member matching `pattern`.
    Sequential tarfile iteration, matching the reference's note about
    member order; tokenization = strip punctuation, lower, split."""
    with tarfile.open(_tar_path()) as tarf:
        tf = tarf.next()
        while tf is not None:
            if tf.isfile() and pattern.match(tf.name):
                text = tarf.extractfile(tf).read().decode(
                    "utf-8", errors="replace")
                yield (text.rstrip("\n\r").translate(_PUNCT_TABLE)
                       .lower().split())
            tf = tarf.next()


_DICT_CACHE: dict = {}


def build_dict(pattern=None, cutoff=0):
    """Word -> id by descending frequency (ties: lexical), '<unk>' last
    (reference imdb.py:55). Default pattern covers the whole train split.
    Memoized per (tar path, mtime, pattern, cutoff): on the real 80 MB
    tarball one build is a full decompress+tokenize pass — train() and
    test() must not each redo it."""
    if pattern is None:
        pattern = re.compile(r"aclImdb/train/(pos|neg)/.*\.txt$")
    path = _tar_path()
    key = (path, os.path.getmtime(path), pattern.pattern, cutoff)
    cached = _DICT_CACHE.get(key)
    if cached is not None:
        return dict(cached)
    freq: dict = {}
    for doc in _tokenize(pattern):
        for w in doc:
            freq[w] = freq.get(w, 0) + 1
    kept = [(w, c) for w, c in freq.items() if c > cutoff]
    kept.sort(key=lambda x: (-x[1], x[0]))
    word_idx = {w: i for i, (w, _) in enumerate(kept)}
    word_idx["<unk>"] = len(word_idx)
    _DICT_CACHE[key] = dict(word_idx)
    return word_idx


def word_dict():
    if os.path.exists(_tar_path()):
        return build_dict()
    return {f"w{i}": i for i in range(VOCAB_SIZE)}


def _real_reader(split: str, word_idx: dict):
    unk = word_idx["<unk>"]

    def load(polarity, label):
        pat = re.compile(rf"aclImdb/{split}/{polarity}/.*\.txt$")
        for doc in _tokenize(pat):
            yield [word_idx.get(w, unk) for w in doc], label

    def reader():
        # reference reader_creator: positives labelled 0, negatives 1
        yield from load("pos", 0)
        yield from load("neg", 1)

    return reader


def _reader_creator(split: str, word_idx=None):
    if os.path.exists(_tar_path()):
        return _real_reader(split, word_idx or word_dict())

    def reader():
        g = common.rng("imdb", split)
        n = 512
        for _ in range(n):
            label = int(g.integers(0, 2))
            length = int(g.integers(8, 120))
            base = g.integers(0, VOCAB_SIZE, size=length)
            if label == 1:
                base[: length // 3] = base[: length // 3] % 100
            else:
                base[: length // 3] = 100 + base[: length // 3] % 100
            yield base.tolist(), label

    return reader


def train(word_idx=None):
    return _reader_creator("train", word_idx)


def test(word_idx=None):
    return _reader_creator("test", word_idx)
