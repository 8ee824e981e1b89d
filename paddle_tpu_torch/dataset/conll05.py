"""CoNLL-2005 semantic role labeling (reference
python/paddle/dataset/conll05.py): per-token 8 feature slots + BIO label.
Synthetic fallback with predicate-correlated labels so the SRL book model
(label_semantic_roles) can learn."""
from __future__ import annotations

from . import common

WORD_DICT_LEN = 44068
LABEL_DICT_LEN = 67
PRED_DICT_LEN = 3162


def get_dict():
    word_dict = {f"w{i}": i for i in range(WORD_DICT_LEN)}
    verb_dict = {f"v{i}": i for i in range(PRED_DICT_LEN)}
    label_dict = {f"l{i}": i for i in range(LABEL_DICT_LEN)}
    return word_dict, verb_dict, label_dict


def get_embedding():
    """Reference returns a pretrained word-embedding file path; synthetic
    data has none."""
    return None


def _reader_creator(split: str):
    def reader():
        g = common.rng("conll05", split)
        for _ in range(256):
            length = int(g.integers(5, 40))
            word = g.integers(0, WORD_DICT_LEN, size=length).tolist()
            pred = int(g.integers(0, PRED_DICT_LEN))
            mark_pos = int(g.integers(0, length))
            mark = [1 if i == mark_pos else 0 for i in range(length)]
            # labels correlated with distance to the predicate: learnable
            label = [
                (abs(i - mark_pos) + pred) % LABEL_DICT_LEN
                for i in range(length)
            ]
            ctx = [
                [(w + d) % WORD_DICT_LEN for w in word]
                for d in (-2, -1, 0, 1, 2)
            ]
            yield (word, ctx[0], ctx[1], ctx[2], ctx[3], ctx[4],
                   [pred] * length, mark, label)

    return reader


def train():
    return _reader_creator("train")


def test():
    return _reader_creator("test")
