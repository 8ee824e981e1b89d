"""WMT16 en-de (reference python/paddle/dataset/wmt16.py): (src_ids,
trg_in_ids, trg_out_ids) with configurable vocab sizes and <s>/<e>/<unk>
specials. Synthetic copy-task fallback like wmt14. A copy of
``paddle_tpu/dataset/wmt16.py``: the same seeded samples."""
from __future__ import annotations

from . import common

TOTAL_EN_WORDS = 11250
TOTAL_DE_WORDS = 19220
START_MARK = "<s>"
END_MARK = "<e>"
UNK_MARK = "<unk>"
START_ID, END_ID, UNK_ID = 0, 1, 2


def get_dict(lang: str, dict_size: int, reverse: bool = False):
    words = [START_MARK, END_MARK, UNK_MARK] + [
        f"{lang}{i}" for i in range(dict_size - 3)
    ]
    if reverse:
        return {i: w for i, w in enumerate(words)}
    return {w: i for i, w in enumerate(words)}


def _reader_creator(split: str, src_dict_size: int, trg_dict_size: int):
    def reader():
        g = common.rng("wmt16", split)
        for _ in range(512):
            length = int(g.integers(3, 30))
            src = g.integers(3, src_dict_size, size=length).tolist()
            trg = [t % (trg_dict_size - 3) + 3 for t in src[::-1]]
            yield src, [START_ID] + trg, trg + [END_ID]

    return reader


def train(src_dict_size=TOTAL_EN_WORDS, trg_dict_size=TOTAL_DE_WORDS,
          src_lang="en"):
    return _reader_creator("train", src_dict_size, trg_dict_size)


def test(src_dict_size=TOTAL_EN_WORDS, trg_dict_size=TOTAL_DE_WORDS,
         src_lang="en"):
    return _reader_creator("test", src_dict_size, trg_dict_size)


def validation(src_dict_size=TOTAL_EN_WORDS, trg_dict_size=TOTAL_DE_WORDS,
               src_lang="en"):
    return _reader_creator("val", src_dict_size, trg_dict_size)
