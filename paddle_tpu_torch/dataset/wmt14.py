"""WMT14 fr-en (reference python/paddle/dataset/wmt14.py): (src_ids,
trg_ids, trg_next_ids) triples. Serves the REAL wmt14.tgz wire format —
a tarball holding `src.dict` / `trg.dict` (one token per line, line
number = id) and tab-separated "src sentence\\ttrg sentence" pair files
under train/ and test/ (reference wmt14.py:52 __read_to_dict, :78
reader_creator) — when it sits under `data_home()/wmt14/`; else a
synthetic fallback with copy-task structure so seq2seq models can
learn. A copy of ``paddle_tpu/dataset/wmt14.py``: the same data home,
probe and synthetic samples."""
from __future__ import annotations

import os
import tarfile

from . import common

DICT_SIZE = 30000
START = "<s>"
END = "<e>"
UNK = "<unk>"
START_ID = 0
END_ID = 1
UNK_ID = 2
TAR_NAME = "wmt14.tgz"
MAX_LEN = 80  # reference drops training pairs longer than this


def _tar_path():
    return os.path.join(common.data_home(), "wmt14", TAR_NAME)


def _load_dict(tarf, suffix: str, dict_size: int):
    names = [m.name for m in tarf if m.name.endswith(suffix)]
    assert len(names) == 1, (suffix, names)
    out = {}
    for i, line in enumerate(tarf.extractfile(names[0])):
        if i >= dict_size:
            break
        out[line.decode("utf-8").strip()] = i
    return out


# (tar mtime, dict_size) -> (src_dict, trg_dict): the dictionaries are
# re-used every epoch AND by get_dict — parse the tarball once, not per
# reader() call (imdb.build_dict memoizes for the same reason)
_dict_cache: dict = {}


def _load_dicts(dict_size: int):
    key = (os.path.getmtime(_tar_path()), dict_size)
    if key not in _dict_cache:
        with tarfile.open(_tar_path(), mode="r") as f:
            _dict_cache[key] = (_load_dict(f, "src.dict", dict_size),
                                _load_dict(f, "trg.dict", dict_size))
    return _dict_cache[key]


def _real_reader(file_suffix: str, dict_size: int):
    def reader():
        src_dict, trg_dict = _load_dicts(dict_size)
        with tarfile.open(_tar_path(), mode="r") as f:
            names = [m.name for m in f
                     if file_suffix in m.name and m.isfile()
                     and not m.name.endswith(".dict")]
            for name in sorted(names):
                for line in f.extractfile(name):
                    parts = line.decode("utf-8").strip().split("\t")
                    if len(parts) != 2:
                        continue
                    src_words = parts[0].split()
                    trg_words = parts[1].split()
                    src_ids = [src_dict.get(w, UNK_ID)
                               for w in [START] + src_words + [END]]
                    trg_ids = [trg_dict.get(w, UNK_ID) for w in trg_words]
                    if len(src_ids) > MAX_LEN or len(trg_ids) > MAX_LEN:
                        continue
                    trg_next = trg_ids + [trg_dict[END]]
                    trg_ids = [trg_dict[START]] + trg_ids
                    yield src_ids, trg_ids, trg_next

    return reader


def _reader_creator(split: str, dict_size: int):
    if os.path.exists(_tar_path()):
        return _real_reader("train/" if split == "train" else "test/",
                            dict_size)

    def reader():
        g = common.rng("wmt14", split)
        for _ in range(512):
            length = int(g.integers(3, 30))
            src = g.integers(3, dict_size, size=length).tolist()
            trg = src[::-1]  # reversal copy-task
            yield src, [START_ID] + trg, trg + [END_ID]

    return reader


def train(dict_size=DICT_SIZE):
    return _reader_creator("train", dict_size)


def test(dict_size=DICT_SIZE):
    return _reader_creator("test", dict_size)


def get_dict(dict_size=DICT_SIZE, reverse=False):
    """(src_dict, trg_dict); reverse=True returns id->word maps
    (reference wmt14.py:136)."""
    if os.path.exists(_tar_path()):
        src, trg = _load_dicts(dict_size)
        if reverse:
            return ({v: k for k, v in src.items()},
                    {v: k for k, v in trg.items()})
        return src, trg
    src = {i: f"w{i}" for i in range(dict_size)}
    return (src, src) if reverse else (
        {v: k for k, v in src.items()}, {v: k for k, v in src.items()}
    )
