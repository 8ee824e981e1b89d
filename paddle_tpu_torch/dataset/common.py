"""Shared dataset helpers (reference python/paddle/dataset/common.py, minus
the downloader — no egress; synthetic fallbacks are deterministic)."""
from __future__ import annotations

import os
import zlib

import numpy as np

DATA_HOME = os.environ.get(
    "PADDLE_TPU_DATA", os.path.expanduser("~/.cache/paddle_tpu/dataset")
)


def data_home() -> str:
    """Resolve the data root at CALL time (not import time) so a test or
    launcher can point PADDLE_TPU_DATA at real-format files after the
    package is already imported."""
    return os.environ.get("PADDLE_TPU_DATA", DATA_HOME)


def rng(name: str, split: str) -> np.random.Generator:
    # crc32, not hash(): python's hash is salted per process, which would
    # make "deterministic" synthetic data differ between processes
    seed = zlib.crc32(f"{name}/{split}".encode()) % (2**31)
    return np.random.default_rng(seed)


# the files each reader requires before it serves real data (must match
# the reader's own probe — a PARTIAL drop still serves synthetic, and this
# report must say so)
_REQUIRED_FILES = {
    "mnist": ["train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz",
              "t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz"],
    # 'cifar' covers the CIFAR-10 readers; CIFAR-100 provenance must be
    # queried with the explicit file (data_source("cifar",
    # "cifar-100-python.tar.gz")) since either tarball can be dropped
    # without the other
    "cifar": ["cifar-10-python.tar.gz"],
    "imdb": ["aclImdb_v1.tar.gz"],
    "wmt14": ["wmt14.tgz"],
}


def data_source(name: str, *relative_files: str) -> str:
    """'real' when every file the reader needs exists under
    DATA_HOME/<name>, else 'synthetic' — so experiments can STATE which
    data trained them (book chapters in hermetic CI run on the synthetic
    fallbacks; drop the original files under DATA_HOME to switch every
    reader to real data). Pass the file list explicitly for datasets not
    in _REQUIRED_FILES; a bare name with no known file list conservatively
    reports 'synthetic' rather than guessing from a non-empty directory."""
    base = os.path.join(data_home(), name)
    files = list(relative_files) or _REQUIRED_FILES.get(name)
    if not files:
        return "synthetic"
    ok = all(os.path.exists(os.path.join(base, f)) for f in files)
    return "real" if ok else "synthetic"
