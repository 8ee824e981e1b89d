"""Reader creators (reference python/paddle/reader/creator.py: np_array,
text_file, recordio) — a copy of ``paddle_tpu/reader/creator.py``.
``cloud_reader`` needs the master service (``distributed.master``), which
is not ported yet."""
from __future__ import annotations

import pickle
from typing import Sequence, Union


def np_array(x):
    """Reader yielding rows of a numpy array."""

    def reader():
        for row in x:
            yield row

    return reader


def text_file(path: str):
    """Reader yielding stripped lines of a text file."""

    def reader():
        with open(path) as f:
            for line in f:
                yield line.rstrip("\n")

    return reader


def recordio(paths: Union[str, Sequence[str]], num_threads: int = 2,
             queue_capacity: int = 256):
    """Reader over recordio file(s) written by
    fluid.recordio_writer.convert_reader_to_recordio_file* — unpickles each
    record. Multiple paths are read one after the other (the port has
    the JAX package's pure-Python reader, not its threaded native one)."""
    if isinstance(paths, str):
        paths = [p for p in paths.split(",") if p]

    del num_threads, queue_capacity  # the JAX package's native prefetch

    def reader():
        from ..native.recordio import multi_file_reader

        for rec in multi_file_reader(list(paths)):
            yield pickle.loads(rec)

    return reader


def cloud_reader(paths: Union[str, Sequence[str]], master_endpoint,
                 unpickle: bool = True):
    """Master-fed fault-tolerant reader (reference
    python/paddle/v2/reader/creator.py:91; the JAX package leases recordio
    chunks from ``distributed.master.MasterService``). Not ported: the
    master service is ROADMAP Queue 1 item 6."""
    raise NotImplementedError(
        "reader.creator.cloud_reader needs distributed.master, which is not "
        "yet ported to paddle_tpu_torch (ROADMAP Queue 1 item 6)")
