"""Reader -> recordio file conversion (reference
python/paddle/fluid/recordio_writer.py:30 convert_reader_to_recordio_file).
Samples are pickled per record, in the format of the JAX package's
``paddle_tpu/fluid/recordio_writer.py`` (the port writes with its
pure-Python recordio writer)."""
from __future__ import annotations

import pickle
from typing import Callable, List

from ..native.recordio import DEFAULT_MAX_CHUNK, RecordIOWriter


def convert_reader_to_recordio_file(
    filename: str, reader_creator: Callable,
    max_chunk_bytes: int = DEFAULT_MAX_CHUNK,
) -> int:
    """Write every sample of the reader into one recordio file; returns the
    record count."""
    w = RecordIOWriter(filename, max_chunk_bytes)
    n = 0
    try:
        for sample in reader_creator():
            w.write(pickle.dumps(sample, protocol=pickle.HIGHEST_PROTOCOL))
            n += 1
    finally:
        w.close()
    return n


def convert_reader_to_recordio_files(
    filename_prefix: str, batch_per_file: int, reader_creator: Callable,
    max_chunk_bytes: int = DEFAULT_MAX_CHUNK,
) -> List[str]:
    """Shard the reader's samples across several files
    (`<prefix>-00000`, ...) — the unit the elastic master service hands out
    as tasks (reference go/master dataset sharding)."""
    files: List[str] = []
    w = None
    n_in_file = 0
    try:
        for i, sample in enumerate(reader_creator()):
            if w is None or n_in_file >= batch_per_file:
                if w is not None:
                    w.close()
                path = f"{filename_prefix}-{len(files):05d}"
                files.append(path)
                w = RecordIOWriter(path, max_chunk_bytes)
                n_in_file = 0
            w.write(pickle.dumps(sample, protocol=pickle.HIGHEST_PROTOCOL))
            n_in_file += 1
    finally:
        if w is not None:
            w.close()
    return files
