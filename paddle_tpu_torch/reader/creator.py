"""Reader creators (reference python/paddle/reader/creator.py: np_array,
text_file, recordio, cloud_reader) — a copy of
``paddle_tpu/reader/creator.py``; ``cloud_reader`` leases recordio shards
from the port's ``distributed.master``."""
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
    python/paddle/v2/reader/creator.py:91 cloud_reader — there, recordio
    chunks are leased from the Go master found via etcd; here from
    distributed.master.MasterService over its TCP RPC, of either
    package). The first reader to arrive registers the dataset; every
    worker then drains leased tasks — a worker that dies mid-task has its
    lease expire and the task re-queued, so records are processed
    at-least-once across the fleet. ``master_endpoint``: ``"host:port"``
    or a ``(host, port)`` pair."""
    if isinstance(paths, str):
        paths = [p for p in paths.split(",") if p]

    def reader():
        from ..distributed.master import MasterClient

        client = MasterClient(addr=master_endpoint)
        try:
            # idempotent on the service side: the first worker registers,
            # later workers (or later passes) join the existing queues
            client.set_dataset(list(paths))
            if client.all_done():
                # previous pass exhausted: this reader() call is an epoch —
                # re-queue the finished tasks (no-op race-safe: only one
                # caller's new_pass returns True, everyone then drains)
                client.new_pass()
            for rec in client.records():
                yield pickle.loads(rec) if unpickle else rec
        finally:
            client.close()

    return reader
