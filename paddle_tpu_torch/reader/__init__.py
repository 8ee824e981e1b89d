"""Functional reader combinators (reference python/paddle/reader/decorator.py:
map_readers:29, shuffle:51, chain:86, compose:118, buffered:165, firstn:208;
batch.py). A reader is a zero-arg callable returning an iterable of samples.

A copy of ``paddle_tpu/reader/__init__.py``: the same decorators draw the
same samples from the same seeds (``shuffle`` uses the module ``random``)."""
from __future__ import annotations

import itertools
import queue
import random
import threading

__all__ = [
    "map_readers", "shuffle", "chain", "compose", "buffered", "firstn",
    "batch", "cache", "xmap_readers", "ComposeNotAligned",
]


class ComposeNotAligned(ValueError):
    pass


def map_readers(func, *readers):
    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)

    return reader


def shuffle(reader, buf_size):
    def data_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            random.shuffle(buf)
            for b in buf:
                yield b

    return data_reader


def chain(*readers):
    def reader():
        rs = [r() for r in readers]
        return itertools.chain(*rs)

    return reader


def compose(*readers, **kwargs):
    check_alignment = kwargs.pop("check_alignment", True)

    def make_tuple(x):
        if isinstance(x, tuple):
            return x
        return (x,)

    def reader():
        rs = [r() for r in readers]
        if not check_alignment:
            for outputs in zip(*rs):
                yield sum(list(map(make_tuple, outputs)), ())
        else:
            for outputs in itertools.zip_longest(*rs):
                for o in outputs:
                    if o is None:
                        raise ComposeNotAligned(
                            "outputs of readers are not aligned"
                        )
                yield sum(list(map(make_tuple, outputs)), ())

    return reader


def buffered(reader, size):
    """Prefetch via a daemon thread + bounded queue (reference
    decorator.py:165) — the host-side double-buffer that overlaps input with
    device steps."""

    class EndSignal:
        pass

    end = EndSignal()

    def read_worker(r, q):
        for d in r:
            q.put(d)
        q.put(end)

    def data_reader():
        r = reader()
        q = queue.Queue(maxsize=size)
        t = threading.Thread(target=read_worker, args=(r, q))
        t.daemon = True
        t.start()
        e = q.get()
        while e is not end:
            yield e
            e = q.get()

    return data_reader


def firstn(reader, n):
    def firstn_reader():
        for i, item in enumerate(reader()):
            if i == n:
                break
            yield item

    return firstn_reader


def cache(reader):
    all_data = []

    def __impl__():
        if not all_data:
            all_data.extend(reader())
        return iter(all_data)

    return __impl__


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Thread-pool mapped reader (reference decorator.py xmap_readers)."""

    def data_reader():
        import concurrent.futures

        with concurrent.futures.ThreadPoolExecutor(process_num) as pool:
            it = reader()
            for out in pool.map(mapper, it):
                yield out

    return data_reader


def batch(reader, batch_size, drop_last: bool = False):
    """Minibatching (reference python/paddle/batch.py)."""

    def batch_reader():
        r = reader()
        b = []
        for instance in r:
            b.append(instance)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader
