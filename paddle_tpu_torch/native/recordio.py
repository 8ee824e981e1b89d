"""RecordIO reader/writer in pure Python — the on-disk format of
``paddle_tpu/native/recordio.py`` (reference paddle/fluid/recordio/,
chunk.h:26), so a file written by either package reads in the other.

Format: an 8-byte magic, then chunks. A chunk is a 16-byte header
``<IIII`` (record count, raw length, compressed length, crc32 of the
compressed bytes) followed by the zlib-compressed concatenation of
``<I`` length-prefixed records. The JAX package also has a native
(C++, ctypes) writer and reader of the same format; the port has only
this one."""
from __future__ import annotations

import struct
import zlib
from typing import Iterator, List, Optional, Sequence

MAGIC = b"PTRIO1\n\0"
DEFAULT_MAX_CHUNK = 1 << 20


class RecordIOWriter:
    def __init__(self, path: str, max_chunk_bytes: int = DEFAULT_MAX_CHUNK):
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        self._buf: List[bytes] = []
        self._size = 0
        self._max = max_chunk_bytes

    def write(self, record: bytes):
        self._buf.append(struct.pack("<I", len(record)) + record)
        self._size += len(record) + 4
        if self._size >= self._max:
            self._flush()

    def _flush(self):
        if not self._buf:
            return
        raw = b"".join(self._buf)
        comp = zlib.compress(raw)
        self._f.write(struct.pack("<IIII", len(self._buf), len(raw),
                                  len(comp), zlib.crc32(comp)))
        self._f.write(comp)
        self._buf, self._size = [], 0

    def close(self):
        self._flush()
        self._f.close()


class RecordIOReader:
    def __init__(self, path: str):
        self._f = open(path, "rb")
        if self._f.read(8) != MAGIC:
            self._f.close()
            raise IOError(f"{path}: not a recordio file")
        self._records: List[bytes] = []
        self._idx = 0

    def read(self) -> Optional[bytes]:
        while self._idx >= len(self._records):
            head = self._f.read(16)
            if not head:
                return None
            if len(head) != 16:
                raise IOError("truncated chunk header")
            _, raw_len, comp_len, crc = struct.unpack("<IIII", head)
            comp = self._f.read(comp_len)
            if len(comp) != comp_len or zlib.crc32(comp) != crc:
                raise IOError("corrupt chunk (crc mismatch)")
            raw = zlib.decompress(comp)
            if len(raw) != raw_len:
                raise IOError("corrupt chunk (length mismatch)")
            self._records, self._idx, pos = [], 0, 0
            while pos < len(raw):
                (n,) = struct.unpack_from("<I", raw, pos)
                pos += 4
                self._records.append(raw[pos:pos + n])
                pos += n
        rec = self._records[self._idx]
        self._idx += 1
        return rec

    def close(self):
        self._f.close()


def read_all(path: str) -> List[bytes]:
    r = RecordIOReader(path)
    out = []
    try:
        while True:
            rec = r.read()
            if rec is None:
                return out
            out.append(rec)
    finally:
        r.close()


def multi_file_reader(paths: Sequence[str]) -> Iterator[bytes]:
    """Every record of ``paths``, file after file (the JAX package's
    Python fallback; its native path interleaves files across C++ pool
    threads)."""
    for p in paths:
        r = RecordIOReader(p)
        try:
            while True:
                rec = r.read()
                if rec is None:
                    break
                yield rec
        finally:
            r.close()
