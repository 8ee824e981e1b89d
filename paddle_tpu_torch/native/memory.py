"""Host buddy allocator (``csrc/host/buddy_allocator.cc``) — the
staging-buffer side of the reference's memory layer
(``paddle/fluid/memory/detail/buddy_allocator.h:33``), the counterpart of
``paddle_tpu/native/memory.py``. Device memory is PyTorch's caching
allocator's; this arena is host memory.

numpy views into the arena let input pipelines fill buffers without
per-batch allocation. There is no pure-Python allocator: the host
library builds or the constructor raises (``native.load_native``)."""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np

from . import load_native

__all__ = ["BuddyAllocator"]


class BuddyAllocator:
    def __init__(self, total_bytes: int, min_block: int = 256,
                 guard: str = "slack"):
        """guard='slack' stamps canaries only in a block's natural slack
        (zero capacity overhead; exact power-of-two requests go
        unguarded); guard='always' bumps near-power-of-two requests one
        block level so every allocation carries a guard region."""
        if guard not in ("slack", "always"):
            raise ValueError("guard must be 'slack' or 'always'")
        self._lib = load_native()
        # id(view) -> (block address, view): the ledger keeps each view
        # alive (so its id stays unique) until free()
        self._handles: Dict[int, Tuple[int, np.ndarray]] = {}
        self._h: Optional[int] = self._lib.pt_buddy_create(
            total_bytes, min_block, 1 if guard == "always" else 0)
        if not self._h:
            raise MemoryError("buddy arena allocation failed")

    def alloc(self, count: int, dtype="uint8") -> Optional[np.ndarray]:
        """A numpy view over a fresh block of `count` elements of `dtype`
        (bytes for the default uint8); None if the arena is exhausted.
        Blocks must be returned with free() — dropping the view without
        freeing leaks its block (the allocator keeps the view alive in its
        ledger until then)."""
        dt = np.dtype(dtype)
        n = count * dt.itemsize
        p = self._lib.pt_buddy_alloc(self._h, n)
        if not p:
            return None
        buf = (ctypes.c_char * n).from_address(p)
        arr = np.frombuffer(buf, dtype=dt)
        self._handles[id(arr)] = (p, arr)
        return arr

    def free(self, arr: np.ndarray):
        entry = self._handles.get(id(arr))
        if entry is None or entry[1] is not arr:
            raise ValueError("array was not allocated by this allocator")
        del self._handles[id(arr)]
        rc = self._lib.pt_buddy_free(self._h, entry[0])
        if rc == -1:
            raise ValueError("double free or bad pointer")
        if rc == -2:
            # Guard bytes past the requested size were clobbered. The
            # allocator QUARANTINES the block (it never re-enters the
            # free lists), so the damaged memory cannot be handed out
            # again before this error is handled.
            raise MemoryError(
                "heap overwrite detected: guard bytes past the block's "
                "requested size were clobbered; block quarantined "
                "(reference meta_cache guard check)")

    def check(self) -> int:
        """Sweep all live blocks' guard regions; returns the number of
        corrupted blocks (reference memory/detail/meta_cache.cc guards)."""
        return int(self._lib.pt_buddy_check(self._h))

    def quarantined(self) -> int:
        """Bytes permanently held out of the arena after guard-corruption
        detection (containment beats reuse of damaged memory)."""
        return int(self._lib.pt_buddy_quarantined(self._h))

    def memory_usage(self) -> int:
        """Bytes currently allocated (reference memory::memory_usage)."""
        return int(self._lib.pt_buddy_used(self._h))

    @property
    def total(self) -> int:
        return int(self._lib.pt_buddy_total(self._h))

    def close(self):
        if self._h is not None:
            self._lib.pt_buddy_destroy(self._h)
            self._h = None
            self._handles.clear()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
