"""Tuning cache — the counterpart of ``paddle_tpu/autotune/cache.py``:
measured knobs replace hand-set constants.

The hard-coded values (``serving_buckets`` 1/2/4/8/16 regardless of
traffic, ``prefill_chunk`` read off one bench session) survive only as
*cold-cache defaults*; decisions come from a persistent tuning log over
measured, modeled or derived candidates.

The cache is a three-level map::

    (device_kind, tunable_id, shape_key) -> record

  - ``device_kind`` — ``torch.cuda.get_device_name()`` normalized
    (``nvidia_h100_80gb_hbm3``, ...) on a machine with a card, ``cpu``
    otherwise: a crossover is a property of the CARD, so one cache
    file carries per-device-kind decisions for a heterogeneous fleet.
  - ``tunable_id`` — the knob's name (``prefill_chunk``,
    ``serving_buckets``, ``decode_slots``, ``executor.step``, ...).
  - ``shape_key`` — ``""`` for shape-independent knobs, a stable
    shape/program fingerprint for per-shape records (step timings),
    ``"ladder"`` for derived bucket ladders.

Records are either decisions (``{"value": ..., "source": "measured" |
"model" | "derived" | "override"}``) or timing logs (``{"n",
"median_ms", "best_ms", "samples_ms"}``) — see measure.py for who
writes which. The file's bytes are the JAX package's for the same
records.

Persistence: when a directory is configured (``PADDLE_TPU_AUTOTUNE_DIR``
/ ``FLAGS['autotune_dir']``) the cache serializes to
``tuning_cache.json``: full tmp write + fsync, then an atomic
``os.replace`` (the ``autotune.save`` fault site sits between them, so
a crash mid-save never corrupts the previous file). A corrupt or
unreadable file degrades to an EMPTY cache — every consumer then falls
back to its hand-set default (``autotune.cache.corrupt`` counts the
event).

Every ``lookup`` counts ``autotune.cache.hits`` / ``autotune.cache.
misses`` — the counter pair that proves a knob reads through the cache.
"""
from __future__ import annotations

import atexit
import contextlib
import json
import os
import threading
from typing import Any, Dict, Optional

from ..observability import metrics as _metrics
from ..observability.log import get_logger

__all__ = ["TuningCache", "device_kind", "get_cache", "reset_cache",
           "scoped", "tuned_value", "CACHE_FILENAME"]

_log = get_logger("autotune")

_m_hits = _metrics.counter("autotune.cache.hits")
_m_misses = _metrics.counter("autotune.cache.misses")
_m_stores = _metrics.counter("autotune.cache.stores")
_m_corrupt = _metrics.counter("autotune.cache.corrupt")

CACHE_FILENAME = "tuning_cache.json"
_SCHEMA = 1
# per-key timing log depth: enough for a stable median, bounded so a
# long training session cannot grow the cache file per step
_TIMING_SAMPLES = 16


def _median(vals) -> float:
    s = sorted(vals)
    n = len(s)
    if not n:
        return 0.0
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


_kind_mu = threading.Lock()
_device_kind: Optional[str] = None  # guarded-by: _kind_mu


def device_kind() -> str:
    """Normalized kind of this process's card (``nvidia_h100_80gb_hbm3``,
    ...) or ``cpu`` on a machine without one — the first key of every
    cache entry. Computed once per process."""
    global _device_kind
    with _kind_mu:
        if _device_kind is None:
            import torch

            kind = (torch.cuda.get_device_name(0)
                    if torch.cuda.is_available() else "cpu")
            _device_kind = "_".join(
                "".join(c if c.isalnum() else " " for c in kind.lower())
                .split()) or "unknown"
        return _device_kind


class TuningCache:
    """The persistent (device_kind, tunable_id, shape_key) -> record
    store. Thread-safe: serving schedulers, executors, and benches all
    read/write it concurrently."""

    def __init__(self, dirname: Optional[str] = None):
        self._mu = threading.Lock()
        # serializes whole flushes (snapshot -> tmp write -> rename):
        # without it a SLOW flusher could os.replace a stale payload
        # over a newer flusher's file after the newer generation's
        # dirty bit was already cleared — a silently lost decision
        self._flush_mu = threading.Lock()
        # never rebound after construction (safe to read lock-free)
        self.dirname = str(dirname) if dirname else None
        self._data: Dict[str, Dict[str, Dict[str, Dict[str, Any]]]] = \
            {}  # guarded-by: _mu
        self._dirty = False  # guarded-by: _mu
        # bumped on every mutation: flush() re-validates it before
        # clearing _dirty, so a put() landing mid-write is never lost
        self._gen = 0  # guarded-by: _mu
        if self.dirname:
            self._load()

    # -- persistence ------------------------------------------------------
    @property
    def path(self) -> Optional[str]:
        return (os.path.join(self.dirname, CACHE_FILENAME)
                if self.dirname else None)

    def _load(self):
        """Read the cache file; ANY corruption degrades to empty (=
        hand-set defaults everywhere), never an error at import/load."""
        path = self.path
        if not path or not os.path.exists(path):
            return
        try:
            with open(path, "r", encoding="utf-8") as f:
                doc = json.load(f)
            if not isinstance(doc, dict) or doc.get("schema") != _SCHEMA:
                raise ValueError(f"bad schema: {type(doc).__name__}")
            entries = doc["entries"]
            for dev, per_dev in entries.items():
                for tid, per_tid in per_dev.items():
                    for sk, rec in per_tid.items():
                        if not isinstance(rec, dict):
                            raise ValueError(f"non-dict record at "
                                             f"{dev}/{tid}/{sk}")
        except Exception as e:
            _m_corrupt.inc()
            _log.warning(
                "tuning cache %s is corrupt (%s: %s) — degrading to "
                "defaults (an empty cache); the next flush rewrites it",
                path, type(e).__name__, e)
            return
        with self._mu:
            self._data = entries

    def flush(self) -> Optional[str]:
        """Persist atomically (tmp + fsync + rename). Returns the path
        written, or None (no directory / nothing dirty). A crash between
        tmp-write and rename — the ``autotune.save`` fault site — leaves
        the previous file intact and the cache still dirty, so a retry
        re-writes everything."""
        from ..distributed import faults as _faults

        with self._flush_mu:  # one flusher at a time, snapshot->rename
            with self._mu:
                if not self.dirname or not self._dirty:
                    return None
                gen = self._gen
                payload = json.dumps(
                    {"schema": _SCHEMA, "entries": self._data},
                    indent=1, sort_keys=True)
            os.makedirs(self.dirname, exist_ok=True)
            path = self.path
            # unique per writer: belt-and-braces under _flush_mu, and a
            # crashed flush's abandoned tmp never collides with a retry
            tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            _faults.fire("autotune.save")
            os.replace(tmp, path)
            # the check-then-act window is re-validated inside the
            # second acquisition: only the generation that was
            # serialized is marked clean — a mutation that landed
            # mid-write keeps the cache dirty
            # lint: allow-unguarded(_dirty)
            with self._mu:
                if self._gen == gen:
                    self._dirty = False
        return path

    # -- records ----------------------------------------------------------
    def lookup(self, tunable_id: str, shape_key: str = "",
               default: Any = None, device: Optional[str] = None,
               count: bool = True) -> Any:
        """The decision read-through: the cached value for this device
        kind, or ``default`` (the hand-set constant). Counts
        ``autotune.cache.hits``/``misses``."""
        dev = device or device_kind()
        with self._mu:
            rec = self._data.get(dev, {}).get(
                str(tunable_id), {}).get(str(shape_key))
        if rec is None or "value" not in rec:
            if count:
                _m_misses.inc()
            return default
        if count:
            _m_hits.inc()
        return rec["value"]

    def put(self, tunable_id: str, value: Any, shape_key: str = "",
            source: str = "measured", device: Optional[str] = None,
            extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Store a decision. ``source`` records provenance: 'measured'
        (timed runs), 'model' (measure.jit_cost), 'derived' (ladder
        from a shape histogram), 'override' (an operator pin)."""
        dev = device or device_kind()
        rec: Dict[str, Any] = {"value": value, "source": str(source)}
        if extra:
            rec.update(extra)
        with self._mu:
            self._data.setdefault(dev, {}).setdefault(
                str(tunable_id), {})[str(shape_key)] = rec
            self._dirty = True
            self._gen += 1
        _m_stores.inc()
        return rec

    def note_timing(self, tunable_id: str, shape_key: str, ms: float,
                    device: Optional[str] = None):
        """Append one timing sample for a (tunable, shape) key — the
        executor's per-shape step log. Bounded (last _TIMING_SAMPLES
        samples; count/min exact), so per-step calls cannot grow the
        cache."""
        dev = device or device_kind()
        ms = float(ms)
        with self._mu:
            rec = self._data.setdefault(dev, {}).setdefault(
                str(tunable_id), {}).setdefault(str(shape_key), {})
            samples = rec.setdefault("samples_ms", [])
            samples.append(round(ms, 4))
            del samples[:-_TIMING_SAMPLES]
            rec["n"] = int(rec.get("n", 0)) + 1
            rec["median_ms"] = round(_median(samples), 4)
            rec["best_ms"] = round(min(ms, float(rec.get("best_ms", ms))), 4)
            self._dirty = True
            self._gen += 1

    def timing(self, tunable_id: str, shape_key: str = "",
               device: Optional[str] = None) -> Optional[Dict[str, Any]]:
        """The timing record for a key, or None — a present record is
        how repeat sessions skip re-measurement."""
        dev = device or device_kind()
        with self._mu:
            rec = self._data.get(dev, {}).get(
                str(tunable_id), {}).get(str(shape_key))
            return dict(rec) if rec and "n" in rec else None

    def entries(self) -> Dict[str, Any]:
        """Deep snapshot of every record (bench evidence / --dump)."""
        with self._mu:
            return json.loads(json.dumps(self._data))

    def stats(self) -> Dict[str, Any]:
        with self._mu:
            n = sum(len(per_tid)
                    for per_dev in self._data.values()
                    for per_tid in per_dev.values())
            return {"dirname": self.dirname, "device_kinds":
                    sorted(self._data), "entries": n}

    def clear(self):
        with self._mu:
            self._data = {}
            self._dirty = True
            self._gen += 1


# -- the process singleton -----------------------------------------------

_cache_mu = threading.Lock()
_cache: Optional[TuningCache] = None  # guarded-by: _cache_mu


def get_cache() -> TuningCache:
    """The process cache, created lazily from ``FLAGS['autotune_dir']``
    (itself seeded from ``PADDLE_TPU_AUTOTUNE_DIR``). The directory is
    read ONCE at creation — use ``scoped()`` (tests/benches) or
    ``reset_cache()`` to re-point it."""
    global _cache
    with _cache_mu:
        if _cache is None:
            from ..flags import FLAGS

            _cache = TuningCache(FLAGS["autotune_dir"] or None)
        return _cache


def reset_cache():
    """Drop the singleton; the next get_cache() re-reads the flag."""
    global _cache
    with _cache_mu:
        _cache = None


@contextlib.contextmanager
def scoped(dirname: Optional[str] = None, enable: bool = True):
    """Swap in a fresh cache — and flip ``FLAGS['autotune']`` — for a
    with-block, restoring both on exit (the test/selftest harness,
    mirroring ``faults.scoped``). Yields the scoped TuningCache."""
    from ..flags import FLAGS

    global _cache
    fresh = TuningCache(dirname)
    with _cache_mu:
        prev = _cache
        _cache = fresh
    prev_flag, prev_dir = FLAGS["autotune"], FLAGS["autotune_dir"]
    FLAGS["autotune"] = bool(enable)
    FLAGS["autotune_dir"] = dirname or ""
    try:
        yield fresh
    finally:
        FLAGS["autotune"] = prev_flag
        FLAGS["autotune_dir"] = prev_dir
        # restoring the pre-block snapshot IS the contract: the scoped
        # cache is discarded wholesale, like faults.scoped's plan swap
        # lint: allow-unguarded(_cache)
        with _cache_mu:
            _cache = prev


def tuned_value(tunable_id: str, default: Any = None,
                shape_key: str = "", device: Optional[str] = None,
                count: bool = True) -> Any:
    """Knob read-through on the singleton (see ``flags.effective_flag``):
    cached decision for this device kind, else the hand-set default.
    ``count=False`` for bookkeeping reads that must not inflate the
    hit/miss counters."""
    return get_cache().lookup(tunable_id, shape_key=shape_key,
                              default=default, device=device, count=count)


def _atexit_flush():  # pragma: no cover - exercised via subprocess runs
    with _cache_mu:
        c = _cache
    if c is not None:
        try:
            c.flush()
        except Exception as e:
            _log.warning("tuning-cache atexit flush failed: %s: %s",
                         type(e).__name__, e)


atexit.register(_atexit_flush)
