"""Process-wide metrics registry: counters, gauges, and histograms with
p50/p95/p99, exportable as a dict snapshot or Prometheus text format.

Unlike tracing, metrics are ALWAYS on — a counter increment is an int
add under a per-metric lock, cheap enough for every hot path it guards
(jit cache hits, RPC bytes, pserver pushes). The registry is flat and
name-keyed; `counter(name)` etc. are find-or-create and cache-friendly
(call once at module/instance setup, keep the handle, `.inc()` per
event).

Histogram keeps a bounded reservoir (uniform reservoir sampling past the
cap) so a million RPC latencies cost ~4 KB, while count/sum/min/max stay
exact.
"""
from __future__ import annotations

import random
import threading
from typing import Any, Dict, List, Optional, Union

__all__ = [
    "Counter", "Gauge", "Histogram",
    "counter", "gauge", "histogram",
    "snapshot", "prometheus_text", "reset_metrics", "reset_all",
]

_registry: Dict[str, "_Metric"] = {}  # guarded-by: _registry_mu
_registry_mu = threading.Lock()


def _registered() -> List[tuple]:
    """Consistent (name, metric) snapshot, sorted. Every iterator goes
    through here: iterating the live dict while a find-or-create on
    another thread inserts raises RuntimeError mid-scrape (guards-lint
    finding on snapshot/prometheus_text/reset_metrics)."""
    with _registry_mu:
        return sorted(_registry.items())


def _sanitize(name: str) -> str:
    """Prometheus metric names allow [a-zA-Z0-9_:]; our dotted span-style
    names map dots and dashes to underscores."""
    return "".join(c if (c.isalnum() or c in "_:") else "_" for c in name)


class _Metric:
    kind = "metric"

    def __init__(self, name: str):
        self.name = name
        self._mu = threading.Lock()

    def value(self):
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError

    def prom_lines(self) -> List[str]:
        raise NotImplementedError


class Counter(_Metric):
    """Monotonic event count."""

    kind = "counter"

    def __init__(self, name: str):
        super().__init__(name)
        self._n = 0

    def inc(self, n: int = 1):
        with self._mu:
            self._n += n

    def value(self) -> int:
        return self._n

    def reset(self):
        with self._mu:
            self._n = 0

    def prom_lines(self):
        n = _sanitize(self.name)
        return [f"# TYPE {n} counter", f"{n} {self._n}"]


class Gauge(_Metric):
    """Last-set instantaneous value (records/sec, queue depth, ...)."""

    kind = "gauge"

    def __init__(self, name: str):
        super().__init__(name)
        self._v: float = 0.0

    def set(self, v: float):
        self._v = float(v)  # single store, GIL-atomic

    def add(self, d: float):
        with self._mu:
            self._v += d

    def value(self) -> float:
        return self._v

    def reset(self):
        self._v = 0.0

    def prom_lines(self):
        n = _sanitize(self.name)
        return [f"# TYPE {n} gauge", f"{n} {self._v}"]


class Histogram(_Metric):
    """Observations with exact count/sum/min/max and reservoir-sampled
    percentiles (p50/p95/p99). `reservoir` caps memory; below the cap the
    percentiles are exact."""

    kind = "histogram"

    def __init__(self, name: str, reservoir: int = 2048):
        super().__init__(name)
        self._cap = max(16, int(reservoir))
        self._vals: List[float] = []
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")
        self._rng = random.Random(0xC0FFEE)

    def observe(self, v: float):
        v = float(v)
        with self._mu:
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            if len(self._vals) < self._cap:
                self._vals.append(v)
            else:  # uniform reservoir: each of the N observations has
                # cap/N probability of being retained
                j = self._rng.randrange(self._count)
                if j < self._cap:
                    self._vals[j] = v

    @staticmethod
    def _rank(vals: List[float], q: float) -> float:
        """Nearest-rank percentile over an already-sorted list."""
        rank = max(0, min(len(vals) - 1,
                          int(round(q / 100.0 * (len(vals) - 1)))))
        return vals[rank]

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile over the reservoir, q in [0, 100]."""
        with self._mu:
            vals = sorted(self._vals)
        if not vals:
            return 0.0
        return self._rank(vals, q)

    def value(self) -> Dict[str, float]:
        # one lock hold + one sort for a CONSISTENT stats set (three
        # percentile() calls would sort thrice and could interleave with
        # concurrent observes)
        with self._mu:
            count, total = self._count, self._sum
            mn, mx = self._min, self._max
            vals = sorted(self._vals)
        if count == 0:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "avg": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
        return {
            "count": count,
            "sum": total,
            "min": mn,
            "max": mx,
            "avg": total / count,
            "p50": self._rank(vals, 50),
            "p95": self._rank(vals, 95),
            "p99": self._rank(vals, 99),
        }

    def reset(self):
        with self._mu:
            self._vals = []
            self._count = 0
            self._sum = 0.0
            self._min = float("inf")
            self._max = float("-inf")

    def prom_lines(self):
        n = _sanitize(self.name)
        v = self.value()
        return [
            f"# TYPE {n} summary",
            f'{n}{{quantile="0.5"}} {v["p50"]}',
            f'{n}{{quantile="0.95"}} {v["p95"]}',
            f'{n}{{quantile="0.99"}} {v["p99"]}',
            f"{n}_sum {v['sum']}",
            f"{n}_count {v['count']}",
        ]


def _get(name: str, cls, **kw):
    # lint: allow-unguarded(_registry) — deliberate double-checked read:
    # dict.get is GIL-atomic, a hit avoids the lock on the hot
    # find-or-create path, and a miss re-validates under _registry_mu
    m = _registry.get(name)
    if m is not None:
        if not isinstance(m, cls):
            raise TypeError(
                f"metric '{name}' already registered as {m.kind}, "
                f"requested {cls.kind}")
        return m
    with _registry_mu:
        m = _registry.get(name)
        if m is None:
            m = _registry[name] = cls(name, **kw)
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric '{name}' already registered as {m.kind}, "
                f"requested {cls.kind}")
        return m


def counter(name: str) -> Counter:
    return _get(name, Counter)


def gauge(name: str) -> Gauge:
    return _get(name, Gauge)


def histogram(name: str, reservoir: int = 2048) -> Histogram:
    return _get(name, Histogram, reservoir=reservoir)


def snapshot(prefix: str = "", skip_zero: bool = False) -> Dict[str, Any]:
    """name -> value dict of every registered metric (histograms as their
    stats dict). `prefix` filters; `skip_zero` drops zero counters /
    empty histograms (the compact form BENCH artifacts embed)."""
    out: Dict[str, Any] = {}
    for name, m in _registered():
        if prefix and not name.startswith(prefix):
            continue
        v = m.value()
        if skip_zero:
            if isinstance(v, dict) and not v.get("count"):
                continue
            if not isinstance(v, dict) and not v:
                continue
        out[name] = v
    return out


def prometheus_text() -> str:
    lines: List[str] = []
    for _name, m in _registered():
        lines.extend(m.prom_lines())
    return "\n".join(lines) + ("\n" if lines else "")


def reset_metrics(prefix: str = ""):
    """Zero every metric (or those under `prefix`). Handles stay valid —
    callers keep their cached Counter/Gauge/Histogram objects."""
    for name, m in _registered():
        if prefix and not name.startswith(prefix):
            continue
        m.reset()


def reset_all():
    """Test-isolation helper: zero every registered metric AND the trace
    recorder's buffer/drop counter in one call, so module-level counter
    handles created by an earlier test (or an earlier PROCESS phase)
    can't bleed absolute values into the next test's assertions.
    Registrations survive — only values reset — so cached handles keep
    feeding the same (now-zeroed) metrics. tests/conftest.py runs this
    autouse before every test."""
    reset_metrics()
    from . import tracing

    tracing.trace_reset()
