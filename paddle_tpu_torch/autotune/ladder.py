"""Shape-histogram recorder + bucket-ladder derivation — the
counterpart of ``paddle_tpu/autotune/ladder.py`` (pure Python, copied).

The serving engines pad every batch up to a fixed bucket ladder, so the
set of batch shapes the card sees stays fixed (serving/engine.py). The
ladder SHAPE is a trade: more buckets = less padding waste but more
shapes to warm; bucket POSITIONS decide how much of each padded batch
is waste. The static default (1/2/4/8/16) is right only for traffic
that happens to be geometric — the right ladder is a function of the
observed distribution.

This module closes that loop:

  - ``observe(tunable_id, value)`` — the recorder. The serving submit
    paths call it with every real request's row count (and the decode
    path with its slot demand and prompt length), so any running
    session accumulates the traffic histogram the tuner needs. One dict
    increment under a lock, always on.
  - ``derive_ladder(hist, max_buckets, coverage)`` — a PURE function:
    exact DP over the observed sizes minimizing
    ``expected_padding_waste``, the mean per-request padding fraction —
    the same quantity the ``serving.padding_waste`` histogram measures
    with one-request batches. Sizes above the ``coverage`` (default
    P99) quantile don't get to spend optimization buckets — the top
    bucket still covers the max observed size, so nothing admissible
    today becomes inadmissible under a derived ladder.
  - ``resolve_ladder(tunable_id, default)`` — what ``buckets="auto"``
    / ``slots="auto"`` call at engine LOAD: a cached derived ladder
    for this device kind wins, else derive from the live histogram
    (enough observations), else the static default. Resolution happens
    once, before ``warm()`` — the ladder is fixed after warm.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

from ..observability import metrics as _metrics

__all__ = ["ShapeHistogram", "observe", "histogram", "histograms",
           "merge_observed", "reset_histograms", "derive_ladder",
           "expected_padding_waste", "percentile_size", "resolve_ladder",
           "seed_cache_from_observed"]

_m_observed = _metrics.counter("autotune.shapes_observed")
_m_derived = _metrics.counter("autotune.ladders_derived")

# DP is O(n^2 k) in DISTINCT sizes: compress pathological histograms
# (ragged NLP lengths) down to this many quantile-thinned sizes first
_MAX_DISTINCT = 512


class ShapeHistogram:
    """Counts of one observed integer shape dimension (request rows,
    slot demand). Thread-safe: observe() is called on request submit
    paths from arbitrary client threads."""

    def __init__(self, name: str):
        self.name = str(name)
        self._mu = threading.Lock()
        self._counts: Dict[int, int] = {}  # guarded-by: _mu
        self._n = 0  # guarded-by: _mu

    def observe(self, value: int):
        v = int(value)
        if v < 1:
            return
        with self._mu:
            self._counts[v] = self._counts.get(v, 0) + 1
            self._n += 1

    def merge(self, counts: Dict[int, int]):
        """Fold a saved histogram in (seeding from a bench artifact)."""
        with self._mu:
            for v, c in counts.items():
                v, c = int(v), int(c)
                if v >= 1 and c > 0:
                    self._counts[v] = self._counts.get(v, 0) + c
                    self._n += c

    def total(self) -> int:
        with self._mu:
            return self._n

    def snapshot(self) -> Dict[int, int]:
        with self._mu:
            return dict(self._counts)

    def reset(self):
        with self._mu:
            self._counts = {}
            self._n = 0


_hist_mu = threading.Lock()
_hists: Dict[str, ShapeHistogram] = {}  # guarded-by: _hist_mu


def _hist(tunable_id: str) -> ShapeHistogram:
    with _hist_mu:
        h = _hists.get(tunable_id)
        if h is None:
            h = _hists[tunable_id] = ShapeHistogram(tunable_id)
        return h


def observe(tunable_id: str, value: int):
    """Record one observed shape for a tunable (the serving/decode
    submit hook). Cheap and always on — bench sessions double as tuner
    input without any flag flips."""
    _hist(tunable_id).observe(value)
    _m_observed.inc()


def histogram(tunable_id: str) -> Dict[int, int]:
    return _hist(tunable_id).snapshot()


def merge_observed(tunable_id: str, counts: Dict[int, int]):
    """Fold a SAVED histogram (a bench artifact's ``shape_histogram``
    entry — JSON string keys accepted) into the live recorder:
    replaying a previous session's traffic before resolving an "auto"
    ladder, without needing that session's tuning cache."""
    _hist(tunable_id).merge(counts)


def histograms() -> Dict[str, Dict[int, int]]:
    """Every recorded histogram (bench evidence embeds this)."""
    with _hist_mu:
        items = list(_hists.items())
    return {name: h.snapshot() for name, h in items if h.total()}


def reset_histograms():
    with _hist_mu:
        items = list(_hists.values())
    for h in items:
        h.reset()


# -- the pure math -------------------------------------------------------

def percentile_size(hist: Dict[int, int], q: float = 0.99) -> int:
    """Smallest size whose cumulative count reaches ``q`` of the total
    (nearest-rank, like metrics.Histogram)."""
    if not hist:
        raise ValueError("empty histogram")
    total = sum(hist.values())
    acc = 0
    for s in sorted(hist):
        acc += hist[s]
        if acc >= q * total:
            return int(s)
    return int(max(hist))


def expected_padding_waste(hist: Dict[int, int],
                           ladder: Sequence[int]) -> float:
    """Mean per-request padding fraction ``(bucket(s) - s) / bucket(s)``
    over the histogram — exactly what the ``serving.padding_waste``
    histogram records when every batch holds one request (the open-loop
    bench's configuration), so derived-vs-static claims are asserted
    against the SAME quantity the runtime measures. Sizes above the top
    bucket clamp (the engine would have refused them)."""
    from ..serving.engine import bucket_for  # the ONE ladder-lookup rule

    lad = sorted(set(int(b) for b in ladder))
    if not lad or lad[0] < 1:
        raise ValueError(f"bad ladder {ladder!r}")
    num = 0.0
    den = 0
    for s, c in hist.items():
        s, c = int(s), int(c)
        b = bucket_for(lad, s)
        num += c * (max(b - s, 0) / float(b))
        den += c
    return num / den if den else 0.0


def _compress(sizes: List[int], counts: Dict[int, int],
              cap: int) -> List[int]:
    """Quantile-thin distinct sizes to <= cap, always keeping the max
    (rounding a size UP to the next kept size only adds padding the
    derived ladder then accounts for)."""
    if len(sizes) <= cap:
        return sizes
    stride = -(-len(sizes) // cap)
    kept = sizes[stride - 1::stride]
    if kept[-1] != sizes[-1]:
        kept.append(sizes[-1])
    # fold dropped sizes' counts into the next kept size up
    folded: Dict[int, int] = {k: 0 for k in kept}
    ki = 0
    for s in sizes:
        while kept[ki] < s:
            ki += 1
        folded[kept[ki]] += counts[s]
    counts.clear()
    counts.update(folded)
    return kept


def derive_ladder(hist: Dict[int, int], max_buckets: int = 5,
                  coverage: float = 0.99) -> List[int]:
    """Optimal <= ``max_buckets`` bucket ladder for an observed size
    histogram: exact DP minimizing ``expected_padding_waste``.

    Deterministic (pure function of the histogram — two replicas
    derive the same ladder from the same traffic), covers P-``coverage``
    by construction, and waste is monotone non-increasing in
    ``max_buckets`` (the DP minimizes over every budget up to the cap).
    Sizes in the tail above the coverage quantile are excluded from the
    optimization (a single giant outlier must not spend a bucket) but
    the max observed size is still appended as the top bucket, so every
    size that was admissible stays admissible."""
    counts = {int(s): int(c) for s, c in hist.items()
              if int(s) >= 1 and int(c) > 0}
    if not counts:
        raise ValueError("cannot derive a ladder from an empty histogram")
    if not 0.0 < coverage <= 1.0:
        raise ValueError(f"coverage must be in (0, 1], got {coverage}")
    k_total = max(1, int(max_buckets))
    top = max(counts)
    p_cov = percentile_size(counts, coverage)
    tail = top > p_cov
    if tail and k_total == 1:
        # a budget of ONE bucket with a tail: the only ladder covering
        # everything is [max] — never exceed the documented bound
        return [top]
    # the tail (sizes above the coverage quantile) rides the reserved
    # top bucket; the DP spends the rest of the budget on the body
    body = {s: c for s, c in counts.items() if s <= p_cov}
    k = k_total - (1 if tail else 0)

    sizes = sorted(body)
    sizes = _compress(sizes, body, _MAX_DISTINCT)
    n = len(sizes)
    k = min(k, n)
    # prefix sums: cnt[i] = sum counts of sizes[:i]; wsum likewise of
    # count*size — cost(i, j) = padding fraction mass of sizes[i..j]
    # all padded to sizes[j], in O(1)
    cnt = [0] * (n + 1)
    wsum = [0] * (n + 1)
    for i, s in enumerate(sizes):
        cnt[i + 1] = cnt[i] + body[s]
        wsum[i + 1] = wsum[i] + body[s] * s

    def cost(i: int, j: int) -> float:
        # sum_{t=i..j} c_t * (s_j - s_t) / s_j
        c_range = cnt[j + 1] - cnt[i]
        w_range = wsum[j + 1] - wsum[i]
        return c_range - w_range / float(sizes[j])

    INF = float("inf")
    # dp[j] = min waste mass covering sizes[0..j] with the current
    # bucket budget, last bucket exactly sizes[j]; parent for rebuild
    dp = [cost(0, j) for j in range(n)]
    parent = [[-1] * n]
    best_m, best_val = 1, dp[n - 1]
    for m in range(2, k + 1):
        nxt = [INF] * n
        par = [-1] * n
        for j in range(m - 1, n):
            for i in range(m - 2, j):
                v = dp[i] + cost(i + 1, j)
                if v < nxt[j]:
                    nxt[j], par[j] = v, i
        dp = nxt
        parent.append(par)
        if dp[n - 1] < best_val - 1e-12:
            best_m, best_val = m, dp[n - 1]
    # rebuild the best_m-bucket solution
    ladder: List[int] = []
    j = n - 1
    for m in range(best_m, 0, -1):
        ladder.append(sizes[j])
        j = parent[m - 1][j]
    ladder.reverse()
    if tail:
        ladder.append(top)
    return sorted(set(ladder))


# -- resolution ----------------------------------------------------------

def resolve_ladder(tunable_id: str, default: Sequence[int],
                   max_buckets: int = 5, min_observations: int = 32,
                   cache=None) -> List[int]:
    """``buckets="auto"`` / ``slots="auto"`` resolution, at engine load:

      1. a cached derived ladder for this device kind (a previous
         session or a bench seeded it) — counted as a cache hit;
      2. else derive from the LIVE histogram when it holds at least
         ``min_observations`` shapes, store the result (source
         'derived') so the next session skips straight to (1);
      3. else the static ``default`` (the hand-set FLAGS ladder).
    """
    from .cache import get_cache

    c = cache or get_cache()
    cached = c.lookup(tunable_id, shape_key="ladder")
    if cached:
        return sorted(set(int(b) for b in cached))
    h = histogram(tunable_id)
    if sum(h.values()) >= int(min_observations):
        lad = derive_ladder(h, max_buckets=max_buckets)
        c.put(tunable_id, [int(b) for b in lad], shape_key="ladder",
              source="derived",
              extra={"observations": int(sum(h.values())),
                     "expected_waste":
                         round(expected_padding_waste(h, lad), 6)})
        _m_derived.inc()
        return lad
    return sorted(set(int(b) for b in default))


def seed_cache_from_observed(min_observations: int = 32,
                             max_buckets: int = 5, cache=None,
                             flush: bool = True) -> Dict[str, List[int]]:
    """Derive + store a ladder for every histogram with enough
    observations, then flush — run at the END of a bench session (with
    ``PADDLE_TPU_AUTOTUNE_DIR`` set) so the bench's traffic becomes the
    next serving session's ``buckets="auto"`` answer."""
    from .cache import get_cache

    c = cache or get_cache()
    out: Dict[str, List[int]] = {}
    for name, h in histograms().items():
        if sum(h.values()) < int(min_observations):
            continue
        lad = derive_ladder(h, max_buckets=max_buckets)
        c.put(name, [int(b) for b in lad], shape_key="ladder",
              source="derived",
              extra={"observations": int(sum(h.values()))})
        _m_derived.inc()
        out[name] = lad
    if flush and out:
        c.flush()
    return out
