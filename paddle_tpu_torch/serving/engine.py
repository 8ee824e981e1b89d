"""InferenceEngine — shape-bucketed dynamic batching over one loaded model,
and the static bucket ladders shared by the serving engines. The
counterpart of ``paddle_tpu/serving/engine.py``.

An online server sees arbitrary arrival patterns. The engine drains its
request queue into batches padded up to a fixed BUCKET LADDER (e.g.
1/2/4/8/16), runs the model once per batch, and slices the padded rows
back off the outputs before requests are answered. In the JAX package
the ladder bounds the XLA compile cache; in the port the executor runs
eagerly and compiles nothing, but the ladder still fixes the set of
batch shapes the card sees (``warm`` runs each once at load, so a broken
model fails there) and lets many small requests share one launch of
every kernel.

Mechanics:

  - Requests enter a bounded queue (`submit`); past `max_queue` depth
    the engine raises ServerOverloaded IMMEDIATELY — admission control,
    not unbounded latency.
  - One scheduler thread groups queued requests by shape key (the
    per-feed trailing dims + dtype), closes a batch when the largest
    bucket is covered or the OLDEST member has waited `max_wait_ms`
    (the batching timer: latency bound under trickle traffic), pads to
    the smallest bucket >= total rows with copies of the first row, runs
    the model, and slices the per-request row ranges back out.
  - Every request may carry a deadline; lapsed requests are answered
    with DeadlineExceeded (counted in `serving.deadline_misses`) instead
    of burning compute that nobody is waiting for.
  - `stop(drain=True)` refuses new work but completes everything queued
    — the hot-swap path (registry.py) relies on this to retire an old
    version with zero dropped requests. After the scheduler exits, the
    engine drops its Program/Scope/Executor refs, so the old version's
    parameters on the card are freed.

One load path: `from_inference_dir` loads a pruned Program through
`load_inference_model` into a PRIVATE Executor + Scope on the engine's
device (the card unless the caller names the CPU). `from_exported_dir`
raises a typed ServingError: an exported artifact is JAX StableHLO.
``buckets="auto"`` resolves at load through the autotune layer
(``autotune/ladder.py``), fed by the row count every request records at
admission.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..autotune.ladder import observe as _observe_shape
from ..flags import FLAGS
from ..observability import metrics as _metrics, tracing as _tracing
from ..observability.log import get_logger
from .errors import (DeadlineExceeded, EngineRetired, RequestTooLarge,
                     ServerOverloaded, ServingError)

__all__ = ["InferenceEngine", "bucket_for", "parse_buckets",
           "default_buckets", "resolve_bucket_spec"]

_log = get_logger("serving")

# latency decomposition: where a request's time actually went.
# queue_wait = admission -> dequeued into a batch; batch_assemble = host
# concat+pad; compute = the model run (feeds to the card, the eager op
# loop, fetches back); total = admission -> response ready.
_m_queue_wait = _metrics.histogram("serving.queue_wait_ms")
_m_assemble = _metrics.histogram("serving.batch_assemble_ms")
_m_compute = _metrics.histogram("serving.compute_ms")
_m_total = _metrics.histogram("serving.total_ms")
# batching effectiveness: realized rows per batch, and the fraction of
# each padded batch that was padding (wasted compute)
_m_batch_size = _metrics.histogram("serving.batch_size")
_m_pad_waste = _metrics.histogram("serving.padding_waste")
_m_requests = _metrics.counter("serving.requests")
_m_batches = _metrics.counter("serving.batches")
_m_overloads = _metrics.counter("serving.overloads")
_m_deadline_miss = _metrics.counter("serving.deadline_misses")

# the hand-set geometric ladder — the cold-cache fallback when "auto"
# has nothing observed and nothing cached (matches the FLAGS default)
_STATIC_BUCKETS = "1,2,4,8,16"


def default_buckets() -> List[int]:
    return resolve_bucket_spec(FLAGS["serving_buckets"])


def _is_auto(spec) -> bool:
    return isinstance(spec, str) and spec.strip().lower() == "auto"


def resolve_bucket_spec(spec, *, tunable_id: str = "serving_buckets",
                        fallback: str = _STATIC_BUCKETS) -> List[int]:
    """``"auto"`` resolves through the tuner: a cached derived ladder
    for this device kind, else a ladder derived from the observed
    request-shape histogram, else the static default — the operator's
    FLAGS ladder when one is set (``tunable_id`` doubles as the FLAGS
    key), the shipped ``fallback`` otherwise. Anything else parses as a
    literal ladder. Resolution happens ONCE, at engine load (before
    ``warm()``) — the ladder is fixed after warm."""
    if _is_auto(spec):
        from ..autotune.ladder import resolve_ladder

        flag_val = FLAGS.get(tunable_id, fallback)
        base = fallback if _is_auto(flag_val) else flag_val
        return resolve_ladder(tunable_id, default=parse_buckets(base))
    return parse_buckets(spec)


def parse_buckets(spec) -> List[int]:
    """'1,2,4,8' (or an int sequence) -> sorted unique positive ladder."""
    if isinstance(spec, str):
        vals = [int(p) for p in spec.replace(";", ",").split(",") if p.strip()]
    else:
        vals = [int(v) for v in spec]
    vals = sorted(set(vals))
    if not vals or vals[0] < 1:
        raise ValueError(f"bucket ladder must be positive ints, got {spec!r}")
    return vals


def bucket_for(ladder: Sequence[int], n: int) -> int:
    """Smallest ladder entry >= n, clamped to the top bucket. The one
    bucket-selection rule for every engine in serving/ — admission
    bounds elsewhere keep n <= ladder[-1], so the clamp is defensive."""
    for b in ladder:
        if n <= b:
            return b
    return ladder[-1]


class _FeedSpec:
    """What the engine knows about one feed: trailing dims (-1 = free)
    and dtype. Requests are validated against it at ADMISSION (a shape
    mismatch fails fast with the feed named) and conformed to the dtype
    at admission (a float64 array from a sloppy client must not change
    the batch's dtype)."""

    __slots__ = ("name", "inner", "dtype")

    def __init__(self, name: str, inner: Tuple[int, ...], dtype: np.dtype):
        self.name = name
        self.inner = inner
        self.dtype = np.dtype(dtype)

    def check(self, arr: np.ndarray):
        if arr.ndim != len(self.inner) + 1:
            raise ValueError(
                f"feed '{self.name}' must be batched with "
                f"{len(self.inner) + 1} dims (batch first), got shape "
                f"{tuple(arr.shape)}")
        for want, got in zip(self.inner, arr.shape[1:]):
            if want != -1 and want != got:
                raise ValueError(
                    f"feed '{self.name}' expects trailing dims "
                    f"{self.inner}, got {tuple(arr.shape[1:])}")


class _Request:
    __slots__ = ("feeds", "rows", "key", "t_enq", "deadline", "ev",
                 "result", "error", "t_deq", "trace_ctx")

    def __init__(self, feeds, rows, key, deadline):
        self.feeds = feeds
        self.rows = rows
        self.key = key
        self.t_enq = time.monotonic()
        self.deadline = deadline  # absolute monotonic, or None
        self.ev = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.t_deq = 0.0
        # submitting thread's span context (None when tracing is off):
        # the scheduler adopts it so the batch span joins the request's
        # trace — a merged timeline reads client -> server -> engine
        self.trace_ctx = _tracing.wire_context()

    def fail(self, err: BaseException):
        self.error = err
        self.ev.set()


class InferenceEngine:
    """One loaded model version behind a batching scheduler thread."""

    def __init__(self, runner: Callable[[Dict[str, np.ndarray], int],
                                        List[np.ndarray]],
                 feed_specs: Sequence[_FeedSpec], fetch_names: Sequence[str],
                 *, fetch_batched: Sequence[bool],
                 name: str = "model", version: int = 1,
                 buckets: Optional[Sequence[int]] = None,
                 max_queue: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 kind: str = "program",
                 program=None, scope=None, executor=None):
        from ..flags import FLAGS

        self.name = str(name)
        self.version = int(version)
        self.kind = kind
        self._specs = list(feed_specs)
        self._feed_names = [s.name for s in self._specs]
        self._fetch_names = list(fetch_names)
        # which outputs are per-row (sliced back to each request) vs
        # whole (returned to every request): decided from the DECLARED
        # fetch-var shapes — a weight fetch whose first dim coincidentally
        # equals a bucket must never be mis-sliced.
        self._fetch_batched = list(fetch_batched)
        if len(self._fetch_batched) != len(self._fetch_names):
            raise ValueError(
                f"fetch_batched has {len(self._fetch_batched)} entries for "
                f"{len(self._fetch_names)} fetches")
        self._buckets = resolve_bucket_spec(buckets) \
            if buckets is not None else default_buckets()
        self._max_batch = self._buckets[-1]
        self._max_queue = int(FLAGS["serving_max_queue"]
                              if max_queue is None
                              else max_queue)  # guarded-by: _cond
        self._max_wait = float(FLAGS["serving_max_wait_ms"]
                               if max_wait_ms is None else max_wait_ms) / 1e3
        # refs the release path drops. All _cond-guarded: stop() drops
        # them, warm()/the scheduler snapshot them under the lock.
        self._program = program  # guarded-by: _cond
        self._scope = scope  # guarded-by: _cond
        self._executor = executor  # guarded-by: _cond
        self._runner: Optional[Callable] = runner  # guarded-by: _cond
        self._cond = threading.Condition()
        self._queue: List[_Request] = []  # guarded-by: _cond
        self._stopping = False  # guarded-by: _cond
        self._released = False  # guarded-by: _cond
        self._n_requests = 0  # guarded-by: _cond
        self._n_batches = 0  # guarded-by: _cond
        # keyed by name AND version: during a hot-swap the draining old
        # engine and the live new one both report depth — sharing one
        # gauge would let the old engine's final 0 clobber the live
        # engine's real (possibly climbing) depth
        self._g_depth = _metrics.gauge(
            f"serving.queue_depth.{self.name}.v{self.version}")
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"serving-{self.name}-v{self.version}")
        self._thread.start()

    # -- construction -----------------------------------------------------
    @classmethod
    def from_inference_dir(cls, dirname: str, *, name: str = "model",
                           version: int = 1,
                           buckets: Optional[Sequence[int]] = None,
                           max_queue: Optional[int] = None,
                           max_wait_ms: Optional[float] = None,
                           warm: bool = True,
                           device=None) -> "InferenceEngine":
        """Load a `save_inference_model` directory into a private
        Executor/Scope on ``device`` (``None`` = the card, or a raise)
        and (by default) run every ladder entry once."""
        from ..fluid import io as _io
        from ..fluid.executor import Executor, Scope

        scope = Scope()
        exe = Executor(device)
        program, feed_names, fetch_vars = _io.load_inference_model(
            dirname, exe, scope=scope)
        block = program.global_block()
        specs = []
        for n in feed_names:
            var = block.var(n)
            inner = tuple(-1 if (d is None or int(d) < 0) else int(d)
                          for d in (var.shape or [-1])[1:])
            specs.append(_FeedSpec(n, inner, np.dtype(str(var.dtype))))
        fetch_names = [v.name for v in fetch_vars]
        # per-row iff the declared leading dim is the free batch dim; a
        # fetch with a CONSTANT leading dim (a weight, a reduced stat)
        # is returned whole to every request, never sliced — even if its
        # size coincides with a bucket. Batch-REDUCED fetches see the
        # padded+co-batched rows; serve per-row outputs and reduce
        # client-side if exact reduction semantics matter.
        fetch_batched = [
            v.shape is not None and len(v.shape) >= 1
            and (v.shape[0] is None or int(v.shape[0]) < 0)
            for v in fetch_vars
        ]

        def runner(feeds: Dict[str, np.ndarray], bucket: int):
            return exe.run(program, feed=feeds, fetch_list=fetch_names,
                           scope=scope)

        eng = cls(runner, specs, fetch_names, name=name, version=version,
                  buckets=buckets, max_queue=max_queue,
                  max_wait_ms=max_wait_ms, kind="program",
                  fetch_batched=fetch_batched,
                  program=program, scope=scope, executor=exe)
        if warm:
            try:
                eng.warm()
            except BaseException:
                # the constructor already started the scheduler thread;
                # a failed warmup (the registry's ROLLBACK path) must
                # not leak it — or the Program/Scope/Executor it pins
                eng.stop(drain=False)
                raise
        return eng

    @classmethod
    def from_exported_dir(cls, dirname: str, **kwargs) -> "InferenceEngine":
        """The JAX package loads an `export_compiled_model` StableHLO
        artifact here; that artifact is JAX's, so the port refuses it."""
        raise ServingError(
            f"'{dirname}': an exported (StableHLO) artifact is JAX's and "
            "paddle_tpu_torch cannot run it — serve the "
            "save_inference_model directory instead")

    # -- public surface ---------------------------------------------------
    @property
    def buckets(self) -> List[int]:
        return list(self._buckets)

    @property
    def program(self):
        """The loaded inference Program (None after release) — exposed so
        lifecycle tests can weakref it."""
        with self._cond:  # _program is _cond-guarded (stop() drops it)
            return self._program

    def warm(self):
        """One synthetic batch per ladder entry: a broken model fails at
        LOAD time, where the registry can still roll back, and every
        batch shape has run once before live traffic. Free (-1) trailing
        dims warm at 1."""
        with self._cond:  # snapshot under the runner's guard
            runner = self._runner
        if runner is None:
            raise EngineRetired(f"model '{self.name}' released")
        with _tracing.span("serving.warmup", model=self.name,
                           version=self.version):
            for b in self._buckets:
                feeds = {
                    s.name: np.zeros(
                        (b,) + tuple(1 if d == -1 else d for d in s.inner),
                        dtype=s.dtype)
                    for s in self._specs
                }
                runner(feeds, b)

    def submit(self, feeds: Dict[str, Any],
               deadline_ms: Optional[float] = None) -> _Request:
        """Validate + enqueue. Raises ServerOverloaded / RequestTooLarge /
        EngineRetired / ValueError synchronously — admission is where
        structured rejection happens."""
        arrs: Dict[str, np.ndarray] = {}
        rows = None
        for spec in self._specs:
            if spec.name not in feeds:
                raise ValueError(
                    f"model '{self.name}' requires feed '{spec.name}' "
                    f"(wants {self._feed_names})")
            a = np.asarray(feeds[spec.name])
            spec.check(a)
            if a.dtype != spec.dtype:
                a = a.astype(spec.dtype)  # keep the batch dtype canonical
            if rows is None:
                rows = int(a.shape[0])
            elif int(a.shape[0]) != rows:
                raise ValueError(
                    f"inconsistent batch dims across feeds: "
                    f"'{spec.name}' has {a.shape[0]} rows, expected {rows}")
            arrs[spec.name] = a
        if not rows:
            raise ValueError("empty request (zero rows)")
        # the tuner's shape recorder: every VALID request's row count —
        # including ones the incumbent ladder is about to refuse, or a
        # future auto-derived ladder could never learn to grow past the
        # current top bucket; deliberately outside the engine lock
        _observe_shape("serving_buckets", rows)
        if rows > self._max_batch:
            raise RequestTooLarge(
                f"request of {rows} rows exceeds model '{self.name}' "
                f"largest bucket {self._max_batch} — shard it client-side")
        key = tuple((s.name, arrs[s.name].shape[1:], str(s.dtype))
                    for s in self._specs)
        deadline = (None if deadline_ms is None
                    else time.monotonic() + float(deadline_ms) / 1e3)
        req = _Request(arrs, rows, key, deadline)
        with self._cond:
            if self._stopping:
                raise EngineRetired(
                    f"model '{self.name}' v{self.version} is retiring")
            if len(self._queue) >= self._max_queue:
                _m_overloads.inc()
                raise ServerOverloaded(
                    f"model '{self.name}' queue is full "
                    f"({self._max_queue} deep) — retry later or shed load")
            self._queue.append(req)
            self._n_requests += 1
            self._g_depth.set(len(self._queue))
            self._cond.notify()
        _m_requests.inc()
        return req

    def infer(self, feeds: Dict[str, Any],
              deadline_ms: Optional[float] = None,
              timeout: float = 120.0) -> Tuple[List[np.ndarray], int]:
        """Blocking convenience: submit + wait. Returns (outputs,
        version)."""
        req = self.submit(feeds, deadline_ms=deadline_ms)
        if not req.ev.wait(timeout):
            raise ServingError(
                f"infer on '{self.name}' timed out after {timeout}s "
                "(scheduler wedged?)")
        if req.error is not None:
            raise req.error
        return req.result, self.version

    def stop(self, drain: bool = True, timeout: float = 120.0):
        """Refuse new work; `drain` completes the queue first, else the
        queue is failed with EngineRetired. Then the scheduler exits and
        every model ref (Program/Scope/Executor/runner) is dropped, so
        the version's parameters are freed."""
        with self._cond:
            self._stopping = True
            if not drain:
                for r in self._queue:
                    r.fail(EngineRetired(
                        f"model '{self.name}' v{self.version} unloaded"))
                self._queue.clear()
                self._g_depth.set(0)
            self._cond.notify_all()
        self._thread.join(timeout)
        if self._thread.is_alive():  # pragma: no cover - wedged scheduler
            _log.error("serving scheduler for %s v%d did not exit in %.0fs",
                       self.name, self.version, timeout)
        with self._cond:
            self._program = None
            self._scope = None
            self._executor = None
            self._runner = None
            self._released = True
            self._g_depth.set(0)  # a retired version holds no queue

    def stats(self) -> Dict[str, Any]:
        with self._cond:
            return {
                "name": self.name,
                "version": self.version,
                "kind": self.kind,
                "buckets": list(self._buckets),
                "feeds": self._feed_names,
                "fetches": list(self._fetch_names),
                "queue_depth": len(self._queue),
                "max_queue": self._max_queue,
                "max_wait_ms": self._max_wait * 1e3,
                "requests": self._n_requests,
                "batches": self._n_batches,
                "stopping": self._stopping,
            }

    # -- scheduler --------------------------------------------------------
    def _bucket_for(self, rows: int) -> int:
        return bucket_for(self._buckets, rows)

    def _loop(self):
        while True:
            batch = self._next_batch()
            if batch is None:
                return
            try:
                self._run_batch(batch)
            except BaseException as e:  # a broken batch fails ITS requests
                _log.error("serving batch on %s v%d failed: %s: %s",
                           self.name, self.version, type(e).__name__, e)
                for r in batch:
                    if r.ev.is_set():
                        # already answered (e.g. failed DeadlineExceeded
                        # before the runner ran) — never overwrite an
                        # error a waiter may already be reading
                        continue
                    r.fail(e if isinstance(e, ServingError)
                           else ServingError(f"{type(e).__name__}: {e}"))

    def _drop_expired_locked(self, now: float):
        keep = []
        for r in self._queue:
            if r.deadline is not None and now > r.deadline:
                _m_deadline_miss.inc()
                r.fail(DeadlineExceeded(
                    f"request to '{self.name}' missed its deadline while "
                    "queued"))
            else:
                keep.append(r)
        if len(keep) != len(self._queue):
            self._queue[:] = keep
            self._g_depth.set(len(keep))

    def _next_batch(self) -> Optional[List[_Request]]:
        # lint: allow-blocking — Condition.wait on the engine's own
        # condition is the scheduler's idle state by design
        with self._cond:
            while True:
                self._drop_expired_locked(time.monotonic())
                if not self._queue:
                    if self._stopping:
                        return None
                    self._cond.wait(0.1)
                    continue
                head = self._queue[0]
                avail = sum(r.rows for r in self._queue if r.key == head.key)
                waited = time.monotonic() - head.t_enq
                if (avail >= self._max_batch or waited >= self._max_wait
                        or self._stopping):
                    return self._pop_batch_locked(head.key)
                # batching timer: sleep only until the head's window
                # closes (capped so fresh arrivals re-evaluate promptly)
                self._cond.wait(min(self._max_wait - waited, 0.05))

    def _pop_batch_locked(self, key) -> List[_Request]:
        batch: List[_Request] = []
        rows = 0
        rest: List[_Request] = []
        now = time.monotonic()
        for r in self._queue:
            if r.key == key and rows + r.rows <= self._max_batch:
                r.t_deq = now
                batch.append(r)
                rows += r.rows
            else:
                rest.append(r)
        self._queue[:] = rest
        self._g_depth.set(len(rest))
        return batch

    def _run_batch(self, batch: List[_Request]):
        now = time.monotonic()
        live = []
        for r in batch:
            if r.deadline is not None and now > r.deadline:
                _m_deadline_miss.inc()
                r.fail(DeadlineExceeded(
                    f"request to '{self.name}' missed its deadline while "
                    "queued"))
            else:
                live.append(r)
        if not live:
            return
        rows = sum(r.rows for r in live)
        bucket = self._bucket_for(rows)
        t0 = time.perf_counter()
        feeds: Dict[str, np.ndarray] = {}
        for spec in self._specs:
            parts = [r.feeds[spec.name] for r in live]
            if bucket > rows:
                # pad with copies of the first row: always-valid data (an
                # all-zeros pad can NaN models with normalizing ops), and
                # the padded rows are sliced off before anyone sees them
                pad = np.broadcast_to(
                    parts[0][:1], (bucket - rows,) + parts[0].shape[1:])
                parts = parts + [pad]
            feeds[spec.name] = (parts[0] if len(parts) == 1
                                else np.concatenate(parts, axis=0))
        t1 = time.perf_counter()
        with self._cond:  # snapshot the runner under ITS guard
            runner = self._runner
            if runner is not None:
                self._n_batches += 1
        if runner is None:  # pragma: no cover - stop() raced a late batch
            for r in live:
                r.fail(EngineRetired(f"model '{self.name}' released"))
            return
        # adopt the batch-TRIGGERING (oldest) request's context: a span
        # has one parent, so the batch joins the head request's trace
        with _tracing.adopt(live[0].trace_ctx), \
                _tracing.span("serving.batch", model=self.name,
                              version=self.version, bucket=bucket,
                              rows=rows, requests=len(live)):
            outputs = [np.asarray(o) for o in runner(feeds, bucket)]
        t2 = time.perf_counter()
        _m_batches.inc()
        _m_batch_size.observe(rows)
        _m_pad_waste.observe((bucket - rows) / float(bucket))
        _m_assemble.observe((t1 - t0) * 1e3)
        _m_compute.observe((t2 - t1) * 1e3)
        end = time.monotonic()
        off = 0
        for r in live:
            sliced = []
            for batched, o in zip(self._fetch_batched, outputs):
                sliced.append(o[off:off + r.rows]
                              if (batched and o.ndim >= 1
                                  and o.shape[0] == bucket) else o)
            off += r.rows
            if r.deadline is not None and end > r.deadline:
                _m_deadline_miss.inc()
                r.fail(DeadlineExceeded(
                    f"request to '{self.name}' finished after its "
                    "deadline"))
                continue
            r.result = sliced
            _m_queue_wait.observe((r.t_deq - r.t_enq) * 1e3)
            _m_total.observe((end - r.t_enq) * 1e3)
            r.ev.set()
