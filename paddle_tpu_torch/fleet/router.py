"""FleetRouter — capacity-aware client/proxy over N serving replicas
(the counterpart of ``paddle_tpu/fleet/router.py``).

The router composes the fleet into one service: callers say
``router.generate("m", prompt)`` and the router picks a replica, using
the load signal the replicas already expose instead of guessing from
queue depth alone:

  * DECODERS are routed on free KV pages (the *Ragged Paged Attention*
    page-table view of remaining capacity): a replica can admit a
    request iff its free pages cover the worst-case reservation
    ``ceil((prompt + max_new) / page_size)`` AND its queue has room —
    the same two checks DecodeEngine.submit enforces, evaluated
    router-side from the scraped `load_report` so requests land where
    they will be ADMITTED, not where the queue happens to be shortest.
    Among admissible replicas, most-free-pages wins.
  * ONE-SHOT ENGINES are routed on queue headroom (max_queue -
    queue_depth, the admission bound that actually rejects).

Cluster-wide overload semantics: the router sheds — structured
``ServerOverloaded``, `fleet.sheds` counted — ONLY when no replica has
capacity (every replica serving the model reports none, or every
capacity-reporting replica refused when tried; stale scrapes are
retried against the next-best replica first). One busy replica is a
routing decision; all busy replicas is the fleet's admission bound
doing its job.

Failover: a replica that fails at the TRANSPORT level (connection
refused/reset — killed, unreachable) or that answers ``EngineRetired``
past the server's own resubmit budget (deploy storm) is dropped from
the router's table and the request is resubmitted to the next-best
replica (`fleet.failovers`). Retries WITHIN a replica ride the
per-replica ServingClient's `(client_id, seq)` idempotency tokens —
the router keeps one persistent client per (caller thread, replica):
persistent per replica so a retransmit after a lost reply carries the
original token and is answered from that replica's dedup cache instead
of re-executing (`rpc.server.dedup_hits` is the proof; the chaos tests
pin it), and per thread so N callers stay genuinely concurrent
(RpcClient serializes calls on its one connection — a single shared
client per replica would bottleneck the whole fleet's data path to one
in-flight request per replica).
Failover to a DIFFERENT replica re-executes by design — the original
replica is gone, and infer/generate are deterministic functions of
their arguments (seeded sampling included), so a re-execution is
answer-identical.

The router is a client-side library: it holds no server state, and a
controller outage only freezes its view of membership — routing to the
last-known replicas keeps working.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..distributed.rpc import RpcClient
from ..observability import metrics as _metrics, tracing as _tracing
from ..observability.log import get_logger
from ..serving.client import ServingClient, TokenStream
from ..serving.kv_cache import PREFIX_ROOT, chain_digest
from ..serving.errors import (EngineRetired, ModelNotFound,
                              ServerOverloaded, ServingError,
                              StreamExpired)

__all__ = ["FleetRouter", "FleetTokenStream", "NoReplicasError"]

_log = get_logger("fleet")

_m_sheds = _metrics.counter("fleet.sheds")
_m_failovers = _metrics.counter("fleet.failovers")
_m_scrapes = _metrics.counter("fleet.scrapes")
_m_scrape_errors = _metrics.counter("fleet.scrape_errors")
_m_route_ms = _metrics.histogram("fleet.route_ms")
_m_request_ms = _metrics.histogram("fleet.request_ms")
# dispatches that landed on a replica advertising a prefix-cache hit
# for the request's prompt: warm routing means the replica
# prefills only the suffix
_m_routed_warm = _metrics.counter("fleet.routed_warm")
# mid-stream failovers that re-established a token stream on a
# survivor and spliced at the delivered offset
_m_stream_resumes = _metrics.counter("fleet.stream.resumes")
# first-class fleet-wide capacity gauges: what the
# autoscale policy loop sees, exported from the router's scrape view
# so dashboards and the policy agree on the same signal. Totals count
# ROUTABLE capacity only (draining replicas excluded — their pages
# take no new work); replicas_live counts every reachable replica,
# draining included. Zeroed at close() — a closed router's last
# scrape must not linger as live fleet capacity (the N205 class).
_g_free_total = _metrics.gauge("fleet.free_pages_total")
_g_headroom_total = _metrics.gauge("fleet.queue_headroom")
_g_replicas_live = _metrics.gauge("fleet.replicas_live")


class NoReplicasError(ServingError):
    """No live replica is registered (or reachable) for the fleet —
    distinct from ServerOverloaded (replicas exist but none has
    capacity) because the operator responses differ: scale up vs
    find out why the fleet is empty."""


def _pages_for(tokens: int, page_size: int) -> int:
    return max(1, -(-int(tokens) // max(1, int(page_size))))


class FleetRouter:
    """Routes infer/generate over the controller's live replica set."""

    def __init__(self, controller_addr, scrape_ttl: Optional[float] = None,
                 replica_ttl: float = 2.0, timeout: float = 180.0,
                 retries: int = 3):
        from ..flags import FLAGS

        self._scrape_ttl = float(FLAGS["fleet_scrape_ttl"]
                                 if scrape_ttl is None else scrape_ttl)
        # how long the discovered replica table may serve routing
        # decisions before re-asking the controller
        self._replica_ttl = float(replica_ttl)
        self._timeout = float(timeout)
        self._retries = int(retries)
        self._ctl = RpcClient(controller_addr, timeout=min(timeout, 30.0),
                              retries=retries)
        self._mu = threading.Lock()
        self._replicas: Dict[str, Tuple[str, int]] = {}  # guarded-by: _mu
        self._replicas_at = 0.0  # guarded-by: _mu
        # replicas the policy is draining: in the table (in-flight work
        # and streams continue) but taken out of NEW-request ranking
        self._draining: set = set()  # guarded-by: _mu
        # per-THREAD per-replica persistent clients. Per-replica
        # persistence is what makes same-replica retransmits ride the
        # original (client_id, seq) and get dedup-answered; per-THREAD
        # is what keeps N callers genuinely concurrent — RpcClient
        # serializes calls on its one connection, so a single shared
        # client per replica would collapse the whole fleet data path
        # to one in-flight request per replica.
        self._tl = threading.local()
        # every client ever minted, per rid — for close(); guarded-by: _mu
        self._all_clients: Dict[str, list] = {}  # guarded-by: _mu
        # rid -> (scraped_at, report) load cache
        self._loads: Dict[str, Tuple[float, Dict]] = {}  # guarded-by: _mu
        # concurrent-scrape pool (built on first multi-replica miss)
        self._pool = None  # guarded-by: _mu
        # per-replica routed counters + scraped-load gauges, zeroed when
        # the replica leaves the table (eviction/death) so a dead
        # replica's last free-page count can't linger as live capacity
        self._routed: Dict[str, Any] = {}  # guarded-by: _mu
        self._load_gauges: Dict[str, Tuple[Any, Any]] = {}  # guarded-by: _mu

    # -- discovery --------------------------------------------------------
    def refresh(self, force: bool = False) -> Dict[str, Tuple[str, int]]:
        """Refresh the replica table from the controller (cached for
        replica_ttl). Replicas that vanished (evicted/deregistered) get
        their router-side gauges zeroed and their cached client/load
        dropped."""
        now = time.monotonic()
        with self._mu:
            # an EMPTY table is cached too: during an empty-fleet storm
            # every routed request would otherwise re-ask the
            # controller multiple times per call — hammering it exactly
            # while the operator is reviving the fleet
            if not force and self._replicas_at > 0.0 and \
                    now - self._replicas_at < self._replica_ttl:
                return dict(self._replicas)
        try:
            listed = self._ctl.call("list_replicas")
        except (ConnectionError, OSError, RuntimeError) as e:
            # controller unreachable: keep routing on the last table
            _log.warning("fleet router: controller unreachable (%s); "
                         "using cached replica table", e)
            with self._mu:
                return dict(self._replicas)
        table = {str(rid): (str(st["endpoint"][0]), int(st["endpoint"][1]))
                 for rid, st in listed.items()}
        draining = {str(rid) for rid, st in listed.items()
                    if st.get("draining")}
        # not a lost-update risk: the controller response is the whole
        # truth (last refresh wins wholesale), and the staleness read
        # above only decides WHETHER to ask — never what to write
        # lint: allow-unguarded(_replicas, _replicas_at)
        with self._mu:
            gone = set(self._replicas) - set(table)
            for rid in gone:
                self._drop_replica_locked(rid)
            self._replicas = table
            self._draining = draining
            self._replicas_at = now
            return dict(self._replicas)

    def _drop_replica_locked(self, rid: str):
        """Forget a replica. Its clients are UNTRACKED, not closed:
        RpcClient.close() takes the client's own call lock, and another
        thread may be parked mid-call on that very lock (its request
        dying with the replica) — closing here would block the router
        lock behind that thread's timeout. Each thread's next use of a
        stale client fails fast (dead peer) or reconnects; the fds die
        with the objects."""
        self._loads.pop(rid, None)
        self._all_clients.pop(rid, None)
        gauges = self._load_gauges.pop(rid, None)
        if gauges is not None:
            for g in gauges:
                g.set(0)

    def _client(self, rid: str, ep: Tuple[str, int]) -> ServingClient:
        """This thread's persistent client for `rid` (minted on first
        use, re-minted if the replica's endpoint changed — a rejoined
        replica may listen elsewhere)."""
        cache = getattr(self._tl, "clients", None)
        if cache is None:
            cache = self._tl.clients = {}
        ent = cache.get(rid)
        if ent is not None and ent[0] == ep:
            return ent[1]
        cli = ServingClient(ep, timeout=self._timeout,
                            retries=self._retries)
        cache[rid] = (ep, cli)
        with self._mu:
            self._all_clients.setdefault(rid, []).append(cli)
        return cli

    # -- load scraping ----------------------------------------------------
    def _load(self, rid: str, ep: Tuple[str, int]) -> Optional[Dict]:
        """This replica's load_report, cached for scrape_ttl. None =
        unreachable (treated as no-capacity AND no-failover-target).
        The RPC runs outside _mu — a slow replica must not stall other
        threads' routing decisions on the router lock."""
        now = time.monotonic()
        with self._mu:
            ent = self._loads.get(rid)
            if ent is not None and now - ent[0] < self._scrape_ttl:
                return ent[1]
        cli = self._client(rid, ep)
        try:
            report = cli.load_report()
            _m_scrapes.inc()
        except (ConnectionError, OSError, RuntimeError):
            _m_scrape_errors.inc()
            self._invalidate_load(rid)
            return None
        # not a lost-update risk: a load-cache entry is a timestamped
        # snapshot and the freshest writer winning is the DESIRED
        # outcome; the read above only decides whether to re-scrape
        # lint: allow-unguarded(_loads)
        with self._mu:
            self._loads[rid] = (time.monotonic(), report)
            gauges = self._load_gauges.get(rid)
            if gauges is None:
                gauges = self._load_gauges[rid] = (
                    _metrics.gauge(f"fleet.replica_free_pages.{rid}"),
                    _metrics.gauge(f"fleet.replica_queue_depth.{rid}"))
            free_pages = sum(m.get("free_pages", 0)
                             for m in report["models"].values())
            depth = sum(m.get("queue_depth", 0)
                        for m in report["models"].values())
            gauges[0].set(free_pages)
            gauges[1].set(depth)
        return report

    def _loads_for(self, items) -> Dict[str, Dict]:
        """Load reports for a list of (rid, ep), scraping CACHE MISSES
        concurrently: after each scrape-TTL expiry one unlucky request
        would otherwise pay N serial load_report round trips — plus a
        blocking failed connect for any dead-but-not-yet-evicted
        replica — before it could dispatch. Cache hits never spawn."""
        now = time.monotonic()
        out: Dict[str, Dict] = {}
        missing: List[Tuple[str, Tuple[str, int]]] = []
        with self._mu:
            for rid, ep in items:
                ent = self._loads.get(rid)
                if ent is not None and now - ent[0] < self._scrape_ttl:
                    out[rid] = ent[1]
                else:
                    missing.append((rid, ep))
        if len(missing) <= 1:
            for rid, ep in missing:
                report = self._load(rid, ep)
                if report is not None:
                    out[rid] = report
            return out
        for (rid, _ep), report in zip(
                missing, self._scrape_pool().map(
                    lambda it: self._load(it[0], it[1]), missing)):
            if report is not None:
                out[rid] = report
        return out

    def _scrape_pool(self):
        # lazily-built, persistent (pool threads keep their per-thread
        # clients warm across scrapes); bounded so a big fleet can't
        # fan a single routing decision into unbounded threads
        with self._mu:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(
                    max_workers=4, thread_name_prefix="fleet-scrape")
            return self._pool

    def _invalidate_load(self, rid: str):
        with self._mu:
            self._loads.pop(rid, None)

    # -- routing core -----------------------------------------------------
    @staticmethod
    def _prefix_warm(m: Dict[str, Any],
                     prompt: Optional[Sequence[int]]) -> bool:
        """Does this replica's advertised prefix cache cover (at least
        the first full page of) the request's prompt? The router
        computes the SAME chained content digest the replica's index
        keys on — page_size comes from the replica's report, so
        heterogeneous fleets hash apples to apples."""
        pc = m.get("prefix_cache")
        if not prompt or not pc or not pc.get("roots"):
            return False
        ps = int(pc.get("page_size") or m.get("page_size") or 0)
        # a cached full page is only usable when the prompt extends
        # past it (the last prompt token always recomputes)
        if ps < 1 or len(prompt) <= ps:
            return False
        return chain_digest(PREFIX_ROOT, prompt[:ps]) in pc["roots"]

    def _candidates(self, model: str, need_tokens: Optional[int],
                    prompt: Optional[Sequence[int]] = None
                    ) -> Tuple[List[Tuple[str, Tuple[str, int], bool]],
                               int, int]:
        """Rank replicas for one request. Returns (ranked admissible
        candidates best-first as (rid, ep, warm), #replicas serving the
        model, #replicas reachable). Admissibility mirrors the
        replica's own admission checks so the router sheds exactly when
        the fleet would refuse. Among admissible decoders a replica
        whose prefix cache covers the request's prompt wins outright
        (it prefills only the suffix); free KV pages break
        warmth ties, queue headroom breaks those."""
        table = self.refresh()
        with self._mu:
            draining = set(self._draining)
        scored: List[Tuple[float, str, Tuple[str, int], bool]] = []
        serving_model = 0
        reachable = 0
        free_total = 0
        headroom_total = 0
        reports = self._loads_for(sorted(table.items()))
        for rid, ep in sorted(table.items()):
            report = reports.get(rid)
            if report is None:
                continue
            reachable += 1
            if rid in draining:
                # draining (policy scale-down in progress): in-flight
                # work finishes, but NO new requests — and its pages
                # are not routable capacity
                continue
            for mm in report["models"].values():
                free_total += int(mm.get("free_pages", 0))
                headroom_total += max(
                    0, int(mm.get("max_queue", 0))
                    - int(mm.get("queue_depth", 0)))
            m = report["models"].get(model)
            if m is None or m.get("stopping"):
                continue
            serving_model += 1
            if m["queue_depth"] >= m["max_queue"]:
                continue  # admission queue full: would be refused
            warm = False
            if m["kind"] == "decoder":
                if need_tokens is not None:
                    need = _pages_for(need_tokens, m["page_size"])
                    if m["free_pages"] < need:
                        continue  # page pool short: would be refused
                warm = self._prefix_warm(m, prompt)
                # cache warmth first, then most free KV pages, then
                # queue headroom
                score = ((1e12 if warm else 0.0) + m["free_pages"] * 1e6
                         + (m["max_queue"] - m["queue_depth"]))
            else:
                score = float(m["max_queue"] - m["queue_depth"])
            scored.append((score, rid, ep, warm))
        _g_free_total.set(free_total)
        _g_headroom_total.set(headroom_total)
        _g_replicas_live.set(reachable)
        scored.sort(key=lambda s: (-s[0], s[1]))
        return ([(rid, ep, warm) for _s, rid, ep, warm in scored],
                serving_model, reachable)

    def _route(self, model: str, need_tokens: Optional[int], call,
               prompt: Optional[Sequence[int]] = None):
        """Pick-and-try loop shared by infer/generate/stream-start.
        ``call(client, rid)`` performs the request on the chosen
        replica's persistent client (rid so a stream can remember which
        replica it lives on for mid-stream failover)."""
        t0 = time.perf_counter()
        with _tracing.span("fleet.route", model=str(model)):
            tried: set = set()
            saw_model = False
            overloaded = 0
            last_err: Optional[Exception] = None
            # up to two ranking passes: the second with scrape caches
            # invalidated, so one stale-scrape refusal doesn't shed a
            # request the fleet could still serve
            for attempt in range(2):
                # per-PASS selection cost: route_ms prices the ranking
                # (discover + scrape + score) alone — timing from the
                # route's start would fold pass-1's failed request
                # attempts (full RPC timeouts) into pass-2's sample
                t_pass = time.perf_counter()
                cands, serving_model, reachable = self._candidates(
                    model, need_tokens, prompt)
                _m_route_ms.observe(
                    (time.perf_counter() - t_pass) * 1e3)
                if reachable == 0:
                    with self._mu:
                        table_size = len(self._replicas)
                    raise NoReplicasError(
                        "no live replica reachable (controller table "
                        f"size {table_size})")
                saw_model = saw_model or serving_model > 0
                cands = [(rid, ep, warm) for rid, ep, warm in cands
                         if rid not in tried]
                for rid, ep, warm in cands:
                    tried.add(rid)
                    cli = self._client(rid, ep)
                    with self._mu:
                        ctr = self._routed.get(rid)
                        if ctr is None:
                            ctr = self._routed[rid] = _metrics.counter(
                                f"fleet.routed.{rid}")
                    ctr.inc()
                    if warm:
                        _m_routed_warm.inc()
                    try:
                        out = call(cli, rid)
                        _m_request_ms.observe(
                            (time.perf_counter() - t0) * 1e3)
                        return out
                    except ServerOverloaded as e:
                        # stale scrape: this replica filled up since we
                        # looked — drop its cached load, try the next
                        overloaded += 1
                        last_err = e
                        self._invalidate_load(rid)
                    except ModelNotFound as e:
                        # raced an unload/rollout on this replica (the
                        # scrape listed the model, the engine is gone
                        # now): not a capacity refusal — try the next
                        # replica on a fresh scrape
                        last_err = e
                        self._invalidate_load(rid)
                    except (EngineRetired, ConnectionError, OSError) as e:
                        # dead or deploy-storming replica: fail over.
                        # Same-replica retransmits already happened
                        # inside the client (dedup-safe); landing here
                        # means the replica is not answering at all.
                        _m_failovers.inc()
                        last_err = e
                        _log.warning(
                            "fleet router: failover off replica %s "
                            "(%s: %s)", rid, type(e).__name__, e)
                        # not a check-then-act on the earlier (purely
                        # diagnostic) table-size read: this pop keys on
                        # the FAILED rid alone and a concurrent refresh
                        # rewriting the table wholesale is the desired
                        # last-word-wins outcome
                        # lint: allow-unguarded(_replicas)
                        with self._mu:
                            self._drop_replica_locked(rid)
                            self._replicas.pop(rid, None)
                if attempt == 0:
                    # invalidate every scrape before the second pass:
                    # shedding must be decided on FRESH capacity
                    with self._mu:
                        self._loads.clear()
            if not saw_model:
                raise ModelNotFound(
                    f"no live replica serves model '{model}'")
            if overloaded == 0 and isinstance(last_err, ModelNotFound):
                raise ModelNotFound(
                    f"model '{model}' vanished from every replica that "
                    f"advertised it (mid-unload?): {last_err}")
            if overloaded == 0 and isinstance(
                    last_err, (ConnectionError, OSError, EngineRetired)):
                # every replica serving the model died on contact: that
                # is an availability failure, not a capacity one — a
                # shed here would tell the operator to scale up when
                # the fleet actually needs reviving
                raise NoReplicasError(
                    f"every replica serving '{model}' became "
                    f"unreachable (last: {last_err})")
            _m_sheds.inc()
            raise ServerOverloaded(
                f"fleet-wide overload for '{model}': no replica has "
                f"capacity ({overloaded} refused on contact; "
                f"last: {last_err})")

    # -- public surface ---------------------------------------------------
    def infer(self, model: str, feeds: Dict[str, Any],
              deadline_ms: Optional[float] = None
              ) -> Tuple[List[np.ndarray], int]:
        return self._route(
            str(model), None,
            lambda cli, _rid: cli.infer(str(model), feeds,
                                        deadline_ms=deadline_ms))

    def generate(self, model: str, prompt: Sequence[int],
                 max_new_tokens: int = 16,
                 deadline_ms: Optional[float] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 seed: int = 0, stream: bool = False):
        """Route one decode request. ``stream=True`` returns a
        ``FleetTokenStream`` yielding tokens as they decode, with
        MID-STREAM failover: a replica death resumes the stream on a
        survivor from the last delivered offset (never duplicating or
        dropping a token — see FleetTokenStream), or fails typed."""
        prompt = [int(t) for t in prompt]
        need = len(prompt) + int(max_new_tokens)
        kw = dict(max_new_tokens=int(max_new_tokens),
                  deadline_ms=deadline_ms, temperature=temperature,
                  top_k=top_k, seed=seed)
        if stream:
            fs = FleetTokenStream(self, str(model), prompt, kw, need)
            fs._ensure_stream()  # surface routing errors at call time
            return fs
        return self._route(
            str(model), need,
            lambda cli, _rid: cli.generate(str(model), prompt, **kw),
            prompt=prompt)

    def workload(self, model: str, workload: Dict[str, Any]
                 ) -> Dict[str, Any]:
        """Route one typed workload with KIND-AWARE
        admission math: the page-pool check a candidate must pass
        depends on what the kind will actually reserve — embed holds
        exactly the prompt's pages (max_new = 0), beam holds the
        parent's prompt + 1 plus k COW tails over SHARED prompt pages
        (so ~prompt + k×max_new new tokens, not k×(prompt + max_new)),
        generate/constrained the usual prompt + max_new. Prefix-warmth
        ranking applies to all kinds — a replica whose cache covers the
        prompt prefills only the suffix, for beams twice over (every
        child forks from it). Dedup-safe like generate: a retransmit is
        answered from the replica's reply cache."""
        from ..serving.workloads import parse_workload

        w = parse_workload(workload)  # refuse bad kinds BEFORE routing
        wire = w.to_dict()
        prompt = [int(t) for t in wire["prompt"]]
        if w.kind == "embed":
            need = len(prompt)
        elif w.kind == "beam":
            need = (len(prompt) + 1
                    + int(wire["k"]) * int(wire["max_new_tokens"]))
        else:
            need = len(prompt) + int(wire["max_new_tokens"])
        return self._route(
            str(model), need,
            lambda cli, _rid: cli.workload(str(model), wire),
            prompt=prompt)

    def replicas(self) -> List[str]:
        """Live replica ids (cached discovery view)."""
        return sorted(self.refresh())

    def stats(self) -> Dict[str, Any]:
        with self._mu:
            return {
                "replicas": sorted(self._replicas),
                "scrape_ttl": self._scrape_ttl,
                "cached_loads": sorted(self._loads),
            }

    def close(self):
        with self._mu:
            clients = [c for lst in self._all_clients.values()
                       for c in lst]
            for rid in list(self._all_clients):
                self._drop_replica_locked(rid)
            self._replicas = {}
            self._draining = set()
            pool, self._pool = self._pool, None
        # fleet-wide gauges must not outlive the router that computed
        # them — a closed router's last scrape is not live capacity
        _g_free_total.set(0)
        _g_headroom_total.set(0)
        _g_replicas_live.set(0)
        if pool is not None:
            pool.shutdown(wait=False)
        # outside the lock: close() serializes with any in-flight call
        # on each client
        for c in clients:
            try:
                c.close()
            except OSError:  # pragma: no cover
                pass
        self._ctl.close()

    def _note_replica_death(self, rid: str, err: BaseException):
        """Mid-stream transport death (FleetTokenStream's failover
        path): same bookkeeping as _route's failover arm."""
        _m_failovers.inc()
        _log.warning("fleet router: mid-stream failover off replica %s "
                     "(%s: %s)", rid, type(err).__name__, err)
        # keyed pop on the failed rid alone; a concurrent wholesale
        # refresh winning is the desired outcome
        # lint: allow-unguarded(_replicas)
        with self._mu:
            self._drop_replica_locked(rid)
            self._replicas.pop(rid, None)


class FleetTokenStream:
    """Streaming generate over the fleet: iterates tokens
    from whichever replica currently serves the stream, failing over
    MID-STREAM.

    When the serving replica dies (transport error on a continuation
    frame) or the stream expires under it (server restart), the router
    re-routes the SAME deterministic request — greedy or seeded
    sampling, so replay is token-identical — to a survivor and splices
    at the last offset the caller was handed: the already-delivered
    prefix is pulled from the new stream, VERIFIED token-by-token
    against what was delivered, and discarded. A divergent prefix (a
    different model version answering) raises a typed ServingError
    instead of silently splicing wrong tokens — a resumed stream never
    duplicates, drops, or rewrites a token. If no survivor can serve
    the request, iteration raises the routing layer's typed errors
    (NoReplicasError / ServerOverloaded / ModelNotFound)."""

    def __init__(self, router: FleetRouter, model: str,
                 prompt: List[int], kw: Dict[str, Any], need: int):
        self._router = router
        self._model = model
        self._prompt = prompt
        self._kw = kw
        self._need = need
        self._stream: Optional[TokenStream] = None
        self._rid: Optional[str] = None
        self._skip = 0
        self._delivered: List[int] = []
        self.result: Optional[Dict[str, Any]] = None

    @property
    def delivered(self) -> int:
        """Tokens handed to the caller so far (the resume offset)."""
        return len(self._delivered)

    @property
    def replica(self) -> Optional[str]:
        """The replica currently serving the stream (None between
        failovers) — chaos tests kill exactly this one."""
        return self._rid

    def _ensure_stream(self):
        if self._stream is not None:
            return
        def start(cli, rid):
            return rid, cli.generate(self._model, self._prompt,
                                     stream=True, **self._kw)
        self._rid, self._stream = self._router._route(
            self._model, self._need, start, prompt=self._prompt)
        self._skip = len(self._delivered)
        if self._skip:
            _m_stream_resumes.inc()
            _log.info("fleet router: resuming stream for '%s' on "
                      "replica %s from offset %d", self._model,
                      self._rid, self._skip)

    def __iter__(self) -> "FleetTokenStream":
        return self

    def __next__(self) -> int:
        while True:
            try:
                self._ensure_stream()
                while self._skip:
                    # replaying the delivered prefix on the survivor:
                    # verify, then discard — exactness per token
                    t = int(next(self._stream))
                    want = self._delivered[-self._skip]
                    if t != want:
                        raise ServingError(
                            f"resumed stream for '{self._model}' on "
                            f"replica {self._rid} diverged at offset "
                            f"{len(self._delivered) - self._skip} "
                            f"({t} != delivered {want}) — refusing to "
                            "splice mismatched tokens")
                    self._skip -= 1
                tok = int(next(self._stream))
            except StopIteration:
                if self._skip:
                    # the survivor's sequence ended BEFORE the offset
                    # the caller already holds: never silently shorten
                    raise ServingError(
                        f"resumed stream for '{self._model}' on "
                        f"replica {self._rid} ended {self._skip} "
                        "token(s) before the delivered offset")
                self.result = self._stream.result
                raise
            except StreamExpired as e:
                # the REPLICA is healthy — only the stream is gone
                # (idle-TTL sweep after a long consumer pause, or a
                # server restart): re-route and splice at the delivered
                # offset WITHOUT the replica-death bookkeeping; evicting
                # a live replica from the table over a swept stream
                # would shrink routing capacity and pollute the
                # failover metrics
                _log.warning(
                    "fleet router: stream for '%s' expired on replica "
                    "%s (%s); restarting from offset %d", self._model,
                    self._rid, e, len(self._delivered))
                self._stream = None
                self._rid = None
                continue
            except (ConnectionError, OSError) as e:
                # the serving replica died: drop it, re-route, splice
                # at the delivered offset. Typed routing errors out of
                # _ensure_stream (no survivor / no capacity) propagate
                # to the caller.
                if self._rid is not None:
                    self._router._note_replica_death(self._rid, e)
                self._stream = None
                self._rid = None
                continue
            self._delivered.append(tok)
            return tok

    def close(self):
        """Best-effort release of the current replica-side stream."""
        if self._stream is not None:
            self._stream.close()

    def __enter__(self) -> "FleetTokenStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
