"""FleetController — replica membership + replicated deploy intents
(the counterpart of ``paddle_tpu/fleet/controller.py``, same RPC surface).

One ServingServer is one process; a fleet is N of them composed into a
single service. The controller is the composition point, playing the
role the reference's Go EDL master played (etcd-backed membership +
task state): it keeps

  * a REPLICA TABLE — replica_id -> endpoint with a TTL lease renewed
    by heartbeats. The discipline is exactly the pserver/tcp_lease one:
    liveness is decided by THIS server's clock (deadlines are never
    compared across hosts), a lapsed lease means eviction (the replica
    vanishes from `list_replicas`, its `fleet.replica_up.<rid>` gauge
    zeroes, `fleet.evictions` counts it), and a re-`register` is the
    rejoin path — eviction is reversible by showing up again, never a
    permanent ban (the same "push resurrects" semantics the pserver's
    trainer eviction has).

  * an INTENT LOG — an append-only, monotonically-numbered list of
    model-deploy intents (`load_model` / `load_decoder` /
    `unload_model`). The log is the fleet's DESIRED model set: a
    replica that rejoins after an eviction, restart, or mid-rollout
    kill fetches the tail it missed and converges (FleetMember applies
    intents through the replica's own deploy RPC, so every convergence
    deploy gets the registry's warm-then-flip + drain guarantees).
    Heartbeat responses carry the latest intent seq, so a live replica
    learns of new intents at heartbeat cadence with zero extra RPCs.
    Heartbeats carry each member's APPLIED seq back, and
    the log COMPACTS below the fleet-wide applied watermark: superseded
    deploys and unloaded models drop, the latest live-model intent
    below the watermark is kept VERBATIM (original seq, nonce, and
    signature — a re-signed copy would be a forgery), so a long-lived
    fleet's restart replay and controller memory stay O(live models)
    while every assigned seq remains monotone (`_next_seq` never
    regresses, so the member's controller-restart log-regression
    detection keeps firing only on a real restart).

  * a SCALE-INTENT CHANNEL — the autoscale policy loop's output
    (`scale_up` / `scale_down`), numbered independently of the deploy
    log and consumed by the ReplicaLauncher (fleet/launcher.py): a
    scale_up spawns a fresh replica subprocess (its model set then
    converges from the deploy log — checkpoint-dir deploys included),
    a scale_down names the drained victim the launcher must stop.
    Replicas the policy is draining carry a `draining` flag in the
    replica table; routers stop sending NEW requests to a draining
    replica while its in-flight work finishes.

When the fleet is keyed (fleet/auth.py), `add_intent` and
`add_scale_intent` refuse unsigned, tampered, or replayed appends
typed + counted — the log is the fleet's write surface, and garbage
must not enter it even before the members' own verification.

Every handler fires the `fleet.<method>` fault site first, so chaos
plans reach the control plane by name. `add_intent` rides the RPC dedup
cache (an append retransmitted after a lost reply must not append
twice); everything else — registration, heartbeats, reads — is
state-convergent and declared idempotent, so the high-rate heartbeat
path never occupies dedup-cache slots.

The controller is soft state in the etcd sense: it holds no model
bytes, only membership and intent metadata. Losing it stops NEW
registrations/rollouts but in-flight serving continues — routers keep
their last replica table and talk to replicas directly.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..distributed import faults as _faults
from ..distributed.rpc import RpcServer
from ..observability import debug_server as _debug, metrics as _metrics
from ..observability.log import get_logger
from . import auth as _auth

__all__ = ["FleetController", "INTENT_ACTIONS", "SCALE_ACTIONS"]

_log = get_logger("fleet")

_m_registrations = _metrics.counter("fleet.registrations")
_m_evictions = _metrics.counter("fleet.evictions")
_m_heartbeats = _metrics.counter("fleet.heartbeats")
_m_intents = _metrics.counter("fleet.intents")
_m_compacted = _metrics.counter("fleet.intents.compacted")
_m_scale_intents = _metrics.counter("fleet.scale.intents")
_g_replicas = _metrics.gauge("fleet.replicas")
_g_intent_log = _metrics.gauge("fleet.intent_log")

# the deploy verbs a FleetMember knows how to apply against its own
# ServingServer (member.py _apply_intent is the consumer)
INTENT_ACTIONS = ("load_model", "load_decoder", "unload_model")

# the scale verbs the ReplicaLauncher consumes (launcher.py)
SCALE_ACTIONS = ("scale_up", "scale_down")


class FleetController:
    """Lease-based replica membership + the fleet's deploy-intent log."""

    def __init__(self, lease_ttl: Optional[float] = None,
                 sweep_interval: Optional[float] = None):
        from ..flags import FLAGS

        self.lease_ttl = float(FLAGS["fleet_lease_ttl"]
                               if lease_ttl is None else lease_ttl)
        if self.lease_ttl <= 0:
            raise ValueError(
                f"lease_ttl must be positive, got {self.lease_ttl}")
        # sweeper cadence; 0 disables the thread (in-process tests) —
        # expiry still happens lazily inside every table scan, so a
        # lapsed replica is invisible to routing either way; the
        # sweeper only bounds how long gauges/eviction counters lag
        # when NOBODY is asking (the master lease-sweeper rationale)
        self._sweep_interval = (self.lease_ttl / 2.0
                                if sweep_interval is None
                                else float(sweep_interval))
        self._mu = threading.Lock()
        # rid -> {endpoint, deadline, registered_at, beats, draining,
        #         applied_seq, load}
        self._replicas: Dict[str, Dict[str, Any]] = {}  # guarded-by: _mu
        # ascending by seq; seqs may be SPARSE after compaction, so the
        # latest assigned seq lives in _next_seq, never len()
        self._intents: List[Dict[str, Any]] = []  # guarded-by: _mu
        self._next_seq = 0  # guarded-by: _mu
        self._scale_intents: List[Dict[str, Any]] = []  # guarded-by: _mu
        self._next_scale_seq = 0  # guarded-by: _mu
        # replay refusal for signed appends (fleet/auth.py)
        self._nonces = _auth.NonceWindow()
        # recent evictions only (statusz evidence), bounded so replica
        # churn over a long-lived controller can't grow it forever
        self._evicted: Dict[str, float] = {}  # guarded-by: _mu
        self._evicted_cap = 64
        # per-replica up/down gauges, zeroed at eviction (the N205
        # discipline applied by hand: these are dict-held, not
        # self-attr registrations, but the clobber/linger class is the
        # same — a dead replica must not read as up)
        self._up_gauges: Dict[str, Any] = {}  # guarded-by: _mu
        self._sweep_stop: Optional[threading.Event] = None
        handlers = {
            "register": self._register,
            "heartbeat": self._heartbeat,
            "deregister": self._deregister,
            "list_replicas": self._list_replicas,
            "add_intent": self._add_intent,
            "intents": self._intents_since,
            "evict": self._evict,
            "fleet_status": self._fleet_status,
            "set_draining": self._set_draining,
            "add_scale_intent": self._add_scale_intent,
            "scale_intents": self._scale_intents_since,
        }
        self._rpc = RpcServer(
            {m: self._guarded(m, fn) for m, fn in handlers.items()},
            # add_intent / add_scale_intent APPEND — a retransmit after
            # a lost reply must answer from the dedup cache, not append
            # a duplicate intent. Everything else is convergent or a
            # read.
            idempotent={"register", "heartbeat", "deregister",
                        "list_replicas", "intents", "evict",
                        "fleet_status", "set_draining",
                        "scale_intents"},
        )

    @staticmethod
    def _guarded(method: str, fn):
        """Every handler fires `fleet.<method>` first — the same named
        chaos seam serving.<method> gives the data plane."""
        def handler(*args, **kw):
            _faults.fire(f"fleet.{method}")
            return fn(*args, **kw)
        return handler

    # -- lifecycle --------------------------------------------------------
    def serve(self, host: str = "127.0.0.1", port: int = 0
              ) -> Tuple[str, int]:
        addr = self._rpc.serve(host, port)
        _log.info("fleet controller listening on %s:%d (ttl %.1fs)",
                  addr[0], addr[1], self.lease_ttl)
        if self._sweep_interval > 0:
            self._start_sweeper()
        _debug.maybe_serve_from_env()
        self._status_name = f"fleet:{addr[1]}"
        _debug.add_status(self._status_name, self._fleet_status)
        return addr

    @property
    def address(self) -> Tuple[str, int]:
        return self._rpc.address

    def shutdown(self):
        _debug.remove_status(getattr(self, "_status_name", None))
        if self._sweep_stop is not None:
            self._sweep_stop.set()
            self._sweep_stop = None
        self._rpc.shutdown()

    def kill(self):
        """Chaos seam: die like a SIGKILLed controller process — the
        transport severs established connections (members' heartbeat
        channels included), so peers see resets instead of a
        half-alive controller whose old handler threads keep
        answering. The restart test drives the member's
        log-regression recovery through this."""
        _debug.remove_status(getattr(self, "_status_name", None))
        if self._sweep_stop is not None:
            self._sweep_stop.set()
            self._sweep_stop = None
        self._rpc.kill()

    def _start_sweeper(self):
        if self._sweep_stop is not None:
            return
        stop = self._sweep_stop = threading.Event()

        def _sweep():
            while not stop.wait(self._sweep_interval):
                try:
                    with self._mu:
                        self._expire_locked(time.time())
                except Exception as e:  # pragma: no cover - keep sweeping
                    _log.error("fleet sweeper: %s: %s",
                               type(e).__name__, e)

        t = threading.Thread(target=_sweep, daemon=True,
                             name="fleet-lease-sweeper")
        t.start()

    # -- membership -------------------------------------------------------
    def _expire_locked(self, now: float):
        """Evict every replica whose lease lapsed. Called under _mu from
        every table scan (lazy, zero-poll expiry) and from the sweeper."""
        for rid in [r for r, st in self._replicas.items()
                    if st["deadline"] <= now]:
            del self._replicas[rid]
            self._note_evicted_locked(rid, now)
            _m_evictions.inc()
            g = self._up_gauges.get(rid)
            if g is not None:
                g.set(0)  # a dead replica must not read as up
            _log.warning("fleet: evicted replica %s (missed heartbeats "
                         "for > %.1fs)", rid, self.lease_ttl)
        _g_replicas.set(len(self._replicas))

    def _note_evicted_locked(self, rid: str, now: float):
        # pop-then-insert so a re-evicted rid moves to the newest slot
        # (plain assignment keeps a dict key's ORIGINAL position)
        self._evicted.pop(rid, None)
        self._evicted[rid] = now
        while len(self._evicted) > self._evicted_cap:
            # dicts iterate in insertion order: drop the oldest record
            self._evicted.pop(next(iter(self._evicted)))

    def _register(self, replica_id: str, endpoint) -> Dict[str, Any]:
        """Join (or rejoin) the fleet. Convergent: re-registering
        refreshes the lease and endpoint. The response carries the
        latest intent seq so the member knows how much log to fetch to
        converge its model set."""
        rid = str(replica_id)
        if not rid:
            raise ValueError("empty replica_id")
        if (not isinstance(endpoint, (list, tuple)) or len(endpoint) != 2):
            raise ValueError(f"bad endpoint {endpoint!r} (want [host, port])")
        endpoint = (str(endpoint[0]), int(endpoint[1]))
        now = time.time()
        with self._mu:
            self._expire_locked(now)
            fresh = rid not in self._replicas
            self._replicas[rid] = {
                "endpoint": endpoint,
                "deadline": now + self.lease_ttl,
                "registered_at": now,
                "beats": 0,
                # a REJOIN starts un-draining: the policy drains live
                # replicas, and a re-registered one is a fresh worker
                "draining": False,
                # applied watermark unknown until the first modern
                # heartbeat reports it — None disables compaction, so
                # a fleet of old members never loses log they need
                "applied_seq": None,
                "load": None,
            }
            self._evicted.pop(rid, None)
            g = self._up_gauges.get(rid)
            if g is None:
                g = self._up_gauges[rid] = _metrics.gauge(
                    f"fleet.replica_up.{rid}")
            g.set(1)
            _g_replicas.set(len(self._replicas))
            seq = self._next_seq
        if fresh:
            _m_registrations.inc()
            _log.info("fleet: replica %s registered at %s:%d",
                      rid, endpoint[0], endpoint[1])
        return {"ok": True, "ttl": self.lease_ttl, "intent_seq": seq}

    def _heartbeat(self, replica_id: str,
                   applied_seq: Optional[int] = None,
                   load: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, Any]:
        """Renew the lease. `ok: False` (not an error — heartbeats are
        hot-path) tells an evicted/unknown replica to re-register; the
        response's intent_seq is how live replicas learn of new deploy
        intents without any extra RPC. Modern members also
        report their APPLIED intent seq — the fleet-wide minimum is the
        compaction watermark — and piggyback a compact load summary
        (free pages, queue headroom, cached-token mass) that feeds the
        autoscale policy loop with zero extra scrape RPCs."""
        rid = str(replica_id)
        now = time.time()
        with self._mu:
            self._expire_locked(now)
            st = self._replicas.get(rid)
            if st is None:
                return {"ok": False, "reason": "unregistered"}
            st["deadline"] = now + self.lease_ttl
            st["beats"] += 1
            if applied_seq is not None:
                st["applied_seq"] = int(applied_seq)
            if load is not None:
                st["load"] = dict(load)
            self._compact_locked()
            seq = self._next_seq
            draining = bool(st["draining"])
        _m_heartbeats.inc()
        return {"ok": True, "intent_seq": seq, "draining": draining}

    def _deregister(self, replica_id: str) -> Dict[str, Any]:
        """Clean leave: removed from the table WITHOUT counting as an
        eviction (evictions measure failure detection, not shutdowns)."""
        rid = str(replica_id)
        with self._mu:
            there = self._replicas.pop(rid, None) is not None
            g = self._up_gauges.get(rid)
            if g is not None:
                g.set(0)
            _g_replicas.set(len(self._replicas))
        return {"ok": True, "was_registered": there}

    def _list_replicas(self) -> Dict[str, Any]:
        """Live replicas only (lease unexpired on THIS clock) — the
        router's discovery read. Expiry is applied first, so routing
        can never see a lapsed replica."""
        now = time.time()
        with self._mu:
            self._expire_locked(now)
            return {rid: {"endpoint": list(st["endpoint"]),
                          "draining": bool(st["draining"]),
                          "beat_age": round(
                              now - (st["deadline"] - self.lease_ttl), 3)}
                    for rid, st in self._replicas.items()}

    def _evict(self, replica_id: str) -> Dict[str, Any]:
        """Operator force-evict (counts as an eviction: the replica is
        presumed failed, not politely leaving)."""
        rid = str(replica_id)
        with self._mu:
            st = self._replicas.pop(rid, None)
            if st is not None:
                self._note_evicted_locked(rid, time.time())
                _m_evictions.inc()
                g = self._up_gauges.get(rid)
                if g is not None:
                    g.set(0)
            _g_replicas.set(len(self._replicas))
        return {"ok": True, "was_registered": st is not None}

    # -- intent log -------------------------------------------------------
    def _add_intent(self, action: str, model: str,
                    payload: Optional[Dict[str, Any]] = None,
                    nonce: Optional[str] = None,
                    sig: Optional[str] = None) -> Dict[str, Any]:
        """Append a deploy intent. `payload` carries the action's
        arguments verbatim (spec/dirname/version/engine knobs — whatever
        the matching ServingClient method takes); the controller only
        validates the envelope, members interpret the payload. When the
        fleet is keyed, the append must carry a valid `(nonce, sig)`
        pair (fleet/auth.py) — unsigned/tampered/replayed appends are
        refused typed + counted before they can enter the log. Members
        RE-verify before applying: the controller check keeps garbage
        out of the log, the member check survives a spoofed
        controller."""
        action = str(action)
        if action not in INTENT_ACTIONS:
            raise ValueError(
                f"unknown intent action {action!r}; known: "
                f"{INTENT_ACTIONS}")
        model = str(model)
        if not model:
            raise ValueError("empty model name")
        payload = dict(payload or {})
        record: Dict[str, Any] = {"action": action, "model": model,
                                  "payload": payload}
        if nonce is not None:
            record["nonce"] = str(nonce)
        if sig is not None:
            record["sig"] = str(sig)
        _auth.verify_intent(_auth.intent_key(), record,
                            window=self._nonces,
                            prev_key=_auth.intent_key_prev())
        with self._mu:
            self._next_seq += 1
            seq = record["seq"] = self._next_seq
            record["at"] = time.time()
            self._intents.append(record)
            _g_intent_log.set(len(self._intents))
        _m_intents.inc()
        _log.info("fleet: intent #%d: %s %s", seq, action, model)
        return {"ok": True, "seq": seq}

    def _intents_since(self, since: int = 0) -> List[Dict[str, Any]]:
        """The log tail with seq > since — what a converging member
        fetches. Intents are immutable once appended; seqs are sparse
        after compaction, so filter on the stored seq, never on list
        position."""
        since = max(0, int(since))
        with self._mu:
            return [dict(i) for i in self._intents if i["seq"] > since]

    def _compact_locked(self):
        """Drop log entries no live member still needs: below the
        fleet-wide applied watermark (min applied_seq over live
        replicas), only the LATEST load intent of each still-loaded
        model matters to a future joiner — superseded versions and
        load/unload pairs compact away. Kept intents keep their
        ORIGINAL record verbatim (seq, nonce, signature): a re-signed
        or re-numbered copy would break member-side verification and
        the monotone-seq contract. A replica that has never reported
        an applied seq (None — an old member) pins the watermark at
        zero, so compaction is strictly opt-in per fleet."""
        if not self._replicas:
            return
        applied = [st["applied_seq"] for st in self._replicas.values()]
        if any(a is None for a in applied):
            return
        watermark = min(applied)
        if watermark <= 0 or not self._intents:
            return
        # last action per model at-or-below the watermark, in log order
        last: Dict[str, Dict[str, Any]] = {}
        for rec in self._intents:
            if rec["seq"] <= watermark:
                last[rec["model"]] = rec
        keep_ids = {id(rec) for rec in last.values()
                    if rec["action"] != "unload_model"}
        kept = [rec for rec in self._intents
                if rec["seq"] > watermark or id(rec) in keep_ids]
        dropped = len(self._intents) - len(kept)
        if dropped <= 0:
            return
        self._intents = kept
        _g_intent_log.set(len(self._intents))
        _m_compacted.inc(dropped)
        _log.info("fleet: compacted %d intent(s) below watermark %d "
                  "(%d kept)", dropped, watermark, len(kept))

    # -- scale intents (autoscale policy -> launcher) ---------------------
    def _add_scale_intent(self, action: str,
                          payload: Optional[Dict[str, Any]] = None,
                          nonce: Optional[str] = None,
                          sig: Optional[str] = None) -> Dict[str, Any]:
        """Append a scale intent (`scale_up` / `scale_down`). Numbered
        independently of the deploy log; the ReplicaLauncher is the
        consumer. Signed under the same fleet key as deploy intents
        (model field is the empty-string sentinel '_fleet' so the
        canonical form stays one shape)."""
        action = str(action)
        if action not in SCALE_ACTIONS:
            raise ValueError(
                f"unknown scale action {action!r}; known: "
                f"{SCALE_ACTIONS}")
        payload = dict(payload or {})
        record: Dict[str, Any] = {"action": action, "model": "_fleet",
                                  "payload": payload}
        if nonce is not None:
            record["nonce"] = str(nonce)
        if sig is not None:
            record["sig"] = str(sig)
        _auth.verify_intent(_auth.intent_key(), record,
                            window=self._nonces,
                            prev_key=_auth.intent_key_prev())
        with self._mu:
            self._next_scale_seq += 1
            seq = record["seq"] = self._next_scale_seq
            record["at"] = time.time()
            self._scale_intents.append(record)
            # bounded: the launcher consumes from its local watermark,
            # and a scale intent is meaningless to a LATE joiner (the
            # fleet it described is gone) — keep a short tail only
            if len(self._scale_intents) > 256:
                self._scale_intents = self._scale_intents[-128:]
        _m_scale_intents.inc()
        _log.info("fleet: scale intent #%d: %s %s", seq, action, payload)
        return {"ok": True, "seq": seq}

    def _scale_intents_since(self, since: int = 0) -> List[Dict[str, Any]]:
        since = max(0, int(since))
        with self._mu:
            return [dict(i) for i in self._scale_intents
                    if i["seq"] > since]

    def _set_draining(self, replica_id: str,
                      draining: bool = True) -> Dict[str, Any]:
        """Mark a replica draining (or not). Routers stop sending NEW
        requests to a draining replica; its in-flight work finishes
        normally; the policy loop appends the scale_down intent once
        the replica's heartbeat summary reports it idle."""
        rid = str(replica_id)
        with self._mu:
            st = self._replicas.get(rid)
            if st is None:
                return {"ok": False, "reason": "unregistered"}
            st["draining"] = bool(draining)
        _log.info("fleet: replica %s draining=%s", rid, bool(draining))
        return {"ok": True}

    def policy_view(self) -> Dict[str, Dict[str, Any]]:
        """The autoscale policy loop's input (in-process read — the
        policy runs next to the controller): every live replica's
        draining flag, applied seq, and last heartbeat load summary."""
        now = time.time()
        with self._mu:
            self._expire_locked(now)
            return {rid: {"draining": bool(st["draining"]),
                          "applied_seq": st["applied_seq"],
                          "load": (dict(st["load"])
                                   if st["load"] else None)}
                    for rid, st in self._replicas.items()}

    # -- introspection ----------------------------------------------------
    def _fleet_status(self) -> Dict[str, Any]:
        """/statusz "fleet" section + the fleet_status RPC: membership,
        lease ages, evictions, intent-log size."""
        now = time.time()
        with self._mu:
            self._expire_locked(now)
            return {
                "lease_ttl": self.lease_ttl,
                "replicas": {
                    rid: {"endpoint": list(st["endpoint"]),
                          "beats": st["beats"],
                          "draining": bool(st["draining"]),
                          "applied_seq": st["applied_seq"],
                          "lease_remaining": round(
                              st["deadline"] - now, 3)}
                    for rid, st in self._replicas.items()},
                "evicted": sorted(self._evicted),
                "intent_seq": self._next_seq,
                "intent_log_len": len(self._intents),
                "scale_seq": self._next_scale_seq,
                "rpc": self._rpc.stats(),
            }
