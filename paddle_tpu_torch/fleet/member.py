"""FleetMember — joins one ServingServer to a fleet.

The member is the replica-side agent: it registers the server's
endpoint with the FleetController, renews the lease with heartbeats
(ttl/3 cadence, the classic three-strikes margin), and CONVERGES the
replica's model set to the controller's intent log.

Convergence is what makes the fleet self-healing: a replica that was
evicted (network blip), restarted, or killed mid-rollout re-registers,
learns the latest intent seq, fetches the log tail it missed, and
applies each intent through its own ServingServer's deploy RPC — so a
convergence deploy gets exactly the same warm-then-flip + drain
guarantees a rollout-driver deploy gets. Intents are idempotent to
apply: a deploy whose version is already live (or older than the live
one) is skipped, and the server's own live-version collision refusal
is treated as "already converged" — the rollout driver and a
heartbeat-triggered convergence can race the same deploy and both
win.

Two threads, deliberately split: the BEAT thread only heartbeats (a
lease renewal must never queue behind a long warmup —
that ordering bug would evict every replica that dares to deploy), and
the CONVERGE thread applies intents, woken by beats that report a
newer intent seq. Each has its own RPC client: RpcClient serializes
calls per connection, so sharing one would re-create the same stall.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from ..distributed.rpc import RpcClient
from ..observability import metrics as _metrics
from ..observability.log import get_logger
from ..serving.client import ServingClient
from ..serving.errors import ModelNotFound
from . import auth as _auth

__all__ = ["FleetMember"]

_log = get_logger("fleet")

_m_converges = _metrics.counter("fleet.member.converges")
_m_converge_errors = _metrics.counter("fleet.member.converge_errors")


class FleetMember:
    """Registers a ServingServer with a controller and keeps it
    converged to the fleet's intent log."""

    def __init__(self, server, controller_addr,
                 replica_id: Optional[str] = None,
                 beat_interval: Optional[float] = None,
                 start: bool = True):
        host, port = server.address
        # default id is STABLE across restarts of the same endpoint
        # (host-port, not a per-process uuid): a restarting replica
        # re-registers under its old name instead of minting a fresh
        # per-rid metric series (fleet.replica_up/routed/...) on the
        # controller and every router at each restart — the unbounded-
        # registry-growth cousin of the N205 gauge-linger class
        self.replica_id = (str(replica_id) if replica_id
                           else f"replica-{host.replace('.', '-')}-{port}")
        self._server = server
        self._endpoint = [host, int(port)]
        self._ctl_addr = controller_addr
        # beat cadence: resolved from the controller's advertised ttl on
        # first registration unless pinned; until then a conservative 1s
        self._beat_interval = (None if beat_interval is None
                               else float(beat_interval))
        self._cond = threading.Condition()
        self._applied_seq = 0  # guarded-by: _cond
        self._target_seq = 0  # guarded-by: _cond
        self._registered = False  # guarded-by: _cond
        self._stopping = False  # guarded-by: _cond
        self._threads = []
        # replay refusal for signed intents: per-member so a
        # replayed append is refused by EVERY replica independently
        self._nonces = _auth.NonceWindow()
        if start:
            self.start()

    # -- lifecycle --------------------------------------------------------
    def start(self):
        if self._threads:
            return
        for name, fn in (("beat", self._beat_loop),
                         ("converge", self._converge_loop)):
            t = threading.Thread(
                target=fn, daemon=True,
                name=f"fleet-member-{self.replica_id}-{name}")
            t.start()
            self._threads.append(t)

    def stop(self, deregister: bool = True, timeout: float = 10.0):
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout)
        self._threads = []
        if deregister:
            try:
                cli = self._ctl_client()
                try:
                    cli.call("deregister", self.replica_id)
                finally:
                    cli.close()
            except (ConnectionError, OSError, RuntimeError):
                pass  # the TTL will expire the lease

    def wait_registered(self, timeout: float = 30.0) -> bool:
        """Block until the first successful registration (tests and
        orchestration scripts: a rollout before any replica joined is
        a RolloutError by design)."""
        import time

        deadline = time.monotonic() + float(timeout)
        with self._cond:
            while not self._registered and not self._stopping:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                # lint: allow-blocking — a bounded startup wait
                self._cond.wait(remaining)
            return self._registered

    def wait_converged(self, seq: Optional[int] = None,
                       timeout: float = 120.0) -> bool:
        """Block until the member has applied intents up to `seq`
        (default: its current target). Counter-friendly test hook."""
        import time

        deadline = time.monotonic() + float(timeout)
        with self._cond:
            while True:
                want = self._target_seq if seq is None else int(seq)
                if self._applied_seq >= want or self._stopping:
                    return self._applied_seq >= want
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                # lint: allow-blocking — a bounded test/orchestration wait
                self._cond.wait(remaining)

    def stats(self) -> Dict[str, Any]:
        with self._cond:
            return {"replica_id": self.replica_id,
                    "registered": self._registered,
                    "applied_seq": self._applied_seq,
                    "target_seq": self._target_seq}

    def _load_summary(self) -> Optional[Dict[str, Any]]:
        """Compact load snapshot piggybacked on every heartbeat
       : the autoscale policy loop's per-replica input —
        free KV pages, queue headroom, cached-token mass (the
        cache-aware drain-order signal), idleness, and the model set.
        Computed from the server's in-process load_report (no loopback
        RPC: a beat must never queue behind the replica's own data
        plane)."""
        try:
            report = self._server.load_report()
        except Exception:  # beat must survive any registry hiccup
            return None
        free = headroom = cached = depth = live = 0
        models: Dict[str, int] = {}
        for name, m in report.get("models", {}).items():
            models[name] = int(m.get("version", 0))
            depth += int(m.get("queue_depth", 0))
            headroom += max(0, int(m.get("max_queue", 0))
                            - int(m.get("queue_depth", 0)))
            free += int(m.get("free_pages", 0))
            live += int(m.get("live_slots", 0))
            pc = m.get("prefix_cache")
            if pc:
                cached += int(pc.get("tokens", 0))
        return {"free_pages": free, "queue_headroom": headroom,
                "cached_tokens": cached, "queue_depth": depth,
                "live_slots": live, "models": models}

    # -- controller RPC ---------------------------------------------------
    def _ctl_client(self) -> RpcClient:
        # fail-fast like TcpLease: a beat that can't reach the
        # controller within one timeout has failed — the loop retries
        # next tick, it must not burn a multi-attempt backoff budget
        return RpcClient(self._ctl_addr, timeout=10.0, retries=0)

    # -- beat loop --------------------------------------------------------
    def _beat_loop(self):
        cli = self._ctl_client()
        interval = self._beat_interval or 1.0
        try:
            while True:
                with self._cond:
                    if self._stopping:
                        return
                    registered = self._registered
                try:
                    if not registered:
                        r = cli.call("register", self.replica_id,
                                     self._endpoint)
                        if self._beat_interval is None:
                            interval = max(0.05,
                                           float(r.get("ttl", 3.0)) / 3.0)
                        self._note_seq(int(r.get("intent_seq", 0)),
                                       registered=True)
                        _log.info("fleet member %s: registered "
                                  "(intent seq %s)", self.replica_id,
                                  r.get("intent_seq"))
                    else:
                        with self._cond:
                            applied = self._applied_seq
                        r = cli.call("heartbeat", self.replica_id,
                                     applied, self._load_summary())
                        if not r.get("ok"):
                            # evicted (or the controller restarted):
                            # re-register next tick — rejoin, converge
                            _log.warning(
                                "fleet member %s: lease lost (%s); "
                                "re-registering", self.replica_id,
                                r.get("reason"))
                            self._note_seq(None, registered=False)
                        else:
                            self._note_seq(int(r.get("intent_seq", 0)),
                                           registered=True)
                except (ConnectionError, OSError, RuntimeError) as e:
                    # controller unreachable: keep beating — the lease
                    # may lapse (eviction), and the re-register path
                    # above heals that the moment the controller is back
                    _log.warning("fleet member %s: beat failed (%s: %s)",
                                 self.replica_id, type(e).__name__, e)
                    cli.close()
                    self._note_seq(None, registered=False)
                with self._cond:
                    if self._stopping:
                        return
                    # lint: allow-blocking — the beat loop's own timed
                    # wait; nothing else blocks on _cond for long
                    self._cond.wait(interval)
        finally:
            cli.close()

    def _note_seq(self, seq: Optional[int], registered: bool):
        with self._cond:
            self._registered = registered
            if seq is not None:
                if seq < self._applied_seq:
                    # the controller's log is SHORTER than what we
                    # already applied: it restarted with a fresh log.
                    # Our watermark belongs to the old log — reset and
                    # re-converge from the new log's start (safe:
                    # intent application is idempotent, already-live
                    # versions are skipped). Without this, every
                    # post-restart intent carries a seq below the old
                    # watermark and convergence silently stalls forever.
                    _log.warning(
                        "fleet member %s: controller intent log "
                        "regressed (%d < applied %d) — controller "
                        "restart; re-converging from the new log",
                        self.replica_id, seq, self._applied_seq)
                    self._applied_seq = 0
                    self._target_seq = seq
                elif seq > self._target_seq:
                    self._target_seq = seq
            # always notify: wait_registered parks on this condition
            # too, and a registration with nothing to converge must
            # wake it (a seq-gated notify left it sleeping its full
            # timeout)
            self._cond.notify_all()

    # -- convergence loop -------------------------------------------------
    def _converge_loop(self):
        ctl = self._ctl_client()
        loop_cli: Optional[ServingClient] = None
        try:
            while True:
                with self._cond:
                    while (not self._stopping
                           and self._target_seq <= self._applied_seq):
                        # lint: allow-blocking — the converge loop's
                        # park; beats notify on new intents
                        self._cond.wait()
                    if self._stopping:
                        return
                    since = self._applied_seq
                try:
                    intents = ctl.call("intents", since)
                except (ConnectionError, OSError, RuntimeError) as e:
                    _log.warning("fleet member %s: intent fetch failed "
                                 "(%s)", self.replica_id, e)
                    ctl.close()
                    with self._cond:
                        # lint: allow-blocking — backoff nap on _cond
                        self._cond.wait(0.5)
                    continue
                if loop_cli is None:
                    # loopback deploys go through the replica's OWN RPC
                    # surface, so convergence inherits the full deploy
                    # contract (serialized _load_mu, warm-then-flip,
                    # live-version collision refusal)
                    loop_cli = ServingClient(tuple(self._endpoint),
                                             retries=1)
                for intent in intents:
                    with self._cond:
                        if self._stopping:
                            return
                    self._apply_intent(loop_cli, intent)
                    # re-validated check-then-act: the converge thread
                    # is the only writer, and max() re-reads under the
                    # lock, so a concurrent advance would be kept, not
                    # regressed
                    # lint: allow-unguarded(_applied_seq)
                    with self._cond:
                        self._applied_seq = max(self._applied_seq,
                                                int(intent["seq"]))
                        self._cond.notify_all()
        finally:
            ctl.close()
            if loop_cli is not None:
                loop_cli.close()

    def _apply_intent(self, cli: ServingClient, intent: Dict[str, Any]):
        """Apply one intent, idempotently. Failures are counted and
        logged but never kill the loop: the seq still advances — a
        poisoned intent (bad spec, missing dirname on this host) must
        not wedge convergence of everything after it."""
        action = intent.get("action")
        model = str(intent.get("model"))
        payload = dict(intent.get("payload") or {})
        version = payload.get("version")
        try:
            # signed-fleet gate: the member re-verifies the
            # signature (the controller may be spoofed) AND enforces
            # the path allowlist (paths mean something on THIS host).
            # A refusal is typed + counted by auth; the seq still
            # advances — same poisoned-intent discipline as below.
            _auth.verify_intent(_auth.intent_key(), intent,
                                window=self._nonces,
                                prev_key=_auth.intent_key_prev())
            _auth.check_allowlist(_auth.intent_allowlist(), intent)
        except _auth.IntentRefused as e:
            _log.error("fleet member %s: intent #%s REFUSED: %s",
                       self.replica_id, intent.get("seq"), e)
            return
        try:
            if action in ("load_model", "load_decoder"):
                live = self._live_version(model)
                if (live is not None and version is not None
                        and int(version) <= live):
                    return  # already converged (or ahead)
                try:
                    if action == "load_model":
                        cli.load_model(model, **payload)
                    else:
                        cli.load_decoder(model, **payload)
                except ValueError as e:
                    # live-version collision: someone (the rollout
                    # driver, another convergence pass) deployed it
                    # between our check and the call — converged
                    if "already the live version" not in str(e):
                        raise
            elif action == "unload_model":
                try:
                    cli.unload_model(model)
                except ModelNotFound:
                    pass  # already gone
            else:  # unknown action: skip (forward compatibility)
                _log.warning("fleet member %s: unknown intent action "
                             "%r skipped", self.replica_id, action)
                return
            _m_converges.inc()
            _log.info("fleet member %s: applied intent #%s (%s %s)",
                      self.replica_id, intent.get("seq"), action, model)
        except Exception as e:
            _m_converge_errors.inc()
            _log.error("fleet member %s: intent #%s (%s %s) failed: "
                       "%s: %s", self.replica_id, intent.get("seq"),
                       action, model, type(e).__name__, e)

    def _live_version(self, model: str) -> Optional[int]:
        try:
            return int(self._server.registry.get(model).version)
        except ModelNotFound:
            return None
