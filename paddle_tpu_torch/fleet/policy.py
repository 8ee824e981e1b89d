"""FleetPolicy — the autoscale policy loop.

Closes the loop the fleet layer left open: the controller already KNOWS
every replica's load (heartbeats piggyback free KV pages, queue
headroom, cached-token mass — member.py `_load_summary`), and the
launcher can ACT (spawn/stop replica subprocesses) — the policy is the
decider in between. It runs in-process next to the controller, reads
`controller.policy_view()`, and emits SIGNED scale intents the
ReplicaLauncher consumes.

Decisions, and why each guard exists:

  * SCALE UP when the fleet-wide free-page total or queue headroom sits
    below its floor for `fleet_policy_beats` CONSECUTIVE ticks
    (hysteresis: one hot batch must not buy a replica), the cooldown
    has elapsed (a freshly spawned replica needs time to register and
    absorb load before the same pressure can justify another), and the
    fleet is below `fleet_max_replicas`. A fleet below
    `fleet_min_replicas` scales up unconditionally — that is the
    bootstrap path: a launcher + policy pair brings an EMPTY fleet to
    its floor with no operator action.

  * SCALE DOWN by CACHE-AWARE drain order: the victim is the COLDEST
    replica — the one whose heartbeat summary reports the least
    cached-token mass (prefix-cache `tokens`), because evicting it
    forfeits the least warm-routing value; ties break by replica id so
    the choice is deterministic, never random. Scale-down is
    self-hysteretic via a DEAD BAND: it only fires when the fleet
    minus the victim still retains `fleet_scale_margin`x BOTH floors —
    without the margin, a fleet sitting just above the floor would
    drain a replica, fall below the floor, scale back up, and flap
    forever.

  * DRAIN is a choreography, not a kill: mark the victim draining
    (routers stop sending NEW work), wait until its heartbeat summary
    reports it idle (zero queue depth AND zero live slots), then append
    the `scale_down` intent naming it — the launcher stops the process
    only after the fleet stopped using it. Pressure arriving mid-drain
    CANCELS the drain (the capacity is still registered; un-draining
    is cheaper than a spawn).

All thresholds count TICKS, not wall-clock seconds — the policy is
deterministic under `tick()` in tests (no sleeps, counter-exact
assertions) and the background thread is just `tick()` on a timer.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from ..distributed import faults as _faults
from ..observability import metrics as _metrics
from ..observability.log import get_logger
from . import auth as _auth

__all__ = ["FleetPolicy"]

_log = get_logger("fleet")

_m_ticks = _metrics.counter("fleet.policy.ticks")
_m_up = _metrics.counter("fleet.scale.up_intents")
_m_down = _metrics.counter("fleet.scale.down_intents")
_m_drains = _metrics.counter("fleet.scale.drain_started")


class FleetPolicy:
    """Reads the controller's per-replica load view, emits signed
    scale intents. One instance per controller, in-process."""

    def __init__(self, controller, interval: Optional[float] = None,
                 beats: Optional[int] = None,
                 cooldown: Optional[int] = None,
                 free_page_floor: Optional[int] = None,
                 headroom_floor: Optional[int] = None,
                 margin: Optional[float] = None,
                 min_replicas: Optional[int] = None,
                 max_replicas: Optional[int] = None,
                 replica_prefix: str = "auto-",
                 start: bool = False):
        from ..flags import FLAGS

        self._ctl = controller
        self.interval = float(FLAGS["fleet_policy_interval"]
                              if interval is None else interval)
        self.beats = max(1, int(FLAGS["fleet_policy_beats"]
                                if beats is None else beats))
        self.cooldown = max(0, int(FLAGS["fleet_policy_cooldown"]
                                   if cooldown is None else cooldown))
        self.free_page_floor = int(FLAGS["fleet_free_page_floor"]
                                   if free_page_floor is None
                                   else free_page_floor)
        self.headroom_floor = int(FLAGS["fleet_headroom_floor"]
                                  if headroom_floor is None
                                  else headroom_floor)
        self.margin = float(FLAGS["fleet_scale_margin"]
                            if margin is None else margin)
        self.min_replicas = max(0, int(FLAGS["fleet_min_replicas"]
                                       if min_replicas is None
                                       else min_replicas))
        self.max_replicas = max(1, int(FLAGS["fleet_max_replicas"]
                                       if max_replicas is None
                                       else max_replicas))
        self.replica_prefix = str(replica_prefix)
        self._mu = threading.Lock()
        self._tick_n = 0  # guarded-by: _mu
        self._streak = 0  # consecutive under-floor ticks; guarded-by: _mu
        self._cooldown_until = 0  # tick number; guarded-by: _mu
        self._spawn_n = 0  # replica-name counter; guarded-by: _mu
        # rid -> tick the drain started at; guarded-by: _mu
        self._draining: Dict[str, int] = {}
        self._stop: Optional[threading.Event] = None
        if start:
            self.start()

    # -- lifecycle --------------------------------------------------------
    def start(self):
        if self._stop is not None:
            return
        stop = self._stop = threading.Event()

        def _loop():
            while not stop.wait(self.interval):
                try:
                    self.tick()
                except Exception as e:  # pragma: no cover - keep ticking
                    _log.error("fleet policy: %s: %s", type(e).__name__, e)

        t = threading.Thread(target=_loop, daemon=True,
                             name="fleet-policy")
        t.start()

    def stop(self):
        if self._stop is not None:
            self._stop.set()
            self._stop = None

    def stats(self) -> Dict[str, Any]:
        with self._mu:
            return {"ticks": self._tick_n, "streak": self._streak,
                    "cooldown_until": self._cooldown_until,
                    "draining": sorted(self._draining)}

    # -- the decision loop ------------------------------------------------
    def tick(self) -> Dict[str, Any]:
        """One policy evaluation. Returns what it decided (and why) so
        tests and the selftest can assert the reasoning, not just the
        side effects."""
        _faults.fire("fleet.policy.tick")
        _m_ticks.inc()
        view = self._ctl.policy_view()
        with self._mu:
            self._tick_n += 1
            tick_n = self._tick_n
            # forget drains whose victim already left the table (the
            # scale_down below emits even for a vanished victim, so the
            # launcher still reaps the process)
            gone = [rid for rid in self._draining if rid not in view]
            for rid in gone:
                del self._draining[rid]
        for rid in gone:
            self._emit("scale_down", {"replica_id": rid,
                                      "reason": "drained_gone"})
            _m_down.inc()

        n = len(view)
        # replicas whose load we have not heard yet (just registered /
        # old member): totals over them would read as zero capacity and
        # trigger spurious scale-ups — abstain until the view is whole
        blind = [rid for rid, st in view.items() if st["load"] is None]
        if blind:
            return {"tick": tick_n, "decision": "abstain",
                    "reason": "awaiting_load", "blind": sorted(blind)}

        active = {rid: st for rid, st in view.items()
                  if not st["draining"]}
        free_total = sum(st["load"]["free_pages"]
                         for st in active.values())
        headroom_total = sum(st["load"]["queue_headroom"]
                             for st in active.values())
        under = (free_total < self.free_page_floor
                 or headroom_total < self.headroom_floor)

        # -- drain progression / cancellation -----------------------------
        with self._mu:
            draining = dict(self._draining)
        for rid in draining:
            st = view.get(rid)
            if st is None:
                continue
            load = st["load"]
            if under:
                # pressure arrived mid-drain: the capacity is still
                # registered — un-drain, cheaper than a spawn.
                # tick() is the only _draining writer and the pop keys
                # on rid alone, so the earlier snapshot read going
                # stale cannot lose an update
                self._ctl._set_draining(rid, False)
                # lint: allow-unguarded(_draining)
                with self._mu:
                    self._draining.pop(rid, None)
                _log.info("fleet policy: drain of %s CANCELLED "
                          "(pressure returned)", rid)
                return {"tick": tick_n, "decision": "undrain",
                        "replica": rid}
            if (load["queue_depth"] == 0 and load["live_slots"] == 0):
                # idle: the fleet stopped using it — hand to the
                # launcher. Single-writer keyed pop, as above.
                # lint: allow-unguarded(_draining)
                with self._mu:
                    self._draining.pop(rid, None)
                    self._cooldown_until = tick_n + self.cooldown
                self._emit("scale_down", {"replica_id": rid,
                                          "reason": "drained_idle"})
                _m_down.inc()
                _log.info("fleet policy: replica %s drained idle -> "
                          "scale_down", rid)
                return {"tick": tick_n, "decision": "scale_down",
                        "replica": rid}
            return {"tick": tick_n, "decision": "draining",
                    "replica": rid}

        # -- hysteresis bookkeeping ---------------------------------------
        with self._mu:
            self._streak = self._streak + 1 if under else 0
            streak = self._streak
            cooling = tick_n < self._cooldown_until

        # -- scale up -----------------------------------------------------
        want_up = (n < self.min_replicas
                   or (under and streak >= self.beats))
        if want_up and not cooling and n < self.max_replicas:
            rid = self._next_replica_id(view)
            # tick() is single-threaded (one policy loop per
            # controller): the streak/cooldown reads above cannot be
            # invalidated between the two critical sections
            # lint: allow-unguarded(_streak, _cooldown_until)
            with self._mu:
                self._streak = 0
                self._cooldown_until = tick_n + self.cooldown
            self._emit("scale_up", {"replica_id": rid,
                                    "reason": ("bootstrap"
                                               if n < self.min_replicas
                                               else "under_floor")})
            _m_up.inc()
            _log.info("fleet policy: scale_up -> %s (n=%d free=%d "
                      "headroom=%d streak=%d)", rid, n, free_total,
                      headroom_total, streak)
            return {"tick": tick_n, "decision": "scale_up",
                    "replica": rid, "free_pages": free_total,
                    "queue_headroom": headroom_total}

        # -- scale down (cache-aware victim) ------------------------------
        if (not under and not cooling and len(active) > self.min_replicas
                and len(active) > 1):
            victim, vload = self._coldest(active)
            keep_free = free_total - vload["free_pages"]
            keep_headroom = headroom_total - vload["queue_headroom"]
            # the dead band: only drain if the survivors retain
            # margin x BOTH floors — otherwise boundary load flaps
            if (keep_free >= self.margin * self.free_page_floor
                    and keep_headroom >= self.margin
                    * self.headroom_floor):
                self._ctl._set_draining(victim, True)
                # single-writer keyed insert (tick() is the only
                # _draining writer): the snapshot read above cannot be
                # invalidated by a concurrent mutation
                # lint: allow-unguarded(_draining)
                with self._mu:
                    self._draining[victim] = tick_n
                _m_drains.inc()
                _log.info("fleet policy: draining COLDEST replica %s "
                          "(cached_tokens=%d; survivors keep free=%d "
                          "headroom=%d)", victim,
                          vload["cached_tokens"], keep_free,
                          keep_headroom)
                return {"tick": tick_n, "decision": "drain",
                        "replica": victim,
                        "cached_tokens": vload["cached_tokens"]}

        return {"tick": tick_n, "decision": "hold", "under": under,
                "streak": streak, "free_pages": free_total,
                "queue_headroom": headroom_total}

    # -- helpers ----------------------------------------------------------
    @staticmethod
    def _coldest(active: Dict[str, Dict[str, Any]]):
        """The cache-aware drain order: least cached-token mass first,
        replica id as the deterministic tie-break. NEVER random — the
        whole point is that scale-down forfeits the minimum
        warm-routing value."""
        victim = min(active,
                     key=lambda rid: (active[rid]["load"]["cached_tokens"],
                                      rid))
        return victim, active[victim]["load"]

    def _next_replica_id(self, view: Dict[str, Any]) -> str:
        with self._mu:
            while True:
                self._spawn_n += 1
                rid = f"{self.replica_prefix}{self._spawn_n}"
                if rid not in view:
                    return rid

    def _emit(self, action: str, payload: Dict[str, Any]):
        """Append one SIGNED scale intent (in-process append — the
        policy lives next to the controller, but the signature still
        matters: the launcher may be remote and re-verifies)."""
        fields = _auth.signed_fields(action, "_fleet", payload)
        self._ctl._add_scale_intent(action, payload, **fields)
