"""ReplicaLauncher — turns scale intents into real replica processes
(the counterpart of ``paddle_tpu/fleet/launcher.py``).

The policy loop (fleet/policy.py) DECIDES; this is the pair of hands:
a supervisor that tails the controller's scale-intent channel and keeps
the actual OS processes converged to it (children are watched,
restarted with backoff, and reaped — never orphaned).

  * `scale_up {replica_id}`  -> spawn a replica subprocess. The default
    command is `python -m paddle_tpu_torch.fleet --replica --device D`
    pointed at this controller, where D is the launcher's own device
    (``device=None``: the card, and the launcher raises without one);
    tests inject `command_factory` to spawn anything (a
    crash-looping `sys.exit(7)`, a sleep) without a serving stack. The
    child inherits the environment, so a keyed fleet's
    PADDLE_TPU_FLEET_KEY / PADDLE_TPU_FLEET_ALLOW reach the member
    inside the child with zero flag plumbing — which is how a
    launcher-spawned replica verifies checkpoint-dir deploy intents it
    replays from the log.

  * a child that EXITS without being told to is a CRASH: it is
    restarted with exponential backoff (`fleet_launcher_backoff` base,
    doubling per consecutive crash, capped) under its SAME replica_id —
    the member's stable-id discipline means the resurrected process
    re-registers as the same fleet citizen and re-converges from the
    intent log. This is the soak's resurrection path: SIGKILL a
    replica mid-stream and the launcher brings it back unprompted.

  * `scale_down {replica_id}` -> STOP, not kill: SIGTERM first (the
    replica CLI mode traps it and deregisters cleanly), SIGKILL only
    after a grace period, and no restart — `stopped` children are
    reaped, not resurrected.

Scale intents are verified against the fleet key before acting
(fleet/auth.py): the launcher spawns PROCESSES — the one consumer
where acting on a forged intent costs real resources — so it refuses
unsigned/tampered/replayed intents even though the controller already
checked them at append (a spoofed controller must not command spawns).

Everything runs on ONE supervisor thread calling `poll_once()`; tests
call `poll_once()` directly for sleep-free, counter-exact assertions.
"""
from __future__ import annotations

import atexit
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..distributed import faults as _faults
from ..distributed.rpc import RpcClient
from ..observability import metrics as _metrics
from ..observability.log import get_logger
from . import auth as _auth

__all__ = ["ReplicaLauncher"]

_log = get_logger("fleet")

_m_spawns = _metrics.counter("fleet.launcher.spawns")
_m_restarts = _metrics.counter("fleet.launcher.restarts")
_m_stops = _metrics.counter("fleet.launcher.stops")
_m_reaped = _metrics.counter("fleet.launcher.reaped")


class ReplicaLauncher:
    """Supervises replica subprocesses against the controller's
    scale-intent channel."""

    def __init__(self, controller_addr,
                 command_factory: Optional[
                     Callable[[str], List[str]]] = None,
                 poll_interval: float = 0.2,
                 grace: float = 5.0,
                 backoff: Optional[float] = None,
                 backoff_cap: Optional[float] = None,
                 env: Optional[Dict[str, str]] = None,
                 start: bool = True, device=None):
        from ..device import resolve_device
        from ..flags import FLAGS

        self.device = resolve_device(device)
        self._ctl_addr = (str(controller_addr[0]),
                          int(controller_addr[1]))
        self._command_factory = command_factory or self._default_command
        self.poll_interval = float(poll_interval)
        self.grace = float(grace)
        self.backoff = float(FLAGS["fleet_launcher_backoff"]
                             if backoff is None else backoff)
        self.backoff_cap = (16.0 * self.backoff if backoff_cap is None
                            else float(backoff_cap))
        self._env = dict(env) if env else None
        self._mu = threading.Lock()
        # rid -> {proc, crashes, restart_at, stopped, stop_deadline,
        #         cmd}; guarded-by: _mu
        self._procs: Dict[str, Dict[str, Any]] = {}
        self._seq = 0  # scale-intent watermark; guarded-by: _mu
        self._nonces = _auth.NonceWindow()
        self._cli: Optional[RpcClient] = None
        self._stop_evt: Optional[threading.Event] = None
        # belt-and-braces orphan reaping: even if stop() is never
        # called, interpreter exit must not leave replica processes
        # running
        atexit.register(self._reap_all)
        if start:
            self.start()

    def _default_command(self, rid: str) -> List[str]:
        host, port = self._ctl_addr
        return [sys.executable, "-m", "paddle_tpu_torch.fleet",
                "--replica", "--controller-addr", f"{host}:{port}",
                "--replica-id", rid, "--device", str(self.device)]

    # -- lifecycle --------------------------------------------------------
    def start(self):
        if self._stop_evt is not None:
            return
        stop = self._stop_evt = threading.Event()

        def _loop():
            while not stop.wait(self.poll_interval):
                try:
                    self.poll_once()
                except Exception as e:  # pragma: no cover - keep going
                    _log.error("fleet launcher: %s: %s",
                               type(e).__name__, e)

        t = threading.Thread(target=_loop, daemon=True,
                             name="fleet-launcher")
        t.start()

    def stop(self, timeout: Optional[float] = None):
        """Stop supervising and stop every child (SIGTERM, grace,
        SIGKILL) — nothing this launcher spawned may outlive it."""
        if self._stop_evt is not None:
            self._stop_evt.set()
            self._stop_evt = None
        grace = self.grace if timeout is None else float(timeout)
        with self._mu:
            recs = list(self._procs.values())
        for rec in recs:
            rec["stopped"] = True
            proc = rec["proc"]
            if proc is not None and proc.poll() is None:
                self._signal(proc, signal.SIGTERM)
        deadline = time.monotonic() + grace
        for rec in recs:
            proc = rec["proc"]
            if proc is None:
                continue
            remaining = max(0.0, deadline - time.monotonic())
            try:
                proc.wait(remaining)
            except subprocess.TimeoutExpired:
                self._signal(proc, signal.SIGKILL)
                proc.wait(5.0)
            _m_reaped.inc()
        if self._cli is not None:
            self._cli.close()
            self._cli = None

    def _reap_all(self):  # pragma: no cover - atexit path
        with self._mu:
            recs = list(self._procs.values())
        for rec in recs:
            proc = rec["proc"]
            if proc is not None and proc.poll() is None:
                self._signal(proc, signal.SIGKILL)
                try:
                    proc.wait(2.0)
                except subprocess.TimeoutExpired:
                    pass

    @staticmethod
    def _signal(proc, sig):
        try:
            proc.send_signal(sig)
        except (ProcessLookupError, OSError):
            pass  # already gone

    # -- the supervision loop ---------------------------------------------
    def poll_once(self):
        """One supervisor pass: consume new scale intents, then
        supervise children (restart crashed, escalate stuck stops,
        reap exited)."""
        self._consume_intents()
        self._supervise()

    def _consume_intents(self):
        with self._mu:
            since = self._seq
        try:
            if self._cli is None:
                self._cli = RpcClient(self._ctl_addr, timeout=10.0,
                                      retries=0)
            intents = self._cli.call("scale_intents", since)
        except (ConnectionError, OSError, RuntimeError) as e:
            _log.warning("fleet launcher: intent fetch failed (%s)", e)
            if self._cli is not None:
                self._cli.close()
                self._cli = None
            return
        for intent in intents:
            seq = int(intent.get("seq", 0))
            # max() re-validates under the lock, so the fetch-time
            # read going stale cannot regress the watermark
            # lint: allow-unguarded(_seq)
            with self._mu:
                self._seq = max(self._seq, seq)
            try:
                # the launcher ACTS on intents (spawns processes):
                # re-verify even though the controller checked at
                # append — a spoofed controller must not command spawns
                _auth.verify_intent(_auth.intent_key(), intent,
                                    window=self._nonces,
                                    prev_key=_auth.intent_key_prev())
            except _auth.IntentRefused as e:
                _log.error("fleet launcher: scale intent #%d REFUSED: "
                           "%s", seq, e)
                continue
            action = intent.get("action")
            payload = dict(intent.get("payload") or {})
            rid = str(payload.get("replica_id") or "")
            if not rid:
                _log.warning("fleet launcher: scale intent #%d without "
                             "replica_id skipped", seq)
                continue
            if action == "scale_up":
                self._handle_scale_up(rid)
            elif action == "scale_down":
                self._handle_scale_down(rid)

    def _handle_scale_up(self, rid: str):
        with self._mu:
            rec = self._procs.get(rid)
            if rec is not None and not rec["stopped"]:
                return  # already supervising it (idempotent)
            self._procs[rid] = {"proc": None, "crashes": 0,
                                "restart_at": 0.0, "stopped": False,
                                "stop_deadline": None,
                                "cmd": self._command_factory(rid)}
        self._spawn(rid, restart=False)

    def _handle_scale_down(self, rid: str):
        with self._mu:
            rec = self._procs.get(rid)
            if rec is None:
                return
            rec["stopped"] = True
            rec["stop_deadline"] = time.monotonic() + self.grace
            proc = rec["proc"]
        _m_stops.inc()
        if proc is not None and proc.poll() is None:
            self._signal(proc, signal.SIGTERM)
        _log.info("fleet launcher: stopping replica %s (SIGTERM, "
                  "%.1fs grace)", rid, self.grace)

    def _spawn(self, rid: str, restart: bool):
        _faults.fire("fleet.launcher.spawn")
        with self._mu:
            rec = self._procs.get(rid)
            if rec is None or rec["stopped"]:
                return
            cmd = rec["cmd"]
        env = dict(os.environ)
        if self._env:
            env.update(self._env)
        proc = subprocess.Popen(cmd, env=env,
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
        with self._mu:
            rec["proc"] = proc
            rec["restart_at"] = None
        (_m_restarts if restart else _m_spawns).inc()
        _log.info("fleet launcher: %s replica %s (pid %d)",
                  "restarted" if restart else "spawned", rid, proc.pid)

    def _supervise(self):
        now = time.monotonic()
        pending_restart = []
        with self._mu:
            for rid, rec in list(self._procs.items()):
                proc = rec["proc"]
                alive = proc is not None and proc.poll() is None
                if rec["stopped"]:
                    if alive and rec["stop_deadline"] is not None \
                            and now >= rec["stop_deadline"]:
                        # grace expired: escalate to SIGKILL
                        self._signal(proc, signal.SIGKILL)
                        rec["stop_deadline"] = None
                    elif not alive and proc is not None:
                        # clean (or escalated) exit: reap once
                        rec["proc"] = None
                        _m_reaped.inc()
                    continue
                if alive:
                    continue
                if proc is not None:
                    # unexpected exit = crash: schedule a backed-off
                    # restart under the SAME replica id
                    rec["crashes"] += 1
                    delay = min(self.backoff_cap,
                                self.backoff
                                * (2.0 ** (rec["crashes"] - 1)))
                    rec["restart_at"] = now + delay
                    _log.warning(
                        "fleet launcher: replica %s died (exit %s, "
                        "crash #%d) — restart in %.2fs", rid,
                        proc.returncode, rec["crashes"], delay)
                    rec["proc"] = None
                    _m_reaped.inc()
                if (rec["restart_at"] is not None
                        and now >= rec["restart_at"]):
                    pending_restart.append(rid)
        for rid in pending_restart:
            self._spawn(rid, restart=True)

    # -- chaos + introspection --------------------------------------------
    def kill_replica(self, rid: str) -> Optional[int]:
        """Chaos seam: SIGKILL a supervised replica WITHOUT marking it
        stopped — the crash-restart path resurrects it. Returns the
        killed pid (None if not running)."""
        with self._mu:
            rec = self._procs.get(str(rid))
            proc = rec["proc"] if rec else None
        if proc is None or proc.poll() is not None:
            return None
        pid = proc.pid
        self._signal(proc, signal.SIGKILL)
        return pid

    def pid_of(self, rid: str) -> Optional[int]:
        with self._mu:
            rec = self._procs.get(str(rid))
            proc = rec["proc"] if rec else None
        return proc.pid if proc is not None and proc.poll() is None \
            else None

    def stats(self) -> Dict[str, Any]:
        with self._mu:
            return {
                "seq": self._seq,
                "replicas": {
                    rid: {"pid": (rec["proc"].pid
                                  if rec["proc"] is not None else None),
                          "alive": (rec["proc"] is not None
                                    and rec["proc"].poll() is None),
                          "crashes": rec["crashes"],
                          "stopped": rec["stopped"]}
                    for rid, rec in self._procs.items()},
            }
