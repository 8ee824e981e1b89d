"""Executable parameter server — cross-process async/sync SGD, the
counterpart of ``paddle_tpu/distributed/param_server.py``.

The reference's pserver is `listen_and_serv_op.cc:78-192`: block on N
gradient sends, run per-param optimize sub-blocks via an Executor, handle
sparse SelectedRows grads, answer parameter gets. This is that capability
around the port's stack: an RPC service (distributed/rpc.py framing)
wrapping an Executor that runs the per-param slices of
`DistributeTranspiler.get_pserver_program(ep)`.

  - push_grad(name, grad[, trainer_id]) — grad is dense ndarray OR
    SelectedRows (rows/value/height ride the wire, the row-wise lazy
    optimizer ops apply them without densifying). async mode applies
    immediately (reference sync_mode=False); sync mode accumulates until
    all `trainers` have pushed, sums (dense add / SelectedRows concat —
    reference listen_and_serv_op.cc:181-192), applies once, and releases
    the barrier.
  - get_param(name) — current value from the pserver scope.
  - barrier() — sync mode: wait until the current round's updates applied
    (the reference's send_barrier_op).

The pserver's Executor runs on ``device`` (``None``: the card, raising
without one), so the parameters and optimizer state live there; the RPC
server itself is host code. A tensor leaves the card by one explicit
device-to-host copy per tensor per message (``rpc._host``), and a pushed
gradient reaches the card as the Executor's feed. With
``PADDLE_TPU_DEBUG_PORT`` set, ``serve()`` attaches the process-shared
debug server and registers a ``pserver:<port>`` section in ``/statusz``
(the JAX server's keys: sync mode, trainers, round, steps, heartbeat
ages, evictions, pending pushes, the parameter table, the RPC dedup
cache).

Trainer side: `ParameterClient` (send/recv), or in-graph `send`/`recv`
ops the Executor runs as host ops (reference send_op.cc/recv_op.cc) —
see DistributeTranspiler.get_trainer_program(send_recv=True).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..observability import metrics as _metrics, tracing as _tracing
from ..observability.log import get_logger
from .rpc import RpcClient, RpcServer, _host

__all__ = ["ParameterServer", "ParameterClient", "get_client"]

_log = get_logger("pserver")

# push/pull volume counters plus the sync-mode
# barrier wait-time histogram — the number that shows straggler trainers
# (a fat p99 here IS the straggler, before anyone reads a timeline)
_m_push = _metrics.counter("pserver.push_grad")
_m_get = _metrics.counter("pserver.get_param")
_m_get_rows = _metrics.counter("pserver.get_rows")
_m_barrier_ms = _metrics.histogram("pserver.barrier_wait_ms")
# trainers whose heartbeat lease lapsed and were dropped from
# the sync barrier — each eviction is a round that DEGRADED instead of
# deadlocking
_m_evicted = _metrics.counter("pserver.evicted_trainers")


class ParameterServer:
    """Runs the optimize slice of a pserver program behind RPC."""

    def __init__(self, pserver_program, startup_program=None,
                 trainers: int = 1, sync_mode: bool = False, scope=None,
                 heartbeat_timeout: Optional[float] = None,
                 barrier_timeout: float = 120.0, device=None):
        """startup_program initializes a fresh scope; alternatively pass an
        already-populated `scope` (the ListenAndServ in-process form, where
        the server shares the builder's state).

        `heartbeat_timeout`: failure-detection lease in seconds. When set,
        a sync-mode trainer that has made contact (a push or a heartbeat
        RPC) and then goes silent for longer than this is EVICTED from the
        barrier: the round completes over the surviving trainers instead
        of deadlocking on the dead one. None (default) keeps the classic
        behavior — barrier waits the full `barrier_timeout`, then raises.

        `device`: where the optimizer runs and its state lives (a place,
        a torch.device or a string; None is the card, and raises
        without one)."""
        from .. import fluid

        if startup_program is None and scope is None:
            raise ValueError("need startup_program or a populated scope")
        self._trainers = max(1, int(trainers))
        self._sync = bool(sync_mode)
        self._hb_timeout = (None if heartbeat_timeout is None
                            else float(heartbeat_timeout))
        self._barrier_timeout = float(barrier_timeout)
        # failure detection: trainer_id -> last-contact monotonic time
        # (pushes piggyback a beat; ParameterClient can also run a
        # dedicated heartbeat thread), plus the evicted set. Guarded by
        # the big _cv lock like the rest of the sync bookkeeping.
        self._beats: Dict[int, float] = {}  # guarded-by: _cv
        self._evicted: set = set()  # guarded-by: _cv
        # trainer_id -> lifetime eviction count, echoed in barrier
        # replies so the EVICTED side learns its round was degraded (it
        # otherwise sees a successful barrier and never knows its
        # in-flight pushes were withdrawn)
        self._evict_count: Dict[int, int] = {}  # guarded-by: _cv
        self._scope = scope if scope is not None else fluid.Scope()
        self._exe = fluid.Executor(device)
        self._program = pserver_program
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._round = 0  # guarded-by: _cv
        # sync: param -> {trainer_id: grad} — DISTINCT trainers complete a
        # round (a retransmitted push overwrites, it can't phantom-complete)
        self._pending: Dict[str, Dict[int, Any]] = {}  # guarded-by: _cv
        self._applied_round: set = set()  # guarded-by: _cv
        self._steps = 0  # guarded-by: _shared_mu
        # async: one lock per param (concurrent cross-param applies);
        # _shared_mu guards the cycle bookkeeping + counters, and
        # _shared_run_mu serializes the stateful LR-chain executions
        self._param_locks: Dict[str, threading.Lock] = {}
        self._shared_mu = threading.Lock()
        self._shared_run_mu = threading.Lock()
        # params applied since the shared (LR-decay) program last ran: the
        # shared chain advances once per DISTINCT-PARAM CYCLE — a repeat
        # push means a new optimization step started — not once per
        # len(owned) raw pushes, which drifts when a sparse workload skips
        # params in a step
        self._applied_since_shared: set = set()  # guarded-by: _shared_mu

        block = pserver_program.global_block()
        self._owned = sorted(
            n for n, v in block.vars.items()
            if getattr(v.desc, "is_parameter", False)
        )
        self._param_locks = {p: threading.Lock() for p in self._owned}
        owned = set(self._owned)
        # a sync round is complete when every owned param that an op of
        # the program UPDATES has applied. The JAX server waits for every
        # owned param, and an owned param with no optimize op (a frozen
        # one: trainable=False, a position-encoding table) is never
        # pushed, so its every round timed out at the barrier.
        self._updated = {n for op in block.ops
                         for n in op.desc.output_names() if n in owned}
        # Split the pserver program (reference listen_and_serv: per-param
        # optimize sub-blocks + ONE lr-decay sub-block run once per round):
        #  - shared STATEFUL ops (advance persistable non-param state, e.g.
        #    the LR-decay step counter) run once per round, not once per
        #    param-push — otherwise a 2-param pserver would decay the LR
        #    twice per step;
        #  - everything else shared (stateless arithmetic) stays in each
        #    per-param slice, where recomputing it is free.
        persistable = {n for n, v in block.vars.items() if v.persistable}
        shared_stateful = []
        for op in block.ops:
            outs = set(op.desc.output_names())
            if not (outs & owned) and (outs & (persistable - owned)):
                shared_stateful.append(op)
        shared_idx = {id(op) for op in shared_stateful}

        def _slice(keep_pred):
            prog = pserver_program.clone()
            b = prog.global_block()
            keep = [op for orig, op in zip(block.ops, b.ops)
                    if keep_pred(orig)]
            b.ops = keep
            used = set(owned)
            for op in keep:
                used.update(n for n in op.desc.input_names() if n)
                used.update(n for n in op.desc.output_names() if n)
            b.vars = {n: v for n, v in b.vars.items() if n in used}
            prog._bump_version()
            return prog

        self._shared_prog = None
        if shared_stateful:
            self._shared_prog = _slice(lambda op: id(op) in shared_idx)
        self._per_param: Dict[str, Any] = {}
        self._grad_name: Dict[str, str] = {}
        for p in self._owned:
            def keep(op, p=p):
                outs = set(op.desc.output_names())
                if id(op) in shared_idx:
                    return False
                return p in outs or not (outs & owned)

            self._per_param[p] = _slice(keep)
            # the grad feed name is whatever the optimize op's Grad input
            # actually is (clipping/regularization can rename it)
            gname = p + "@GRAD"
            for op in block.ops:
                if p in set(op.desc.output_names()):
                    g = (op.desc.inputs.get("Grad") or [gname])[0]
                    gname = g or gname
                    break
            self._grad_name[p] = gname

        if startup_program is not None:
            self._exe.run(startup_program, scope=self._scope)

        # traffic evidence for the sparse-prefetch contract (trainer
        # traffic proportional to batch ids, not table size); incremented
        # from concurrent handler threads, so guarded by their own lock
        self._stats_mu = threading.Lock()
        self._full_pull_rows = 0  # guarded-by: _stats_mu
        self._prefetch_rows = 0  # guarded-by: _stats_mu

        self._server = RpcServer({
            "get_param": self.get_param,
            "get_rows": self.get_rows,
            "push_grad": self.push_grad,
            "barrier": self.barrier,
            "heartbeat": self.heartbeat,
            "owned_params": self.owned_params,
            "stats": self.stats,
        }, idempotent={
            # reads + beats: re-execution on retransmit is harmless, and
            # keeping their (large, for get_param) responses OUT of the
            # dedup cache bounds its memory to small push/barrier acks
            "get_param", "get_rows", "owned_params", "stats", "heartbeat",
        })

    # --- RPC methods ---------------------------------------------------
    def owned_params(self) -> List[str]:
        return list(self._owned)

    def stats(self) -> Dict[str, int]:
        """Evidence of server-side work: optimize steps applied + round +
        rows served via full pulls vs row-granular prefetches. Each field
        is read under ITS guard (sequentially, never nested): _evicted /
        _round under _cv (barrier threads mutate them concurrently, and
        iterating a set mid-mutation raises), _steps under _shared_mu
        (concurrent _apply threads increment it there), the pull-row
        tallies under _stats_mu (the handler threads write them
        there)."""
        with self._shared_mu:
            steps = self._steps
        with self._stats_mu:
            full_pull_rows = self._full_pull_rows
            prefetch_rows = self._prefetch_rows
        with self._cv:
            return {"steps": steps, "round": self._round,
                    "sync": self._sync, "trainers": self._trainers,
                    "evicted": sorted(self._evicted),
                    "full_pull_rows": full_pull_rows,
                    "prefetch_rows": prefetch_rows}

    def heartbeat(self, trainer_id: int = 0):
        """Failure-detection beat (reference go/pserver etcd TTL-lease
        keepalive). Refreshes the trainer's lease; deliberately does NOT
        resurrect an evicted trainer — only a fresh push_grad (evidence
        of forward progress) rejoins it, so a paused process whose
        heartbeat thread wakes first can't re-wedge the barrier it was
        evicted from. The reply tells the trainer its own standing."""
        with self._cv:
            tid = int(trainer_id)
            if self._hb_timeout is not None and tid not in self._evicted:
                self._beats[tid] = time.monotonic()
            return {"round": self._round, "evicted": tid in self._evicted}

    def get_param(self, name: str):
        if name not in self._owned:
            raise KeyError(f"param '{name}' is not owned by this pserver")
        _m_get.inc()
        arr = _host(self._scope.find_var(name))
        with self._stats_mu:
            self._full_pull_rows += int(arr.shape[0]) if arr.ndim else 1
        return arr

    def get_rows(self, name: str, rows):
        """Row-granular pull: only the requested embedding rows ride the
        wire (reference prefetch_op.cc + the distributed-lookup-table
        design doc — the capability that lets a vocab far larger than one
        trainer's memory train efficiently)."""
        if name not in self._owned:
            raise KeyError(f"param '{name}' is not owned by this pserver")
        _m_get_rows.inc()
        rows = np.asarray(rows, dtype=np.int64).reshape(-1)
        table = self._scope.find_var(name)
        if rows.size and (rows.min() < 0 or rows.max() >= table.shape[0]):
            raise IndexError(
                f"prefetch rows out of range for '{name}' "
                f"[0, {table.shape[0]})"
            )
        with self._stats_mu:
            self._prefetch_rows += int(rows.size)
        # the rows are gathered where the table lives; only they leave it
        return _host(table[torch.tensor(rows, device=table.device)])

    def push_grad(self, name: str, grad, trainer_id: int = 0):
        if name not in self._owned:
            raise KeyError(f"param '{name}' is not owned by this pserver")
        _m_push.inc()
        if not self._sync:
            # hogwild-style async with PER-PARAM atomicity: updates to one
            # param serialize (an unserialized read-modify-write would drop
            # whole gradients), while different params apply CONCURRENTLY
            # from different handler threads — the reference pserver's
            # per-block locking (parameter_server2's block-sharded applies)
            with self._param_locks[name]:
                self._apply(name, grad)
            # monitoring echo, read under each field's own guard (bare
            # reads would race concurrent applies)
            with self._shared_mu:
                step = self._steps
            with self._cv:
                rnd = self._round
            return {"step": step, "round": rnd}
        with self._cv:
            tid = int(trainer_id)
            self._note_push_locked(tid)
            # the round this grad belongs to, BEFORE any completion this
            # push might trigger — the trainer barriers on it (its whole
            # step's pushes share it: a round cannot complete without this
            # trainer's last push, so it can't advance mid-step)
            round_of_push = self._round
            self._pending.setdefault(name, {})[tid] = grad
            self._try_complete_locked(name)
        # step echo read under ITS guard (_shared_mu), after _cv released
        with self._shared_mu:
            step = self._steps
        return {"step": step, "round": round_of_push}

    def barrier(self, known_round: Optional[int] = None,
                trainer_id: Optional[int] = None):
        """Sync mode: block until round `known_round` (the value push_grad
        returned for this trainer's sends) has completed (reference
        send_barrier_op: send, barrier, recv). Waiting on a round NUMBER —
        not on queue emptiness — keeps a fast trainer's next-round pushes
        from wedging a slow trainer's barrier. known_round=None just
        reports the current round.

        With heartbeat_timeout set, the wait loop doubles as the failure
        detector: each wake-up evicts trainers whose lease lapsed, which
        can complete the round over the survivors — one dead trainer
        degrades the round instead of deadlocking it. `trainer_id` names
        the CALLER so its own lease refreshes while it is parked here (a
        waiting trainer is alive by definition)."""
        if not self._sync or known_round is None:
            with self._cv:  # _round is _cv-guarded state
                return {"round": self._round}
        target = int(known_round) + 1
        t0 = time.perf_counter()
        deadline = time.monotonic() + self._barrier_timeout
        # wake often enough to evict promptly; without heartbeats one
        # full-length wait preserves the classic single-sleep behavior
        step = (self._barrier_timeout if self._hb_timeout is None
                else max(0.05, self._hb_timeout / 4.0))
        with self._cv, _tracing.span("pserver.barrier", round=target):
            while self._round < target:
                if (trainer_id is not None and self._hb_timeout is not None
                        and int(trainer_id) not in self._evicted):
                    self._beats[int(trainer_id)] = time.monotonic()
                self._evict_dead_locked()
                if self._round >= target:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    _m_barrier_ms.observe((time.perf_counter() - t0) * 1e3)
                    raise TimeoutError(
                        f"sync round {known_round} incomplete after "
                        f"{self._barrier_timeout:.0f}s — a trainer died "
                        f"mid-round (pending: {list(self._pending)})")
                self._cv.wait(min(step, remaining))
            _m_barrier_ms.observe((time.perf_counter() - t0) * 1e3)
            out = {"round": self._round}
            if trainer_id is not None:
                out["evictions"] = self._evict_count.get(int(trainer_id), 0)
            return out

    # --- failure detection (all under the _cv lock) ----------------------
    def _live_count_locked(self) -> int:
        return max(1, self._trainers - len(self._evicted))

    def _note_push_locked(self, tid: int):
        """A push is evidence of forward progress: refresh the lease AND
        rejoin an evicted trainer (elastic restart — its resumed step's
        grads count toward rounds again)."""
        if self._hb_timeout is None:
            return
        self._beats[tid] = time.monotonic()
        if tid in self._evicted:
            self._evicted.discard(tid)
            _log.warning("pserver: trainer %d rejoined after eviction "
                         "(round %d)", tid, self._round)

    def _evict_dead_locked(self) -> bool:
        """Drop trainers whose heartbeat lease lapsed, withdraw their
        partial-round pushes (they belong to a step the trainer never
        finished), and re-check round completion at the reduced quorum.
        Only trainers that made contact at least once are evictable —
        the detector can't distinguish 'never started' from 'dead', and
        startup must not race the lease."""
        if self._hb_timeout is None:
            return False
        now = time.monotonic()
        newly = [tid for tid, t in self._beats.items()
                 if tid not in self._evicted and now - t > self._hb_timeout]
        if not newly:
            return False
        for tid in newly:
            self._evicted.add(tid)
            self._evict_count[tid] = self._evict_count.get(tid, 0) + 1
            _m_evicted.inc()
            _log.warning(
                "pserver: evicting trainer %d — no heartbeat for %.2fs "
                "(lease %.2fs); round %d degrades to %d live trainers",
                tid, now - self._beats[tid], self._hb_timeout, self._round,
                self._live_count_locked())
            for d in self._pending.values():
                d.pop(tid, None)
        self._try_complete_locked()
        return True

    def _try_complete_locked(self, name: Optional[str] = None):
        """Apply every pending param whose DISTINCT live pushes reach the
        live-trainer quorum; advance the round when every updated owned
        param has applied (an empty pending map alone is not enough —
        params not yet pushed this round leave it empty too)."""
        live = self._live_count_locked()
        for n in ([name] if name is not None else list(self._pending)):
            d = self._pending.get(n)
            if d and len(d) >= live:
                merged = _merge_grads(list(self._pending.pop(n).values()))
                self._apply(n, merged)
                self._applied_round.add(n)
        if self._applied_round >= self._updated:
            self._applied_round.clear()
            self._round += 1
            self._cv.notify_all()

    # --- internals -----------------------------------------------------
    def _apply(self, name: str, grad):
        """Caller holds this param's lock (async) or the big cv lock
        (sync). Cross-param concurrency is safe: per-param programs write
        disjoint scope names; the shared LR chain's cycle bookkeeping and
        its stateful execution take their own locks (an apply may read an
        LR mid-decay of a concurrent cycle boundary — the documented
        hogwild staleness, not a lost update)."""
        # shared stateful chain (LR-decay counters) advances once per
        # distinct-param cycle: at the first push ever, and whenever a
        # param REPEATS (its second push means a new step began)
        run_shared = False
        with self._shared_mu:
            if name in self._applied_since_shared or \
                    not self._applied_since_shared:
                run_shared = self._shared_prog is not None
                self._applied_since_shared = set()
            self._applied_since_shared.add(name)
        if run_shared:
            with self._shared_run_mu:
                self._exe.run(self._shared_prog, scope=self._scope)
        with _tracing.span("pserver.apply", param=name):
            # the Executor's feed puts the pushed gradient on its device
            self._exe.run(self._per_param[name],
                          feed={self._grad_name[name]: grad},
                          scope=self._scope)
        with self._shared_mu:
            self._steps += 1

    # --- introspection ---------------------------------------------------
    def _debug_status(self) -> Dict[str, Any]:
        """The /statusz view: param table, round/step progress, and the
        failure detector's live heartbeat ages — the page an operator
        reads to tell a straggler from a dead trainer without attaching
        a debugger. Under the _cv lock like stats()."""
        now = time.monotonic()
        params = {}
        for p in self._owned:
            v = self._scope.find_var(p)
            # numpy's dtype names, read without copying the tensor
            params[p] = ({"shape": list(v.shape),
                          "dtype": str(v.dtype).replace("torch.", "")}
                         if v is not None else None)
        with self._shared_mu:  # _steps is _shared_mu state, like stats()
            steps = self._steps
        with self._cv:
            beats = {str(tid): round(now - t, 3)
                     for tid, t in self._beats.items()}
            out = {
                "sync": self._sync,
                "trainers": self._trainers,
                "round": self._round,
                "steps": steps,
                "heartbeat_timeout_s": self._hb_timeout,
                "heartbeat_age_s": beats,
                "evicted": sorted(self._evicted),
                "pending_params": {n: sorted(d)
                                   for n, d in self._pending.items()},
            }
        out["params"] = params
        out["rpc"] = self._server.stats()  # dedup-cache occupancy
        return out

    # --- lifecycle -----------------------------------------------------
    def serve(self, host: str = "127.0.0.1", port: int = 0
              ) -> Tuple[str, int]:
        addr = self._server.serve(host, port)
        if _tracing.process_label() is None:
            _tracing.set_process_label(f"pserver:{addr[1]}")
        # PADDLE_TPU_DEBUG_PORT attaches the process-shared debug HTTP
        # server; this pserver's state appears under /statusz
        from ..observability import debug_server as _dbg

        self._debug_key = f"pserver:{addr[1]}"
        if _dbg.maybe_serve_from_env(device=self.device) is not None:
            _dbg.add_status(self._debug_key, self._debug_status)
        return addr

    @property
    def address(self):
        return self._server.address

    @property
    def device(self) -> torch.device:
        return self._exe.device

    def shutdown(self):
        from ..observability import debug_server as _dbg

        _dbg.remove_status(getattr(self, "_debug_key", None))
        self._server.shutdown()


def _merge_grads(grads: List[Any]):
    """Sum a sync round's gradients (reference listen_and_serv_op.cc
    :181-192: dense sum / SelectedRows concat-then-merge)."""
    from ..fluid.selected_rows import SelectedRows, is_selected_rows

    if any(is_selected_rows(g) for g in grads):
        rows = np.concatenate([_host(g.rows) for g in grads])
        value = np.concatenate([_host(g.value) for g in grads])
        return SelectedRows(rows, value, grads[0].height)
    out = _host(grads[0])
    for g in grads[1:]:
        out = out + _host(g)
    return out


class ParameterClient:
    """Trainer-side client (reference operators/detail/grpc_client.cc +
    send_op/recv_op): push grads to / pull params from the pserver that
    owns each variable."""

    def __init__(self, assignment: Dict[str, str], trainer_id: int = 0,
                 heartbeat_interval: Optional[float] = None):
        """assignment: param name -> "host:port" endpoint
        (DistributeTranspiler.param_assignment).

        `heartbeat_interval`: when set, a daemon thread beats every
        assigned pserver this often so the server's failure detector can
        tell 'slow' from 'dead' (set it well under the server's
        heartbeat_timeout — a third is the usual lease ratio). Without
        it, pushes still piggyback a beat, so a trainer that dies
        between steps is detected either way."""
        self._assignment = dict(assignment)
        self._trainer_id = int(trainer_id)
        # endpoint -> round of this step's first send, consumed by barrier()
        self._send_round: Dict[str, int] = {}
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        if heartbeat_interval:
            self._hb_interval = float(heartbeat_interval)
            # dedicated FAIL-FAST clients, one per endpoint: a beat must
            # never queue behind a large push on the shared data
            # connection, and — since the loop visits endpoints
            # sequentially — a single dead pserver must not hold the
            # thread through a long timeout/retry budget while HEALTHY
            # pservers miss this trainer's beats and falsely evict it.
            # The next interval is the retry.
            self._hb_clients = {
                ep: RpcClient(ep, timeout=max(1.0, 2 * self._hb_interval),
                              retries=0)
                for ep in set(self._assignment.values())}
            self._hb_thread = threading.Thread(
                target=self._beat_loop, daemon=True,
                name=f"pserver-heartbeat-t{self._trainer_id}")
            self._hb_thread.start()

    def _beat_loop(self):
        while not self._hb_stop.wait(self._hb_interval):
            for c in self._hb_clients.values():
                try:
                    c.call("heartbeat", self._trainer_id)
                except Exception:
                    pass  # an unreachable pserver must not kill the beat

    def stop_heartbeat(self):
        """Stop beating (tests use this to simulate a silent death)."""
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5)
            self._hb_thread = None
            for c in self._hb_clients.values():
                c.close()

    def close(self):
        self.stop_heartbeat()

    def _client(self, name: str) -> RpcClient:
        ep = self._assignment.get(name)
        if ep is None:
            raise KeyError(f"no pserver assignment for '{name}'")
        return get_client(ep)

    def send_grad(self, name: str, grad):
        resp = self._client(name).call("push_grad", name, grad,
                                       self._trainer_id)
        ep = self._assignment[name]
        if isinstance(resp, dict) and ep not in self._send_round:
            # remember which round this step's pushes joined, so a bare
            # barrier() can wait on the right round number
            self._send_round[ep] = resp.get("round")
        return resp

    def get_param(self, name: str) -> np.ndarray:
        """Zero-copy pull: the result is a READ-ONLY view over the RPC
        frame's bytes (copy_result=False) — get_param is an idempotent
        read whose result feeds device transfer/math; the old
        per-segment receive copy was pure overhead on the largest
        tensors the wire carries. Callers needing in-place mutation
        must .copy() (numpy raises on write, so misuse is loud)."""
        return self._client(name).call("get_param", name,
                                       copy_result=False)

    def get_rows(self, name: str, rows) -> np.ndarray:
        """Pull only the given rows of a (large) table — the trainer-side
        half of the reference's prefetch_op. Read-only zero-copy view,
        like get_param."""
        return self._client(name).call(
            "get_rows", name, np.asarray(rows, dtype=np.int64),
            copy_result=False)

    def barrier(self, known_round=None):
        """Wait until the round this client's sends joined has fully
        applied (reference send_barrier_op). known_round: None (use the
        rounds recorded by send_grad since the last barrier — the normal
        send/barrier/recv flow), an int, or a dict endpoint->round. Runs on
        the dedicated barrier channel so it can't block pushes sharing the
        endpoint."""
        rounds = self._send_round if known_round is None else known_round
        done = {}
        for ep in set(self._assignment.values()):
            r = rounds.get(ep) if isinstance(rounds, dict) else rounds
            # per-trainer channel: two in-process trainers must not
            # serialize their (long) barrier waits on one shared
            # connection; trainer_id rides along so the server refreshes
            # the caller's heartbeat lease while it is parked
            done[ep] = get_client(
                ep, channel=f"barrier.{self._trainer_id}").call(
                    "barrier", r, self._trainer_id)
            note_barrier_reply(ep, self._trainer_id, done[ep])
        if known_round is None:
            self._send_round = {}
        return done

    def pull_all(self, scope=None, device=None) -> Dict[str, np.ndarray]:
        """Fetch every assigned param; writes into `scope` when given
        (the reference recv+concat step after the barrier), as a tensor
        on `device` — by default the device of the value the scope
        holds under that name, else the CPU."""
        out = {}
        for name in self._assignment:
            out[name] = self.get_param(name)
            if scope is not None:
                old = scope.find_var(name)
                dev = device if device is not None else getattr(
                    old, "device", "cpu")
                scope.set_var(name, torch.tensor(out[name], device=dev))
        return out


_eviction_seen: Dict[Tuple[str, int], int] = {}
_eviction_seen_mu = threading.Lock()


def note_barrier_reply(endpoint: str, trainer_id: int, resp) -> bool:
    """Client-side eviction detector, shared by ParameterClient.barrier
    and the executor's send_barrier host op: a growing `evictions` count
    in the barrier reply means THIS trainer was declared dead mid-round
    and its in-flight pushes were withdrawn — a successful-looking
    barrier that silently degraded the round. Warn loudly (the fix is a
    heartbeat_timeout above worst-case step time), return True if a new
    eviction was seen."""
    if not isinstance(resp, dict) or "evictions" not in resp:
        return False
    key = (endpoint, int(trainer_id))
    with _eviction_seen_mu:
        prev = _eviction_seen.get(key, 0)
        cur = int(resp["evictions"])
        _eviction_seen[key] = cur
    if cur > prev:
        _log.warning(
            "trainer %d was EVICTED by pserver %s %d time(s) since last "
            "seen: a round completed without this trainer's gradients "
            "(step time likely exceeded the server's heartbeat_timeout "
            "— raise it above the worst-case step, or beat via "
            "ParameterClient(heartbeat_interval=...))",
            trainer_id, endpoint, cur - prev)
        return True
    return False


_clients: Dict[Tuple[str, str], RpcClient] = {}
_clients_mu = threading.Lock()

# barrier channels wait for a whole sync round to complete server-side:
# their socket timeout must comfortably exceed ANY configurable server
# barrier_timeout, or a legitimately slow round reads as a dead
# connection and the healthy trainer dies retrying (a truly dead server
# still surfaces instantly as a connection reset, not a timeout)
BARRIER_CLIENT_TIMEOUT = 3600.0


def get_client(endpoint: str, channel: str = "data",
               timeout: Optional[float] = None) -> RpcClient:
    """Process-wide client cache, one connection per (endpoint, channel)
    (the reference's grpc channel cache). Blocking calls (barrier) use
    their own channel so they can't starve data-plane pushes that share
    the endpoint. `timeout` applies only when the channel's client is
    first created; barrier channels default to BARRIER_CLIENT_TIMEOUT."""
    with _clients_mu:
        key = (endpoint, channel)
        c = _clients.get(key)
        if c is None:
            kw = {}
            if channel.startswith("barrier"):
                # long reads (a whole slow round), but: fast dial (the
                # default connect_timeout), and a single reconnect —
                # retrying a barrier that already waited out a long
                # timeout is useless (that round is ancient history)
                kw = {"timeout": (BARRIER_CLIENT_TIMEOUT
                                  if timeout is None else timeout),
                      "retries": 1}
            elif timeout is not None:
                kw = {"timeout": timeout}
            c = _clients[key] = RpcClient(endpoint, **kw)
        return c
