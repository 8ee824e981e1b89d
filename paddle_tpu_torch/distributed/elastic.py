"""Elastic trainer: the checkpoint-resume loop that makes a KILLED
trainer a non-event — the counterpart of
``paddle_tpu/distributed/elastic.py`` over the port's Fluid checkpoints
(``fluid.io.save_checkpoint``/``load_checkpoint``, the JAX package's
format, so a trainer of either package resumes from the other's).

The reference's fault-tolerant cloud story composes three pieces: the
Go master re-serves a dead trainer's data shard when its lease lapses
(go/master/service.go:341), checkpoints carry a crc so a torn write is
detected (go/pserver/service.go:53), and a restarted worker re-registers
and resumes. Our stack has each piece (distributed/master.py leases,
fluid/io.py save/load_checkpoint, membership.WorkerRegistry); this
module is the loop that composes them:

    trainer = ElasticTrainer(master_client, ckpt_dir,
                             main_program=main, scope=scope,
                             device=exe.device)
    stats = trainer.run_pass(train_on_task)   # resumes automatically

Per leased task: run the user's training callback, checkpoint the
program's persistables, THEN report task_finished — a crash anywhere in
between re-runs that task from the checkpointed params (at-least-once
training, the same contract lease expiry already gives data delivery).
A restarted process pointed at the same ckpt_dir loads the latest
intact checkpoint, counts an `elastic.resumes`, and keeps draining the
master's queue from wherever the fleet left it.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

from ..observability import metrics as _metrics, tracing as _tracing
from ..observability.log import get_logger
from .master import MasterClient

__all__ = ["ElasticTrainer"]

_log = get_logger("elastic")
_m_resumes = _metrics.counter("elastic.resumes")
_m_tasks = _metrics.counter("elastic.tasks_trained")


class ElasticTrainer:
    """Lease tasks from the master, train, checkpoint, survive restarts.

    `train_on_task(task)` is the user's callback: run the training steps
    for one leased `Task` (its `.paths` recordio shards) inside the
    scope this trainer checkpoints. Raising from it fails the lease
    (the master requeues, failure_max applies); everything else is
    handled here.
    """

    def __init__(self, master: MasterClient, ckpt_dir: str,
                 main_program=None, scope=None, registry=None,
                 checkpoint_every: int = 1, max_to_keep: int = 3,
                 poll_interval: float = 0.2, idle_timeout: float = 60.0,
                 device=None):
        """`registry`: optional membership.WorkerRegistry — kept
        registered across the loop (a worker that lost its slot in a
        long GC pause re-claims one instead of silently vanishing from
        the elastic view). `checkpoint_every`: tasks between checkpoints
        (default 1). task_finished reports are DEFERRED to the next
        covering checkpoint, so larger values trade longer lease
        holds + more re-training after a crash for fewer checkpoint
        writes — never lost updates.
        `idle_timeout`: give up waiting for new tasks after this long
        with the queue non-empty but nothing leasable (another trainer
        holds the last leases).
        `device`: where a resumed checkpoint's tensors go — the device of
        the Executor that trains (a place, a torch.device or a string;
        None is the card, and raises without one)."""
        self._master = master
        self._ckpt_dir = ckpt_dir
        self._program = main_program
        self._scope = scope
        self._registry = registry
        self._every = max(1, int(checkpoint_every))
        self._max_to_keep = int(max_to_keep)
        self._poll = float(poll_interval)
        self._idle_timeout = float(idle_timeout)
        from ..fluid.core import as_device

        self._device = as_device(device)
        self.step = 0           # finished-task counter, persisted in META
        self.resumed_from: Optional[int] = None

    # -- checkpoint plumbing (fluid/io.py save/load_checkpoint) -----------
    def maybe_resume(self) -> Optional[int]:
        """Load the latest intact checkpoint if one exists; returns its
        step or None. Idempotent — run_pass calls it once up front."""
        from ..fluid.io import latest_checkpoint_step, load_checkpoint

        if self.resumed_from is not None:
            return self.resumed_from
        if latest_checkpoint_step(self._ckpt_dir) is None:
            return None
        try:
            with self._scoped():
                self.step = load_checkpoint(
                    self._ckpt_dir, self._program, scope=self._scope,
                    device=self._device)
        except (IOError, OSError, ValueError, KeyError) as e:
            # a torn/corrupt payload (crc mismatch, half-written npz)
            # must NOT crash-loop every restart: training from scratch
            # is degraded, a trainer that can never start is an outage.
            # The master's leases still give the data back exactly once.
            _log.error("elastic: checkpoint in %s unusable (%s: %s); "
                       "starting fresh", self._ckpt_dir,
                       type(e).__name__, e)
            return None
        self.resumed_from = self.step
        _m_resumes.inc()
        _log.warning("elastic: resumed from checkpoint step %d in %s",
                     self.step, self._ckpt_dir)
        return self.step

    def _checkpoint(self):
        from ..fluid.io import save_checkpoint

        with self._scoped(), _tracing.span("elastic.checkpoint",
                                           step=self.step):
            save_checkpoint(self._ckpt_dir, self._program, step=self.step,
                            scope=self._scope,
                            max_to_keep=self._max_to_keep)

    def _scoped(self):
        from ..fluid.executor import scope_guard

        if self._scope is not None:
            return scope_guard(self._scope)
        # default scope: a no-op guard keeps the call sites uniform
        import contextlib

        return contextlib.nullcontext()

    # -- the loop ---------------------------------------------------------
    def run_pass(self, train_on_task: Callable, should_stop=None
                 ) -> Dict[str, int]:
        """Drain the master's current pass: lease -> train -> checkpoint
        -> finish, until all_done. Returns summary stats. A master that
        stays unreachable past the MasterClient's retry budget aborts
        the pass gracefully (``aborted: 1`` in the stats) — the lease
        lapses server-side, exactly as if this trainer had died."""
        resumed = self.maybe_resume()
        trained = 0
        idle_since = None
        unfinished: list = []  # trained but not yet covered by a checkpoint
        while True:
            if should_stop is not None and should_stop():
                break
            if self._registry is not None:
                self._registry.ensure_registered()
            try:
                task = self._master.get_task()
            except (ConnectionError, OSError) as e:
                _log.warning("elastic: master unreachable (%s); "
                             "abandoning the pass", e)
                return {"trained": trained, "step": self.step,
                        "resumed_from": resumed, "aborted": 1}
            if task is None:
                try:
                    if self._master.all_done():
                        break
                except (ConnectionError, OSError) as e:
                    _log.warning("elastic: master unreachable (%s); "
                                 "abandoning the pass", e)
                    return {"trained": trained, "step": self.step,
                            "resumed_from": resumed, "aborted": 1}
                if idle_since is None:
                    idle_since = time.monotonic()
                elif time.monotonic() - idle_since > self._idle_timeout:
                    break
                time.sleep(self._poll)
                continue
            idle_since = None
            try:
                # one span per leased task: the master RPCs (finish/fail)
                # and the user's training steps nest under it, so a
                # merged timeline shows task boundaries per trainer
                with _tracing.span("elastic.task", task=task.id,
                                   epoch=task.epoch):
                    train_on_task(task)
            except Exception:
                # the task is bad or training broke: requeue with a
                # failure mark (failure_max drops poisoned shards), and
                # let the caller see the real error
                try:
                    self._master.task_failed(task.id, task.epoch)
                except (ConnectionError, OSError):
                    pass  # the lease will expire and requeue regardless
                raise
            self.step += 1
            trained += 1
            _m_tasks.inc()
            unfinished.append(task)
            if trained % self._every == 0:
                # checkpoint BEFORE finishing the leases: a crash between
                # the two re-runs those tasks on resume (at-least-once).
                # With checkpoint_every > 1 the finishes of EVERY task
                # since the last checkpoint are held back until this one
                # covers them — finishing eagerly would let a crash mark
                # tasks done whose updates no checkpoint carries, losing
                # them forever (the master never re-serves done tasks).
                self._checkpoint()
                unfinished = self._flush_finished(unfinished)
        if unfinished:
            self._checkpoint()
            self._flush_finished(unfinished)
        return {"trained": trained, "step": self.step,
                "resumed_from": resumed, "aborted": 0}

    def _flush_finished(self, tasks) -> list:
        for t in tasks:
            try:
                self._master.task_finished(t.id, t.epoch)
            except (ConnectionError, OSError) as e:
                _log.warning("elastic: task_finished(%d) unreachable "
                             "(%s); lease expiry will requeue it",
                             t.id, e)
        return []
