"""The lockstep of mesh-sharded decode engines across the process group's
ranks.

The JAX engine is one process driving every device of its mesh. The port
is multi-controller: each rank of the process group is a process driving
one device, every rank builds the same ``DecodeEngine`` (the same script,
the same arguments, in the same order), and only rank 0 — the LEADER —
takes requests. Its schedulers decide every device operation; the
FOLLOWERS replay them:

  - the leader announces each operation, then runs it, both under the
    mesh's lock, as one message ``(engine, op, payload, steps, drops)``
    broadcast over a gloo control group: ``run`` (a model call: the
    family and the step's int32 host arrays — tokens, positions,
    ``q_lens``, page tables, kv lens; their shapes are the shape bucket),
    ``pages`` (copy-on-write copies and preemption restores), ``spill``
    (a preemption's page gather) and ``stop``;
  - one replay thread a rank runs the messages in order, each on the
    engine it names, so every rank issues the same DTensor collectives in
    the same order — also while a hot swap's new engine warms beside the
    old one: the lock orders the two engines' operations on the leader,
    and the message order carries that order to every follower;
  - ``steps`` carries the leader engine's scheduler-step count, so a
    follower's ``serving.decode.steps`` tracks the leader's; ``drops``
    names the sequences whose spill the leader dropped (cancel, deadline),
    so each follower drops its own share of the pages after the
    operation;
  - the leader's scheduler sends ``stop`` when it exits (drained, or
    failed by ``stop(drain=False)``), which ends the follower engine's
    replay: a follower never waits on a step the leader will not send.

Every engine on one mesh spec shares one ``DeviceMesh`` object a process
(DTensor caches its sharding decisions per thread, keyed by meshes that
compare equal: two equal meshes over different groups would let two ranks
pick different groups for one collective).
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["Lockstep", "lockstep_for"]

_mu = threading.Lock()
_groups: Dict[Tuple[Any, str], "Lockstep"] = {}  # guarded-by: _mu


def lockstep_for(spec, device) -> "Lockstep":
    """The process's ``Lockstep`` (mesh, control group, replay thread) for
    mesh spec ``spec`` on ``device``'s type, built on first use. With no
    process group and a mesh of one device, a one-rank group starts
    first (``ensure_process_group``); a world of another size raises.
    Every rank must reach its first use in the same order (``new_group``
    is collective)."""
    key = (spec, device.type)
    with _mu:
        ls = _groups.get(key)
        if ls is None:
            ls = _groups[key] = Lockstep(*_build_mesh(spec, device))
        return ls


def _build_mesh(spec, device):
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from ..fluid.parallel_executor import ensure_process_group

    ensure_process_group(device.type, spec.size)
    shape = tuple(int(s) for s in spec.axes.values())
    ranks = np.arange(spec.size).reshape(shape)
    me = dist.get_rank()
    groups: List[Any] = []
    for d in range(len(shape)):
        mine = None
        for row in np.moveaxis(ranks, d, -1).reshape(-1, shape[d]):
            g = dist.new_group([int(r) for r in row])
            if me in row:
                mine = g
        groups.append(mine)
    mesh = DeviceMesh.from_group(
        groups if len(groups) > 1 else groups[0], device.type,
        mesh=torch.from_numpy(ranks), mesh_dim_names=spec.axis_names)
    ctrl = dist.new_group(list(range(spec.size)), backend="gloo")
    return mesh, ctrl


class Lockstep:
    """One mesh's leader-to-follower channel. The leader issues operations
    (``issue``); a follower registers its engines (``register``) and a
    replay thread runs what arrives."""

    def __init__(self, mesh, ctrl):
        import torch.distributed as dist

        self.mesh = mesh
        self.group = ctrl
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        # the leader: one operation at a time, announced then run
        self._issue_mu = threading.Lock()
        self._cond = threading.Condition()
        self._next_id = 0  # guarded-by: _cond
        self._engines: Dict[int, Any] = {}  # guarded-by: _cond
        self._thread: Optional[threading.Thread] = None  # guarded-by: _cond

    @property
    def leader(self) -> bool:
        return self.rank == 0

    def register(self, engine) -> int:
        """The engine's id on this mesh — its construction's place in the
        order every rank follows. A follower engine joins the replay."""
        with self._cond:
            eid = self._next_id
            self._next_id += 1
            if not self.leader:
                self._engines[eid] = engine
                if self._thread is None:
                    self._thread = threading.Thread(
                        target=self._replay, daemon=True,
                        name=f"decode-follower-{self.rank}")
                    self._thread.start()
                self._cond.notify_all()
        return eid

    def issue(self, eid: int, op: str, payload: Any, steps: int,
              drops: List[int], run: Callable[[], Any]):
        """The leader's half: announce ``op`` of engine ``eid`` to every
        follower, then run it, atomically with respect to every other
        engine's operations on this mesh."""
        import torch.distributed as dist

        with self._issue_mu:
            if self.world > 1:
                dist.broadcast_object_list(
                    [(eid, op, payload, int(steps), list(drops))], src=0,
                    group=self.group)
            return run()

    def _replay(self):
        import torch.distributed as dist

        while True:
            box: List[Any] = [None]
            dist.broadcast_object_list(box, src=0, group=self.group)
            eid, op, payload, steps, drops = box[0]
            with self._cond:
                # the leader may announce a new engine's warm before this
                # rank's constructor has registered it
                while eid not in self._engines:
                    self._cond.wait()
                engine = self._engines[eid]
                if op == "stop":
                    del self._engines[eid]
            engine._replay(op, payload, steps, drops)
            with self._cond:
                if not self._engines:
                    # no engine left to follow: end the thread (a blocked
                    # receive would outlive the process group); the next
                    # registration starts another
                    self._thread = None
                    return
