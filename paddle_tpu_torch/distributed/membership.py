"""Elastic worker membership (the counterpart of
``paddle_tpu/distributed/membership.py``: the same slot files, so
registries of both packages on one root see each other's members):
TTL-lease registration + live-member listing
(reference go/pserver/etcd_client.go Register:70 — claim /ps/<i> with a TTL
lease and keepalive; trainers re-list to find live pservers).

Redesign on the same storage substrate as election.py: each worker
claims a numbered slot file under a registry directory with a TTL it must
keep alive; listers see exactly the live membership, dead workers' slots
expire and are reclaimed by newcomers (elastic grow/shrink). Same
filesystem requirement as election.FileLease (working POSIX locks)."""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

from .election import FileLease


class WorkerRegistry:
    """A directory of slot leases: /registry/slot-<i> claimed by worker id.

        reg = WorkerRegistry(dir, worker_id="trainer-3", ttl=5.0)
        slot = reg.register()       # claims the lowest free slot, heartbeats
        ...
        reg.members()               # {slot: worker_id} of LIVE workers
        reg.deregister()
    """

    def __init__(self, root: str, worker_id: str, ttl: float = 5.0,
                 max_slots: int = 1024):
        os.makedirs(root, exist_ok=True)
        self.root = root
        self.worker_id = worker_id
        # the lease holder token is unique PER PROCESS+INSTANCE: two
        # processes launched with the same worker_id (restart races,
        # misconfig) must fight for different slots, not silently share one
        # lease and evict each other (etcd leases are per-session the same
        # way). members() strips the token back to the display id.
        self._token = f"{worker_id}#{os.getpid()}-{id(self):x}"
        self.ttl = float(ttl)
        self.max_slots = max_slots
        self.slot: Optional[int] = None
        self._lease: Optional[FileLease] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _slot_path(self, i: int) -> str:
        return os.path.join(self.root, f"slot-{i:05d}")

    # -- registration (reference Register:70: loop over indices, claim the
    # first free one with a lease transaction) ---------------------------
    def register(self, timeout: float = 30.0) -> int:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for i in range(self.max_slots):
                lease = FileLease(self._slot_path(i), self._token,
                                  self.ttl)
                if lease.try_acquire():
                    self.slot = i
                    self._lease = lease
                    self._stop.clear()
                    self._thread = threading.Thread(target=self._heartbeat,
                                                    daemon=True)
                    self._thread.start()
                    return i
            time.sleep(self.ttl / 2)
        raise TimeoutError(
            f"no free worker slot in {self.root} within {timeout}s")

    def _heartbeat(self):
        while not self._stop.wait(self.ttl / 3.0):
            if self._lease is None or not self._lease.renew():
                # lost the slot (e.g. long pause past TTL): stop claiming it
                self.slot = None
                return

    def deregister(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self._lease is not None:
            self._lease.release()
        self.slot = None
        self._lease = None

    def is_registered(self) -> bool:
        return (self.slot is not None and self._lease is not None
                and self._lease.current().get("holder") == self._token)

    def ensure_registered(self, timeout: float = 30.0) -> int:
        """Re-claim a slot if ours lapsed (a GC pause past the TTL makes
        the heartbeat thread give the slot up — see _heartbeat). Elastic
        loops call this each iteration so a worker that is actually
        alive never stays invisible to the membership view. No-op when
        the current lease is healthy."""
        if self.is_registered():
            return self.slot
        if self._lease is not None:  # stale thread/lease: tear down first
            self.deregister()
        return self.register(timeout=timeout)

    # -- listing ----------------------------------------------------------
    def members(self) -> Dict[int, str]:
        """Live workers only: expired leases are invisible (the elastic
        membership view trainers/pservers re-resolve from)."""
        out: Dict[int, str] = {}
        now = time.time()
        try:
            names = os.listdir(self.root)
        except OSError:
            return out
        for name in names:
            if not name.startswith("slot-") or name.endswith(".lock") \
                    or name.endswith(".tmp"):
                continue
            try:
                with open(os.path.join(self.root, name)) as f:
                    st = json.load(f)
            except (OSError, ValueError):
                continue
            if st.get("holder") and st.get("deadline", 0) > now:
                out[int(name.split("-")[1])] = st["holder"].split("#")[0]
        return out

    def wait_for(self, n: int, timeout: float = 60.0) -> List[str]:
        """Block until >= n live members (the reference's barrier before
        FinishInitParams)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            m = self.members()
            if len(m) >= n:
                return [m[k] for k in sorted(m)]
            time.sleep(0.1)
        raise TimeoutError(f"only {len(self.members())}/{n} workers live")
