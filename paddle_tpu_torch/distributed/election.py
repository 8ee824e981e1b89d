"""Leader election + standby takeover for the master data service —
the counterpart of ``paddle_tpu/distributed/election.py`` (the same JSON
lease file, so candidates of both packages contend for one lease).

Capability parity with the reference's etcd-backed HA (go/master/
etcd_client.go: campaign on a lease key, lose-lease -> step down;
go/pserver/etcd_client.go:70-204: TTL-lease registration that clients
re-resolve). Redesign without an etcd dependency: the lease lives
in a file on shared storage, mutual exclusion via flock, and the elected
master publishes its TCP endpoint next to the lease for clients to
re-resolve.

Filesystem requirement: the lease path must live on a filesystem with
WORKING POSIX advisory locks — local disk (multi-process single host) or
NFSv4 with its lock manager. Object-store FUSE mounts (gcsfuse, s3fs) do
NOT implement flock; on those, two candidates could both win. For
cross-host deployments without lock-capable shared storage use
tcp_lease.LeaseServer/TcpLease (same lease surface over the master RPC
framing — pass `lease=TcpLease(...)` to ElectedMaster); the campaign/TTL
semantics are identical, so the swap is one constructor argument.
Defense-in-depth either way: a holder whose lease state is corrupted or
stolen under it steps down on the next renew() and its fenced() commits
raise MasterDeposed.
On takeover the new leader recovers the queue from the shared snapshot
(master.py snapshot/recover), so leased work survives a master crash: the
pending leases it cannot see simply time out and re-queue.

    # on every master candidate (any number of processes):
    em = ElectedMaster(lease_path, snapshot_path, chunks_per_task=1)
    em.start()            # campaigns; serves while leader
    ...
    em.stop()

    # trainers:
    client = MasterClient(addr_resolver=endpoint_resolver(lease_path))
"""
from __future__ import annotations

import fcntl
import json
import os
import threading
import time
from typing import Callable, Optional, Tuple

from .master import MasterService


class FileLease:
    """A TTL lease in a file, flock-serialized (role of an etcd lease).

    Layout: `<path>` holds JSON {"holder", "deadline", "endpoint"};
    `<path>.lock` is the flock target (kept separate so replacing the
    lease content never races the lock itself)."""

    def __init__(self, path: str, holder_id: str, ttl: float = 5.0):
        self.path = path
        self.holder = holder_id
        self.ttl = float(ttl)
        # monotonic fencing term: bumped each time the lease changes
        # hands (tcp_lease.LeaseServer semantics). Stamped into master
        # snapshots so stale-leader writes lose by term comparison, not
        # by timing.
        self.term = 0

    def _locked(self):
        lock = open(self.path + ".lock", "a+")
        fcntl.flock(lock.fileno(), fcntl.LOCK_EX)
        return lock

    def _read(self) -> dict:
        try:
            with open(self.path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {}

    def _write(self, state: dict):
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, self.path)

    def try_acquire(self, endpoint: Optional[Tuple[str, int]] = None) -> bool:
        """Become (or stay) holder if the lease is free, expired, or ours."""
        lock = self._locked()
        try:
            st = self._read()
            now = time.time()
            if (st.get("holder") not in (None, self.holder)
                    and st.get("deadline", 0) > now):
                return False
            term = (st.get("term", 0)
                    if st.get("holder") == self.holder
                    else st.get("term", 0) + 1)
            self._write({"holder": self.holder, "deadline": now + self.ttl,
                         "term": term,
                         "endpoint": list(endpoint) if endpoint else None})
            self.term = term
            return True
        finally:
            lock.close()

    def renew(self, endpoint: Optional[Tuple[str, int]] = None) -> bool:
        """Extend our lease; False (lost) if someone else holds it now."""
        lock = self._locked()
        try:
            st = self._read()
            if st.get("holder") != self.holder:
                return False
            self._write({"holder": self.holder,
                         "deadline": time.time() + self.ttl,
                         "term": st.get("term", self.term),
                         "endpoint": list(endpoint) if endpoint else None})
            return True
        finally:
            lock.close()

    def release(self):
        lock = self._locked()
        try:
            st = self._read()
            if st.get("holder") == self.holder:
                # keep the term: the next holder must get a HIGHER one
                self._write({"term": st.get("term", self.term)})
        finally:
            lock.close()

    def fenced(self, commit: Callable[[], None]):
        """Run `commit` atomically-with-respect-to-lease-transfer: under the
        lease lock, verify we still hold an unexpired lease, then commit.
        Raises MasterDeposed otherwise — the fencing that stops a stale
        leader from overwriting the new leader's state (the role of etcd
        transactions guarded on the lease key)."""
        from .master import MasterDeposed

        lock = self._locked()
        try:
            st = self._read()
            if (st.get("holder") != self.holder
                    or st.get("deadline", 0) <= time.time()):
                raise MasterDeposed(
                    f"{self.holder} no longer holds the lease "
                    f"(holder={st.get('holder')!r})")
            commit()
        finally:
            lock.close()

    def current(self) -> dict:
        lock = self._locked()
        try:
            return self._read()
        finally:
            lock.close()


def endpoint_resolver(lease_path: str) -> Callable[[], Tuple[str, int]]:
    """Resolver for MasterClient: returns the CURRENT leader's endpoint
    (reference: pserver clients re-list etcd keys on reconnect)."""

    def resolve() -> Tuple[str, int]:
        try:
            with open(lease_path) as f:
                st = json.load(f)
        except (OSError, ValueError):
            raise ConnectionError(f"no master lease at {lease_path}")
        ep = st.get("endpoint")
        if not ep or st.get("deadline", 0) <= time.time():
            raise ConnectionError("no live master holds the lease")
        return ep[0], int(ep[1])

    return resolve


class ElectedMaster:
    """A master candidate: campaigns for the lease; while leader, serves a
    MasterService recovered from the shared snapshot; steps down (stops
    serving) if the lease is lost."""

    def __init__(self, lease_path: Optional[str], snapshot_path: str,
                 holder_id: Optional[str] = None, ttl: float = 5.0,
                 host: str = "127.0.0.1", renew_interval: Optional[float] = None,
                 lease=None, **service_kwargs):
        # lease= swaps the coordination backend: any object with the
        # FileLease surface works (tcp_lease.TcpLease for storage without
        # trustworthy POSIX locks)
        self.lease = lease if lease is not None else FileLease(
            lease_path, holder_id or f"master-{os.getpid()}-{id(self):x}",
            ttl)
        self._snapshot_path = snapshot_path
        self._service_kwargs = service_kwargs
        self._host = host
        self._renew_every = renew_interval or ttl / 3.0
        self.service: Optional[MasterService] = None
        self.addr: Optional[Tuple[str, int]] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.is_leader = threading.Event()
        # last failure from a leadership attempt (corrupt snapshot, bind
        # error, ...): surfaced so wait_leader() timeouts are diagnosable
        self.last_error: Optional[BaseException] = None

    # -- lifecycle --------------------------------------------------------
    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def wait_leader(self, timeout: Optional[float] = None) -> bool:
        return self.is_leader.wait(timeout)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._step_down(release=True)

    def crash(self):
        """Test hook: die without releasing the lease (the takeover path —
        a standby must wait out the TTL, like a real master crash)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        self._step_down(release=False)

    # -- internals --------------------------------------------------------
    def _become_leader(self):
        self.service = MasterService(
            snapshot_path=self._snapshot_path,
            snapshot_fence=self.lease.fenced,
            # stamp snapshots with OUR leadership term: a deposed leader's
            # late commit loses by term comparison even if it slips past a
            # check-then-commit fence (see MasterService._snapshot_locked)
            snapshot_term=getattr(self.lease, "term", 0) or 0,
            **self._service_kwargs)
        self.addr = self.service.serve(host=self._host, port=0)
        if not self.lease.renew(self.addr):
            # startup (snapshot recovery / bind) outlasted the TTL and a
            # standby took the lease — we are NOT the leader; raising here
            # routes through _run's failure path (shutdown + retry)
            raise RuntimeError("lease lost during leader startup")
        self.is_leader.set()

    def _step_down(self, release: bool):
        self.is_leader.clear()
        if self.service is not None:
            self.service.shutdown()
            self.service = None
            self.addr = None
        if release:
            self.lease.release()

    def _run(self):
        while not self._stop.is_set():
            if self.service is None:
                if self.lease.try_acquire():
                    try:
                        self._become_leader()
                    except Exception as e:
                        # corrupt snapshot, bind failure, ...: don't die
                        # silently holding the lease — release it, record
                        # the failure, and keep campaigning (another
                        # candidate may have a healthier environment)
                        self.last_error = e
                        import sys as _sys

                        print(f"[election] {self.lease.holder} failed to "
                              f"become leader: {type(e).__name__}: {e}",
                              file=_sys.stderr)
                        self._step_down(release=True)
                        self._stop.wait(self._renew_every)
                else:
                    self._stop.wait(self._renew_every)
                    continue
            else:
                if not self.lease.renew(self.addr):
                    # split-brain guard: someone else won the lease — stop
                    # serving immediately (reference: lose etcd lease ->
                    # process exits)
                    self._step_down(release=False)
                    continue
                self._stop.wait(self._renew_every)
