"""TCP-backed TTL leases — the counterpart of
``paddle_tpu/distributed/tcp_lease.py`` over the port's RPC framing, so a
lease client of either package works against either server. The
etcd-role lease service for deployments whose shared storage has no
trustworthy POSIX locks (the realistic multi-machine home for a
FileLease is NFS, where flock is historically the thing that breaks;
object-store FUSE mounts don't implement it at all).

`LeaseServer` is a tiny in-memory lease table served over the same
length-prefixed JSON framing as the master RPC (distributed/rpc.py) —
the role etcd played for the reference (go/master/etcd_client.go
campaign-on-lease; go/pserver/etcd_client.go TTL registration). Run it
once per cluster (it is the coordination point, exactly as etcd was).

`TcpLease` is interface-compatible with election.FileLease
(try_acquire / renew / release / fenced / current), so ElectedMaster
runs unchanged over either:

    em = ElectedMaster(lease_path=None, snapshot_path=...,
                       lease=TcpLease(addr, "master", holder_id))

Fencing: every successful acquire bumps a server-side monotonic term;
`fenced(commit)` verifies holder+term+TTL server-side immediately before
committing, so a deposed leader's late snapshot write raises
MasterDeposed. The check cannot be held across the client-side commit
the way FileLease holds flock, so the term doubles as a fencing TOKEN:
snapshots are term-stamped and MasterService refuses to replace a
higher-term snapshot (see TcpLease.fenced for the full story)."""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Optional, Tuple

from .rpc import RpcClient, RpcServer


class LeaseServer:
    """In-memory named TTL leases with monotonic fencing terms.

    `state_path` (optional) persists the per-name TERM counters (not the
    ephemeral holders/deadlines) across server restarts. Without it a
    restart resets terms to 1 while term-stamped snapshots on shared
    storage keep their higher terms — recoverable (MasterService adopts
    the higher on-disk term, see master._recover) but it degrades the
    term fencing between post-restart leaders until the counters catch
    up. With it, terms never regress (the role etcd's persisted revision
    counter played)."""

    def __init__(self, state_path: Optional[str] = None):
        self._mu = threading.Lock()
        self._leases = {}  # name -> {holder, deadline, term, endpoint}
        self._server: Optional[RpcServer] = None
        self._state_path = state_path
        if state_path:
            try:
                with open(state_path) as f:
                    for name, term in (json.load(f) or {}).items():
                        self._leases[name] = {"holder": None, "deadline": 0,
                                              "term": int(term),
                                              "endpoint": None}
            except (OSError, ValueError):
                pass  # no/corrupt state: terms restart (degraded fencing)

    def _persist_terms_locked(self):
        if not self._state_path:
            return
        tmp = self._state_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump({n: st["term"] for n, st in self._leases.items()},
                          f)
            os.replace(tmp, self._state_path)
        except OSError:
            pass  # persistence is best-effort; the adopt-on-recover path
            # in master._recover keeps the cluster available regardless

    # -- RPC methods ------------------------------------------------------
    def acquire(self, name, holder, ttl, endpoint=None):
        with self._mu:
            st = self._leases.get(name)
            now = time.time()
            if st and st["holder"] not in (None, holder) \
                    and st["deadline"] > now:
                return {"ok": False}
            term = (st["term"] if st and st["holder"] == holder
                    else (st["term"] + 1 if st else 1))
            self._leases[name] = {"holder": holder, "deadline": now + ttl,
                                  "term": term, "endpoint": endpoint}
            if not st or term != st["term"]:
                self._persist_terms_locked()
            return {"ok": True, "term": term}

    def renew(self, name, holder, ttl, endpoint=None):
        with self._mu:
            st = self._leases.get(name)
            if not st or st["holder"] != holder:
                return {"ok": False}
            st["deadline"] = time.time() + ttl
            if endpoint is not None:
                st["endpoint"] = endpoint
            return {"ok": True, "term": st["term"]}

    def release(self, name, holder):
        with self._mu:
            st = self._leases.get(name)
            if st and st["holder"] == holder:
                self._leases[name] = {"holder": None, "deadline": 0,
                                      "term": st["term"], "endpoint": None}
            return {"ok": True}

    def check(self, name, holder, term):
        """The fencing read: does `holder` still hold `name` at `term`
        with an unexpired TTL?"""
        with self._mu:
            st = self._leases.get(name)
            ok = bool(st and st["holder"] == holder
                      and st["term"] == term
                      and st["deadline"] > time.time())
            return {"ok": ok}

    def current(self, name):
        with self._mu:
            st = self._leases.get(name)
            if not st:
                return {}
            out = dict(st)
            # liveness is decided by the SERVER clock — the deadline
            # timestamp is not comparable across hosts under clock skew
            out["live"] = bool(st["holder"]
                               and st["deadline"] > time.time())
            return out

    # -- lifecycle --------------------------------------------------------
    def serve(self, host: str = "127.0.0.1", port: int = 0):
        self._server = RpcServer({
            "acquire": self.acquire, "renew": self.renew,
            "release": self.release, "check": self.check,
            "current": self.current,
        }, idempotent={
            # all safe to re-run (acquire/renew/release are holder-
            # guarded state convergence, check/current are reads) — and
            # the single-use fail-fast clients TcpLease makes per call
            # can never retransmit anyway, so caching their responses
            # would only grow the dedup cache on the renew hot path
            "acquire", "renew", "release", "check", "current",
        })
        return self._server.serve(host=host, port=port)

    def shutdown(self):
        if self._server is not None:
            self._server.shutdown()
            self._server = None


class TcpLease:
    """election.FileLease-compatible lease client over a LeaseServer."""

    def __init__(self, addr: Tuple[str, int], name: str, holder_id: str,
                 ttl: float = 5.0, timeout: float = 10.0):
        self.addr = addr
        self.name = name
        self.holder = holder_id
        self.ttl = float(ttl)
        self._timeout = timeout
        self._term: Optional[int] = None

    @property
    def term(self) -> int:
        """Server-issued fencing term of our current acquisition (0 if
        never acquired). ElectedMaster stamps it into snapshots — the
        backstop for the check-then-commit window documented in
        fenced()."""
        return self._term or 0

    def _call(self, method, *args):
        # retries=0: lease calls must FAIL FAST. A renew that can't reach
        # the server within one timeout means "can't prove we still hold
        # it" — step down NOW; burning a multi-attempt backoff budget
        # here would delay deposition detection far past the TTL.
        client = RpcClient(self.addr, timeout=self._timeout, retries=0)
        try:
            return client.call(method, *args)
        finally:
            client.close()

    def try_acquire(self, endpoint: Optional[Tuple[str, int]] = None) -> bool:
        try:
            r = self._call("acquire", self.name, self.holder, self.ttl,
                           list(endpoint) if endpoint else None)
        except (ConnectionError, OSError):
            return False  # unreachable lease service = cannot lead
        if r.get("ok"):
            self._term = r.get("term")
            return True
        return False

    def renew(self, endpoint: Optional[Tuple[str, int]] = None) -> bool:
        try:
            r = self._call("renew", self.name, self.holder, self.ttl,
                           list(endpoint) if endpoint else None)
        except (ConnectionError, OSError):
            return False  # can't prove we still hold it -> step down
        return bool(r.get("ok"))

    def release(self):
        try:
            self._call("release", self.name, self.holder)
        except (ConnectionError, OSError):
            pass  # TTL will expire it

    def fenced(self, commit: Callable[[], None]):
        """Verify holder+term+TTL server-side, then commit.

        Unlike FileLease.fenced — which holds flock ACROSS commit(), so a
        competing acquire blocks until the commit lands — this is
        check-then-commit: the lease server's mutex cannot extend over a
        client-side commit. A leader that stalls between the check reply
        and commit() can therefore still write after being deposed. That
        residual window is closed by the snapshot TERM: ElectedMaster
        stamps commits with `self.term` and
        MasterService._snapshot_locked refuses to replace a higher-term
        snapshot, so the deposed write loses by term comparison instead
        of by timing (the fencing-token pattern etcd deployments use for
        exactly this reason)."""
        from .master import MasterDeposed

        try:
            r = self._call("check", self.name, self.holder, self._term)
        except (ConnectionError, OSError) as e:
            raise MasterDeposed(f"lease service unreachable: {e}")
        if not r.get("ok"):
            raise MasterDeposed(
                f"{self.holder} no longer holds lease {self.name!r} "
                f"(term {self._term})")
        commit()

    def current(self) -> dict:
        try:
            return self._call("current", self.name)
        except (ConnectionError, OSError):
            return {}


def tcp_endpoint_resolver(addr: Tuple[str, int],
                          name: str) -> Callable[[], Tuple[str, int]]:
    """MasterClient resolver against a LeaseServer (the role of etcd
    re-listing in the reference's pserver clients)."""

    def resolve() -> Tuple[str, int]:
        # fail-fast for the same reason as TcpLease._call: the caller
        # (MasterClient) has its own reconnect/backoff loop around this
        client = RpcClient(addr, timeout=10.0, retries=0)
        try:
            st = client.call("current", name)
        finally:
            client.close()
        ep = st.get("endpoint")
        # "live" is computed on the lease server's clock — never compare
        # the deadline against this host's clock (cross-host skew)
        if not ep or not st.get("live"):
            raise ConnectionError("no live master holds the lease")
        return ep[0], int(ep[1])

    return resolve
