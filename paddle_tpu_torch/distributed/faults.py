"""Deterministic fault injection for the distributed stack.

The reference framework's fault-tolerance story (go/master lease
timeouts, the etcd-backed pserver surviving trainer churn) is only
trustworthy if failures can be REPRODUCED: a chaos test that depends on
kill timing races proves nothing on the run where the race doesn't
fire. This module is a seeded, env-configurable fault plan that the RPC
framing layer (and any other instrumented site) consults at named
points; a given spec injects exactly the same faults at exactly the
same call indices every run.

Spec grammar (also documented in docs/FAULT_TOLERANCE.md)::

    spec   := entry (';' entry)*
    entry  := 'seed=' INT | rule
    rule   := kind '@' site ':' sel ['=' FLOAT]
    kind   := 'refuse' | 'drop' | 'delay' | 'error' | 'crash'
    site   := dotted name (see below)
    sel    := idx (',' idx)* | 'p' FLOAT | '*'
    idx    := INT | INT '-' INT          # inclusive range

Sites instrumented today (each has its own 0-based call counter):

    connect            RpcClient socket connect         (kind: refuse)
    call.<method>      RpcClient attempt start          (kind: delay)
    send.<method>      before the request frame         (kind: drop —
                       a PARTIAL frame is written, then the connection
                       dies: the server sees a mid-frame disconnect)
    recv.<method>      after the request, before the response (kind:
                       drop — the server processed the call, the reply
                       is lost: the retry/dedup path)
    handler.<method>   server side, before dispatch     (kind: error)
    master.snapshot    MasterService between snapshot tmp-write and
                       rename                           (kind: crash)

`sel` picks which calls fault: explicit indices (``0,3-5``), every call
(``*``), or a seeded coin flip (``p0.1`` — 10% of calls, reproducible
under the plan's ``seed``). Example::

    PADDLE_TPU_FAULTS='seed=7;drop@recv.push_grad:1,3;refuse@connect:0'

Zero overhead when unset: `fire()` is one global read + None check.
Tests install plans with `scoped()`; subprocess workers inherit the env
var. Counters are process-wide and thread-safe — multi-threaded callers
share a site's index sequence, so plans that need per-call determinism
target sites only one thread exercises (or use `p`/`*` selectors whose
assertions don't depend on which thread drew the fault).
"""
from __future__ import annotations

import os
import random
import re
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from ..observability import metrics as _metrics
from ..observability.log import get_logger

__all__ = [
    "FaultPlan", "InjectedFault", "active", "active_spec", "fire",
    "install", "uninstall", "scoped",
]

_log = get_logger("faults")
_m_injected = _metrics.counter("faults.injected")

KINDS = ("refuse", "drop", "delay", "error", "crash")


class InjectedFault(ConnectionError):
    """A planned fault. Subclasses ConnectionError so client-side retry
    paths and server-side handler guards treat it exactly like the real
    network failure it simulates."""

    def __init__(self, kind: str, site: str, index: int):
        super().__init__(f"injected {kind} at {site}[{index}]")
        self.kind = kind
        self.site = site
        self.index = index


class _Rule:
    __slots__ = ("kind", "site", "indices", "prob", "param")

    def __init__(self, kind: str, site: str, indices: Optional[frozenset],
                 prob: Optional[float], param: Optional[float]):
        self.kind = kind
        self.site = site
        self.indices = indices  # None => '*' or probabilistic
        self.prob = prob        # None => index-based
        self.param = param      # delay seconds, etc.

    def matches(self, index: int, rng: random.Random) -> bool:
        if self.prob is not None:
            return rng.random() < self.prob
        if self.indices is None:  # '*'
            return True
        return index in self.indices


_RULE_RE = re.compile(
    r"^(?P<kind>[a-z]+)@(?P<site>[\w.\-]+):(?P<sel>[^=]+)(?:=(?P<param>.+))?$")


def _parse_sel(sel: str) -> Tuple[Optional[frozenset], Optional[float]]:
    sel = sel.strip()
    if sel == "*":
        return None, None
    if sel.startswith("p"):
        return None, float(sel[1:])
    idx: List[int] = []
    for part in sel.split(","):
        part = part.strip()
        if "-" in part:
            lo, hi = part.split("-", 1)
            idx.extend(range(int(lo), int(hi) + 1))
        else:
            idx.append(int(part))
    return frozenset(idx), None


class FaultPlan:
    """Parsed spec + per-site call counters. Thread-safe; one lock
    serializes counter bumps and the seeded RNG so a spec's behavior is
    a pure function of the call sequence."""

    def __init__(self, spec: str):
        self.spec = spec
        self.seed = 0
        self._rules: Dict[str, List[_Rule]] = {}
        for entry in spec.split(";"):
            entry = entry.strip()
            if not entry:
                continue
            if entry.startswith("seed="):
                self.seed = int(entry[5:])
                continue
            m = _RULE_RE.match(entry)
            if m is None:
                raise ValueError(f"bad fault rule {entry!r} "
                                 "(want kind@site:sel[=param])")
            kind = m.group("kind")
            if kind not in KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r}; known: {KINDS}")
            indices, prob = _parse_sel(m.group("sel"))
            param = float(m.group("param")) if m.group("param") else None
            self._rules.setdefault(m.group("site"), []).append(
                _Rule(kind, m.group("site"), indices, prob, param))
        self._mu = threading.Lock()
        self._counts: Dict[str, int] = {}
        self._rng = random.Random(self.seed)
        self._injected: List[Tuple[str, str, int]] = []

    def fire(self, site: str):
        """Advance `site`'s call counter; sleep (delay) or raise
        InjectedFault if a rule matches this index. Sites with no rules
        still count — an index is the Nth call, rules or not."""
        with self._mu:
            index = self._counts.get(site, 0)
            self._counts[site] = index + 1
            hit = None
            for rule in self._rules.get(site, ()):
                if rule.matches(index, self._rng):
                    hit = rule
                    break
            if hit is not None:
                self._injected.append((hit.kind, site, index))
        if hit is None:
            return
        _m_injected.inc()
        _log.info("injecting %s at %s[%d]", hit.kind, site, index)
        if hit.kind == "delay":
            time.sleep(hit.param if hit.param is not None else 0.05)
            return
        raise InjectedFault(hit.kind, site, index)

    def counts(self) -> Dict[str, int]:
        with self._mu:
            return dict(self._counts)

    def injected(self) -> List[Tuple[str, str, int]]:
        """(kind, site, index) of every fault fired so far — the
        evidence chaos tests assert against."""
        with self._mu:
            return list(self._injected)


_active: Optional[FaultPlan] = None


def active() -> Optional[FaultPlan]:
    return _active


def active_spec() -> Optional[str]:
    return _active.spec if _active is not None else None


def fire(site: str):
    """Hot-path hook: no plan installed -> one global read and out."""
    plan = _active
    if plan is None:
        return
    plan.fire(site)


def install(spec) -> FaultPlan:
    """Install a plan process-wide (a spec string or a FaultPlan)."""
    global _active
    _active = spec if isinstance(spec, FaultPlan) else FaultPlan(spec)
    return _active


def uninstall():
    global _active
    _active = None


@contextmanager
def scoped(spec):
    """Install a plan for a with-block (tests), restoring the previous
    plan — including None — on exit."""
    global _active
    prev = _active
    plan = install(spec)
    try:
        yield plan
    finally:
        _active = prev


# env-configured plan: parsed once at import so subprocess chaos workers
# (tools/chaos_soak.py, the multiprocess tests) opt in by exporting
# PADDLE_TPU_FAULTS before launch
_env_spec = os.environ.get("PADDLE_TPU_FAULTS")
if _env_spec:
    install(_env_spec)
