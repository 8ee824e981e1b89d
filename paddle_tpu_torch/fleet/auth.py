"""Intent signing + path allowlisting — who may tell a
fleet what to deploy, and from where.

The intent log is the fleet's write surface: anything that lands in it
gets APPLIED by every replica, including "load this checkpoint
directory". Two independent guards close that surface:

  * HMAC SIGNATURES — every intent producer (RolloutDriver, the
    autoscale policy loop) signs the CANONICAL form of
    ``(action, model, payload, nonce)`` with a shared fleet key
    (``PADDLE_TPU_FLEET_KEY`` env or ``FLAGS["fleet_intent_key"]``).
    The controller refuses unsigned/mis-signed appends when it holds a
    key, and — independently, because the controller itself may be
    spoofed or compromised — every FleetMember re-verifies before
    converging. The signature covers a per-intent NONCE, and each
    verifier remembers recently seen nonces, so re-appending a
    captured intent verbatim (a replay) is refused even though its
    signature is valid.

  * PATH ALLOWLIST — ``PADDLE_TPU_FLEET_ALLOW`` env /
    ``FLAGS["fleet_intent_allowlist"]`` is a ':'-separated list of
    absolute directory prefixes. Every path-typed payload field
    (``checkpoint_dir`` / ``dirname`` / ``draft_checkpoint_dir``) must
    realpath-resolve under one of them. Enforced by the MEMBER (paths
    are meaningful on the replica's host, not the controller's), so a
    signed-but-out-of-tree intent is refused typed on every replica
    with zero state change.

Key absent AND allowlist empty = OPEN MODE: verification is skipped
entirely and the fleet behaves bit-identically to the unsigned
protocol (old members and old controllers interoperate).

KEY ROTATION: every verifier accepts a DUAL-KEY window —
``intent_key_prev()`` (``PADDLE_TPU_FLEET_KEY_PREV`` env /
``FLAGS["fleet_intent_key_prev"]``) is tried when the current key's
HMAC fails, so a fleet rotates without a global stop: (1) set
key_prev=old, key=new on every verifier, (2) flip producers to the new
key, (3) clear key_prev once ``fleet.auth.verified.prev_key`` stops
moving. Producers only ever sign with the CURRENT key, and the nonce
replay window is shared across both keys.

Refusals are typed (``IntentRefused``, with a machine-readable
``reason``) and counted: ``fleet.auth.refused`` totals them and
``fleet.auth.refused.<reason>`` splits them by cause; accepted
verifications count ``fleet.auth.verified``.
"""
from __future__ import annotations

import hashlib
import hmac
import json
import os
import threading
from typing import Any, Dict, List, Optional

from ..observability import metrics as _metrics
from ..serving.errors import ServingError

__all__ = ["IntentRefused", "NonceWindow", "canonical_intent",
           "sign_intent", "signed_fields", "verify_intent",
           "check_allowlist", "intent_key", "intent_key_prev",
           "intent_allowlist", "PATH_FIELDS"]

_m_verified = _metrics.counter("fleet.auth.verified")
_m_refused = _metrics.counter("fleet.auth.refused")
# intents that verified ONLY under the previous key during a rotation
# window — a rotation is complete (prev key safe to drop) when this
# stops moving
_m_verified_prev = _metrics.counter("fleet.auth.verified.prev_key")

# payload fields that name filesystem paths a replica will open —
# exactly the deploy surface the allowlist fences
PATH_FIELDS = ("checkpoint_dir", "dirname", "draft_checkpoint_dir")

# refusal reasons (the `fleet.auth.refused.<reason>` split); kept as a
# tuple so tests and docs can enumerate the typed surface
REFUSAL_REASONS = ("unsigned", "bad_signature", "replayed",
                   "path_not_allowed")


class IntentRefused(ServingError):
    """A fleet intent failed signature or allowlist verification. The
    intent is NOT applied (zero state change); convergence skips past
    it so one poisoned intent cannot wedge the log."""

    def __init__(self, reason: str, detail: str):
        super().__init__(f"intent refused ({reason}): {detail}")
        self.reason = str(reason)


def _count_refusal(reason: str) -> None:
    _m_refused.inc()
    _metrics.counter(f"fleet.auth.refused.{reason}").inc()


def refuse(reason: str, detail: str) -> IntentRefused:
    """Build + count a typed refusal (callers raise or log it)."""
    _count_refusal(reason)
    return IntentRefused(reason, detail)


# -- configuration ------------------------------------------------------

def intent_key() -> Optional[str]:
    """The fleet's HMAC key, or None for open mode. Env wins over the
    flag so replica SUBPROCESSES (launcher-spawned) inherit the key
    without any flag plumbing."""
    from ..flags import FLAGS

    key = os.environ.get("PADDLE_TPU_FLEET_KEY") or FLAGS["fleet_intent_key"]
    return str(key) if key else None


def intent_key_prev() -> Optional[str]:
    """The PREVIOUS fleet key, accepted (verify-only) during a key
    rotation window (``PADDLE_TPU_FLEET_KEY_PREV`` env or
    ``FLAGS["fleet_intent_key_prev"]``). Rotation protocol: set
    key_prev = old key, key = new key on every verifier FIRST, then
    flip producers to the new key, then clear key_prev. Producers
    always SIGN with the current key — the previous key can only ever
    accept old signatures, never mint new ones. Irrelevant in open
    mode (no current key = no verification at all)."""
    from ..flags import FLAGS

    key = (os.environ.get("PADDLE_TPU_FLEET_KEY_PREV")
           or FLAGS["fleet_intent_key_prev"])
    return str(key) if key else None


def intent_allowlist() -> List[str]:
    """Absolute, realpath-normalized allowlist prefixes ('' = open)."""
    from ..flags import FLAGS

    raw = (os.environ.get("PADDLE_TPU_FLEET_ALLOW")
           or FLAGS["fleet_intent_allowlist"] or "")
    out = []
    for part in str(raw).split(":"):
        part = part.strip()
        if part:
            out.append(os.path.realpath(part))
    return out


# -- signing ------------------------------------------------------------

_nonce_mu = threading.Lock()
_nonce_counter = [0]


def make_nonce() -> str:
    """Unique per-intent nonce: random prefix (distinct producers never
    collide) + a process-local counter (distinct intents from ONE
    producer never collide even if the entropy source repeats)."""
    with _nonce_mu:
        _nonce_counter[0] += 1
        n = _nonce_counter[0]
    return f"{os.urandom(8).hex()}-{n}"


def canonical_intent(action: str, model: str, payload: Dict[str, Any],
                     nonce: str) -> bytes:
    """The byte string the HMAC covers. Canonical = sorted keys, no
    whitespace — both producer and verifier re-serialize from the
    parsed structure, so JSON formatting differences between hosts
    can never break (or forge) a signature."""
    return json.dumps(
        {"action": str(action), "model": str(model),
         "payload": payload or {}, "nonce": str(nonce)},
        sort_keys=True, separators=(",", ":")).encode("utf-8")


def sign_intent(key: str, action: str, model: str,
                payload: Dict[str, Any], nonce: str) -> str:
    return hmac.new(key.encode("utf-8"),
                    canonical_intent(action, model, payload, nonce),
                    hashlib.sha256).hexdigest()


def signed_fields(action: str, model: str,
                  payload: Dict[str, Any]) -> Dict[str, str]:
    """The extra intent fields a producer attaches: ``{}`` in open
    mode, ``{"nonce", "sig"}`` when a key is configured."""
    key = intent_key()
    if not key:
        return {}
    nonce = make_nonce()
    return {"nonce": nonce,
            "sig": sign_intent(key, action, model, payload, nonce)}


# -- verification -------------------------------------------------------

class NonceWindow:
    """Bounded memory of recently verified nonces (replay refusal).
    The window is deliberately finite — O(window), not O(log) — and
    sized far above any live convergence backlog; a replay older than
    the window is already below every member's applied watermark, so
    converging members (who only fetch seq > applied) never re-fetch
    it."""

    def __init__(self, cap: int = 1024):
        self._cap = int(cap)
        self._mu = threading.Lock()
        self._seen: Dict[str, int] = {}  # nonce -> seq; guarded-by: _mu

    def admit(self, nonce: str, seq: int) -> bool:
        """True if the nonce is fresh (and now remembered); False if it
        was already admitted (a replay)."""
        with self._mu:
            if nonce in self._seen:
                return False
            self._seen[nonce] = int(seq)
            while len(self._seen) > self._cap:
                # dicts iterate in insertion order: drop the oldest
                self._seen.pop(next(iter(self._seen)))
            return True


def verify_intent(key: Optional[str], intent: Dict[str, Any],
                  window: Optional[NonceWindow] = None,
                  prev_key: Optional[str] = None) -> None:
    """Verify one intent record against `key` (no-op when key is
    falsy — open mode). Raises IntentRefused (counted) on an unsigned,
    tampered, or replayed intent.

    ``prev_key`` is the dual-key rotation window: a
    signature that fails the current key is retried against the
    previous one, so intents signed before a mid-flight key flip still
    land while producers catch up. The nonce window is SHARED across
    both keys — re-signing a captured intent's nonce under either key
    is still a replay."""
    if not key:
        return
    action = str(intent.get("action"))
    model = str(intent.get("model"))
    payload = dict(intent.get("payload") or {})
    nonce = intent.get("nonce")
    sig = intent.get("sig")
    if not nonce or not sig:
        raise refuse("unsigned",
                     f"intent #{intent.get('seq')} ({action} {model}) "
                     "carries no signature but this fleet requires one")
    want = sign_intent(key, action, model, payload, str(nonce))
    via_prev = False
    if not hmac.compare_digest(str(sig), want):
        want_prev = (sign_intent(prev_key, action, model, payload,
                                 str(nonce)) if prev_key else None)
        if want_prev is None or \
                not hmac.compare_digest(str(sig), want_prev):
            raise refuse(
                "bad_signature",
                f"intent #{intent.get('seq')} ({action} {model}) "
                "signature matches neither the current fleet key"
                + (" nor the rotation window's previous key"
                   if prev_key else ""))
        via_prev = True
    if window is not None and not window.admit(
            str(nonce), int(intent.get("seq") or 0)):
        raise refuse("replayed",
                     f"intent #{intent.get('seq')} ({action} {model}) "
                     f"reuses nonce {nonce!r} — replay of an already-"
                     "verified intent")
    _m_verified.inc()
    if via_prev:
        _m_verified_prev.inc()


def check_allowlist(allow: List[str], intent: Dict[str, Any]) -> None:
    """Refuse (typed + counted) any path-typed payload field that does
    not realpath-resolve under an allowlisted prefix. No-op when the
    allowlist is empty (open mode)."""
    if not allow:
        return
    payload = dict(intent.get("payload") or {})
    for field in PATH_FIELDS:
        val = payload.get(field)
        if val is None:
            continue
        real = os.path.realpath(str(val))
        ok = any(real == pre or real.startswith(pre + os.sep)
                 for pre in allow)
        if not ok:
            raise refuse(
                "path_not_allowed",
                f"intent #{intent.get('seq')} "
                f"({intent.get('action')} {intent.get('model')}): "
                f"{field}={val!r} resolves outside the fleet "
                f"allowlist {allow}")
