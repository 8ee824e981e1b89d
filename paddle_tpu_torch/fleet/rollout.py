"""RolloutDriver — the training→serving loop's last mile (the
counterpart of ``paddle_tpu/fleet/rollout.py``).

A training job ends with an artifact: a `save_inference_model`
directory (`fluid.io` export) or a decoder spec / checkpoint. This
driver turns that artifact into the fleet's live model set with zero
dropped requests:

    1. CANARY — deploy to ONE replica. Every other replica keeps
       serving the old version; the router keeps routing everywhere
       (it balances on capacity, not version), so the canary takes its
       proportional share of real traffic on the new version.
    2. HEALTH-GATE — the canary must answer `health`, its
       `load_report` must show the model at the new version, and an
       optional caller probe (e.g. "generate this prompt, compare the
       tokens") must pass. A gate failure ABORTS the rollout with the
       rest of the fleet untouched on the old version.
    3. INTENT — append the deploy to the controller's intent log. From
       this moment the rollout is durable: even if the driver dies,
       every live member converges at heartbeat cadence, and a replica
       that was dead through the whole rollout converges when it
       rejoins (FleetMember registration → log fetch).
    4. ROLL — deploy to the remaining replicas one at a time. Each
       deploy is the registry's warm-then-flip + drain: the new
       version warms while the old one serves, the
       pointer flips atomically, in-flight requests finish on the old
       engine, and requests that raced the flip are resubmitted
       server-side. A replica that dies mid-roll is SKIPPED (counted in
       the summary) — the intent log owns its convergence; the router
       has already failed its traffic over to the survivors.
    5. CONVERGE-CHECK — poll the survivors' load_reports until every
       live replica serves the new version (bounded wait).

Each per-replica deploy fires the `fleet.rollout.deploy` fault site,
so chaos plans can fail a specific deploy by index — the deterministic
way to rehearse "replica died mid-rollout" without killing anything.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..distributed import faults as _faults
from ..distributed.rpc import RpcClient
from ..observability import metrics as _metrics, tracing as _tracing
from ..observability.log import get_logger
from ..serving.client import ServingClient
from ..serving.errors import ServingError
from . import auth as _auth

__all__ = ["RolloutDriver", "RolloutError", "decoder_artifact",
           "model_artifact"]

_log = get_logger("fleet")

_m_rollouts = _metrics.counter("fleet.rollouts")
_m_rollout_deploys = _metrics.counter("fleet.rollout.deploys")
_m_rollout_skipped = _metrics.counter("fleet.rollout.skipped")
_m_rollout_aborts = _metrics.counter("fleet.rollout.aborts")


class RolloutError(ServingError):
    """The rollout aborted (canary deploy/gate failure) or could not
    make progress (no replicas). The fleet is left serving whatever it
    served — a failed rollout never takes capacity down."""


def decoder_artifact(spec: Optional[Dict[str, Any]] = None,
                     checkpoint_dir: Optional[str] = None,
                     **engine_kwargs) -> Dict[str, Any]:
    """Artifact descriptor for a DecodeEngine deploy. ``spec`` (a
    DecoderSpec dict) deploys the deterministic seed decoder;
    ``checkpoint_dir`` deploys REAL weights from a manifest checkpoint
    (the path must be readable on every replica host, same
    shared-storage assumption as model_artifact). Either alone works;
    both together cross-validate. Engine kwargs = slots/page_size/
    num_pages/max_seq_len/max_queue/prefill_chunk — plus the
    speculative trio draft_spec/draft_checkpoint_dir/spec_k and
    ``mesh_axes`` (a mesh-sharded replica deploys through the
    intent log like any other; a checkpoint that RECORDED its mesh
    needs no kwarg at all) — pass through load_decoder, so a fleet
    intent deploys a drafted or chip-spanning decoder exactly like a
    plain one."""
    if spec is None and checkpoint_dir is None:
        raise ValueError(
            "decoder_artifact needs a spec dict or a checkpoint_dir")
    payload: Dict[str, Any] = dict(engine_kwargs)
    if spec is not None:
        payload["spec"] = dict(spec)
    if checkpoint_dir is not None:
        payload["checkpoint_dir"] = str(checkpoint_dir)
    return {"action": "load_decoder", "payload": payload}


def model_artifact(dirname: str, **engine_kwargs) -> Dict[str, Any]:
    """Artifact descriptor for an InferenceEngine deploy from a
    `save_inference_model`/export dir (the training checkpoint's
    serving form). The dir must be readable by every replica host —
    shared storage."""
    return {"action": "load_model",
            "payload": {"dirname": str(dirname), **engine_kwargs}}


class RolloutDriver:
    """Canary → health-gate → intent → fleet-wide roll."""

    def __init__(self, controller_addr, timeout: float = 180.0):
        self._ctl_addr = controller_addr
        self._timeout = float(timeout)

    def _ctl(self) -> RpcClient:
        return RpcClient(self._ctl_addr, timeout=min(self._timeout, 30.0),
                         retries=1)

    # -- deploy plumbing --------------------------------------------------
    @staticmethod
    def _deploy(cli: ServingClient, model: str, artifact: Dict[str, Any],
                version: int) -> Dict[str, Any]:
        payload = dict(artifact["payload"])
        payload["version"] = int(version)
        if artifact["action"] == "load_decoder":
            return cli.load_decoder(model, **payload)
        return cli.load_model(model, **payload)

    @staticmethod
    def _reported_version(cli: ServingClient, model: str) -> Optional[int]:
        m = cli.load_report()["models"].get(model)
        return None if m is None else int(m["version"])

    def _next_version(self, replicas: Dict[str, Tuple[str, int]],
                      model: str) -> int:
        """Auto-version: 1 + the highest version any live replica
        serves (so a rollout after a partial/failed one can't collide
        with a replica that already took the higher number)."""
        high = 0
        for rid, ep in sorted(replicas.items()):
            cli = ServingClient(ep, retries=1)
            try:
                v = self._reported_version(cli, model)
                if v is not None:
                    high = max(high, v)
            except (ConnectionError, OSError, RuntimeError):
                continue
            finally:
                cli.close()
        return high + 1

    # -- the loop ---------------------------------------------------------
    def rollout(self, model: str, artifact: Dict[str, Any],
                version: Optional[int] = None,
                canary: Optional[str] = None,
                probe: Optional[Callable[[ServingClient], Any]] = None,
                converge_timeout: float = 120.0) -> Dict[str, Any]:
        """Run the full loop. Returns a summary dict:
        ``{"model", "version", "canary", "deployed", "skipped",
        "converged", "intent_seq"}``. Raises RolloutError if the canary
        phase fails (fleet untouched beyond the canary itself)."""
        model = str(model)
        if artifact.get("action") not in ("load_model", "load_decoder"):
            raise ValueError(f"bad artifact {artifact!r} — build it with "
                             "decoder_artifact()/model_artifact()")
        ctl = self._ctl()
        try:
            with _tracing.span("fleet.rollout", model=model):
                listed = ctl.call("list_replicas")
                replicas = {str(rid): (str(st["endpoint"][0]),
                                       int(st["endpoint"][1]))
                            for rid, st in listed.items()}
                if not replicas:
                    raise RolloutError("no live replicas to roll to")
                if version is None:
                    version = self._next_version(replicas, model)
                version = int(version)
                order = sorted(replicas)
                if canary is not None:
                    canary = str(canary)
                    if canary not in replicas:
                        raise RolloutError(
                            f"canary '{canary}' is not a live replica "
                            f"(live: {order})")
                    order.remove(canary)
                    order.insert(0, canary)
                canary = order[0]
                _m_rollouts.inc()
                _log.info("rollout %s v%d: canary %s, %d replicas",
                          model, version, canary, len(order))

                # 1+2: canary deploy + health gate
                self._canary_phase(replicas[canary], model, artifact,
                                   version, probe)

                # 3: durable intent — members converge even if we die now
                # (signed when the fleet is keyed: the driver is an
                # intent PRODUCER, so it attaches nonce+sig over the
                # canonical payload — fleet/auth.py)
                payload = dict(artifact["payload"])
                payload["version"] = version
                signed = _auth.signed_fields(artifact["action"], model,
                                             payload)
                seq = int(ctl.call("add_intent", artifact["action"],
                                   model, payload, signed.get("nonce"),
                                   signed.get("sig"))["seq"])

                # 4: roll the rest, one at a time
                deployed, skipped = [canary], []
                for rid in order[1:]:
                    if self._roll_one(replicas[rid], rid, model,
                                      artifact, version):
                        deployed.append(rid)
                    else:
                        skipped.append(rid)

                # 5: converge check over the CURRENTLY live set (a
                # replica may have died or rejoined since we listed)
                converged = self._wait_converged(
                    ctl, model, version, converge_timeout)
                return {"model": model, "version": version,
                        "canary": canary, "deployed": deployed,
                        "skipped": skipped, "converged": converged,
                        "intent_seq": seq}
        finally:
            ctl.close()

    def _canary_phase(self, ep: Tuple[str, int], model: str,
                      artifact: Dict[str, Any], version: int,
                      probe: Optional[Callable[[ServingClient], Any]]):
        cli = ServingClient(ep, timeout=self._timeout, retries=1)
        try:
            try:
                _faults.fire("fleet.rollout.deploy")
                self._deploy(cli, model, artifact, version)
            except Exception as e:
                _m_rollout_aborts.inc()
                raise RolloutError(
                    f"canary deploy of {model} v{version} failed "
                    f"({type(e).__name__}: {e}) — rollout aborted, "
                    "fleet unchanged") from e
            try:
                h = cli.health()
                if not h.get("ok") or model not in h.get("models", []):
                    raise RolloutError(
                        f"canary health-gate: {model} missing from "
                        f"health ({h})")
                v = self._reported_version(cli, model)
                if v != version:
                    raise RolloutError(
                        f"canary health-gate: load_report shows "
                        f"{model} v{v}, wanted v{version}")
                if probe is not None:
                    probe(cli)
            except RolloutError:
                _m_rollout_aborts.inc()
                raise
            except Exception as e:
                _m_rollout_aborts.inc()
                raise RolloutError(
                    f"canary probe for {model} v{version} failed "
                    f"({type(e).__name__}: {e}) — rollout aborted "
                    "before fleet-wide roll") from e
        finally:
            cli.close()

    def _roll_one(self, ep: Tuple[str, int], rid: str, model: str,
                  artifact: Dict[str, Any], version: int) -> bool:
        cli = ServingClient(ep, timeout=self._timeout, retries=1)
        try:
            _faults.fire("fleet.rollout.deploy")
            self._deploy(cli, model, artifact, version)
            _m_rollout_deploys.inc()
            return True
        except ValueError as e:
            if "already the live version" in str(e):
                # a member convergence pass beat us to it: that IS the
                # deploy we wanted
                _m_rollout_deploys.inc()
                return True
            _m_rollout_skipped.inc()
            _log.error("rollout: replica %s refused %s v%d: %s",
                       rid, model, version, e)
            return False
        except (ConnectionError, OSError, RuntimeError) as e:
            # dead/unreachable replica: skip — the intent log owns its
            # convergence when it rejoins, the router already failed
            # its traffic over
            _m_rollout_skipped.inc()
            _log.warning("rollout: replica %s unreachable mid-roll "
                         "(%s: %s) — skipped, converges from the "
                         "intent log on rejoin", rid, type(e).__name__, e)
            return False
        finally:
            cli.close()

    def _wait_converged(self, ctl: RpcClient, model: str, version: int,
                        timeout: float) -> List[str]:
        """Poll live replicas' load_reports until all serve `version`
        (or timeout). Returns the converged replica ids. One client
        per endpoint is minted lazily and REUSED across poll rounds —
        a fresh TCP connect per replica per 0.1 s round would be
        thousands of dial/teardown cycles on a slow converge
        (RpcClient reconnects lazily after failures, so reuse is free)."""
        deadline = time.monotonic() + float(timeout)
        converged: List[str] = []
        clients: Dict[Tuple[str, int], ServingClient] = {}
        try:
            while True:
                listed = ctl.call("list_replicas")
                converged = []
                pending = []
                for rid, st in sorted(listed.items()):
                    ep = (str(st["endpoint"][0]), int(st["endpoint"][1]))
                    cli = clients.get(ep)
                    if cli is None:
                        cli = clients[ep] = ServingClient(ep, retries=0)
                    try:
                        v = self._reported_version(cli, model)
                        (converged if v == version
                         else pending).append(rid)
                    except (ConnectionError, OSError, RuntimeError):
                        pending.append(rid)
                if not pending:
                    return converged
                if time.monotonic() >= deadline:
                    _log.warning("rollout: %s v%d converge wait timed "
                                 "out with %s pending", model, version,
                                 pending)
                    return converged
                time.sleep(0.1)
        finally:
            for cli in clients.values():
                cli.close()
