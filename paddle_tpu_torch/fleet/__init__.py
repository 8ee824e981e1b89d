"""Serving fleet — the counterpart of ``paddle_tpu.fleet``: N
ServingServer replicas composed into one service. The RPC methods, their
arguments and the intent records (signatures included) are the JAX
package's, so a member of either package joins a controller of the
other.

    FleetController  replica membership (TTL leases, heartbeat/eviction,
                     rejoin) + the replicated model-deploy intent log
                     (compacted below the fleet-wide applied watermark)
                     + the scale-intent channel
    FleetMember      joins one ServingServer to a fleet: registers,
                     beats (piggybacking a load summary), converges the
                     model set to the intent log — re-verifying intent
                     signatures and the path allowlist before applying
    FleetRouter      capacity-aware client/proxy: routes on scraped
                     load_report (free KV pages for decoders, queue
                     headroom for engines), skips draining replicas,
                     sheds cluster-wide only when NO replica has
                     capacity, fails over off dead replicas with
                     dedup-safe retransmits
    RolloutDriver    training→serving loop: canary → health-gate →
                     durable (signed) intent → fleet-wide roll with
                     zero dropped requests
    FleetPolicy      the autoscale policy loop: hysteretic
                     scale-up on fleet-wide free-page/headroom floors,
                     cache-aware scale-down draining the COLDEST
                     replica
    ReplicaLauncher  turns scale intents into real replica processes:
                     spawn, crash-restart with backoff, SIGTERM-grace-
                     SIGKILL stop, orphan reaping
    IntentRefused    typed refusal of an unsigned/tampered/replayed/
                     out-of-allowlist intent (fleet/auth.py)

Replicas serve on a device of their own (``ServingServer(device=...)``;
``None`` is the card, and raises without one); the controller, the
router, the rollout driver, the policy and the launcher are host code.
``python -m paddle_tpu_torch.fleet --selftest --device cpu`` is the
in-process end-to-end proof; ``--replica --device D`` is what the
launcher spawns.
"""
from .auth import IntentRefused
from .controller import FleetController, INTENT_ACTIONS, SCALE_ACTIONS
from .launcher import ReplicaLauncher
from .member import FleetMember
from .policy import FleetPolicy
from .rollout import (RolloutDriver, RolloutError, decoder_artifact,
                      model_artifact)
from .router import FleetRouter, FleetTokenStream, NoReplicasError

__all__ = [
    "FleetController", "FleetMember", "FleetRouter", "FleetTokenStream",
    "NoReplicasError", "FleetPolicy", "ReplicaLauncher", "IntentRefused",
    "INTENT_ACTIONS", "SCALE_ACTIONS",
    "RolloutDriver", "RolloutError", "decoder_artifact", "model_artifact",
]
