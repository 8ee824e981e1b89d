"""Versioned model registry with atomic hot-swap.

The contract a serving fleet needs from "deploy a new version":

  1. The new version is loaded AND warmed (one compile per bucket-ladder
     entry) in the background, while the old version keeps serving.
  2. The name -> engine pointer flips atomically under the registry
     lock: after the flip every `get()` returns the new engine.
  3. The old engine is then retired with `stop(drain=True)` — it
     completes every request already admitted, so a swap drops ZERO
     in-flight requests. Requests that raced the flip and landed on the
     retiring engine get EngineRetired, which the server resubmits to
     the current engine (serving.swap_resubmits counts those).
  4. A failed load/warm raises BEFORE the flip: the registry is
     untouched and the old version keeps serving — rollback is the
     default, not a recovery procedure.
  5. After retirement the engine releases its parameters (and KV pools),
     so many version flips must not accumulate device memory.
"""
from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Any, Callable, Dict, List

from ..observability import metrics as _metrics
from ..observability.log import get_logger
from .errors import ModelNotFound

if TYPE_CHECKING:
    from .decode import DecodeEngine

__all__ = ["ModelRegistry"]

_log = get_logger("serving")

_m_loads = _metrics.counter("serving.model_loads")
_m_unloads = _metrics.counter("serving.model_unloads")
_m_swaps = _metrics.counter("serving.hot_swaps")


class ModelRegistry:
    """name -> live engine, with swap/unload lifecycle.

    Engine-kind-agnostic: anything with ``name``/``version``/``kind``/
    ``stats()``/``stop(drain=)`` deploys here — the one-shot
    InferenceEngine and the DecodeEngine share it and its hot-swap drain
    guarantee."""

    def __init__(self):
        self._mu = threading.Lock()
        self._models: Dict[str, "DecodeEngine"] = {}  # guarded-by: _mu

    def deploy(self, name: str,
               build: Callable[[], "DecodeEngine"]) -> "DecodeEngine":
        """Load (`build` returns a WARMED engine, or raises) then flip.
        The expensive part — load + warm — happens
        before the lock is ever taken, so serving never stalls on a
        deploy, and a build failure leaves the old version installed
        (rollback by construction)."""
        engine = build()
        try:
            with self._mu:
                old = self._models.get(name)
                self._models[name] = engine
        except BaseException:  # pragma: no cover - only on interpreter death
            engine.stop(drain=False)
            raise
        _m_loads.inc()
        if old is not None:
            _m_swaps.inc()
            _log.info("hot-swap %s: v%d -> v%d (draining old)",
                      name, old.version, engine.version)
            # outside the lock: draining can take a full batch turn, and
            # get() must already be answering with the new engine
            old.stop(drain=True)
        return engine

    def get(self, name: str) -> "DecodeEngine":
        with self._mu:
            eng = self._models.get(name)
        if eng is None:
            raise ModelNotFound(
                f"no model registered under '{name}' "
                f"(loaded: {sorted(self.names())})")
        return eng

    def names(self) -> List[str]:
        with self._mu:
            return sorted(self._models)

    def unload(self, name: str, drain: bool = True) -> Dict[str, Any]:
        with self._mu:
            eng = self._models.pop(name, None)
        if eng is None:
            raise ModelNotFound(f"no model registered under '{name}'")
        eng.stop(drain=drain)
        info = eng.stats()  # AFTER the drain: truly final numbers
        _m_unloads.inc()
        return info

    def unload_all(self, drain: bool = True):
        for name in self.names():
            try:
                self.unload(name, drain=drain)
            except ModelNotFound:  # raced another unload
                pass

    def stats(self) -> Dict[str, Any]:
        with self._mu:
            engines = dict(self._models)
        return {name: eng.stats() for name, eng in sorted(engines.items())}
