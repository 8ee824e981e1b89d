"""Mesh observability — the counterpart of ``paddle_tpu/mesh/observe.py``:
gauges for the active mesh, per-collective-kind counters, and the mesh
status payload.

  - ``mesh.devices`` / ``mesh.axes`` gauges describe the active mesh
    (device count / axis count); per-axis sizes ride the family
    ``mesh.axis.<name>``;
  - ``mesh.collectives.<kind>`` counters (``all_reduce``, ``all_gather``,
    ``reduce_scatter``, ``all_to_all``, ``collective_permute``) add up
    the collectives of each program signature's first sharded step. The
    JAX package counts them in the compiled HLO; the port's eager DTensor
    step has no compiled program, so the ParallelExecutor counts what
    ``CommDebugMode`` records on that step (``mesh.sharded_compiles``
    counts those first steps);
  - ``mesh.sharded_steps`` counts sharded step dispatches, and the
    executor's step span carries ``collectives=``.

``mesh_status()`` returns the JAX package's ``/statusz`` mesh section
payload. Serving it over HTTP waits for the port's
``observability/debug_server.py`` (the outer layers, still to port).
"""
from __future__ import annotations

import threading
from typing import Any, Dict

from ..observability import metrics as _metrics

__all__ = ["note_mesh", "note_sharded_compile", "mesh_status",
           "sharded_step_counter", "COLLECTIVE_KINDS"]

COLLECTIVE_KINDS = ("all_reduce", "all_gather", "reduce_scatter",
                    "collective_permute", "all_to_all")

_m_devices = _metrics.gauge("mesh.devices")
_m_axes = _metrics.gauge("mesh.axes")
_m_sharded_steps = _metrics.counter("mesh.sharded_steps")
_m_sharded_compiles = _metrics.counter("mesh.sharded_compiles")
_m_collectives = {kind: _metrics.counter(f"mesh.collectives.{kind}")
                  for kind in COLLECTIVE_KINDS}


def sharded_step_counter():
    """The ``mesh.sharded_steps`` counter (executors inc it per sharded
    dispatch; tests read it)."""
    return _m_sharded_steps


class _MeshStats:
    """Process-wide record of active meshes and collective totals."""

    def __init__(self):
        self._mu = threading.Lock()
        self._meshes: Dict[str, Dict[str, int]] = {}  # guarded-by: _mu
        self._collective_totals: Dict[str, int] = {}  # guarded-by: _mu

    def note_mesh(self, label: str, axes: Dict[str, int]):
        with self._mu:
            self._meshes[str(label)] = dict(axes)

    def note_collectives(self, counts: Dict[str, int]):
        with self._mu:
            for k, v in counts.items():
                self._collective_totals[k] = \
                    self._collective_totals.get(k, 0) + int(v)

    def status(self) -> Dict[str, Any]:
        with self._mu:
            meshes = {k: dict(v) for k, v in self._meshes.items()}
            totals = dict(self._collective_totals)
        return {
            "meshes": meshes,
            "collectives_compiled": totals,
            "sharded_steps": _m_sharded_steps.value(),
            "sharded_compiles": _m_sharded_compiles.value(),
        }


_stats = _MeshStats()


def note_mesh(mesh, label: str = "default") -> None:
    """Record an ACTIVE mesh (a ``DeviceMesh`` with dim names): sets the
    ``mesh.devices``/``mesh.axes`` gauges and the per-axis
    ``mesh.axis.<name>`` family."""
    axes = dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))
    _m_devices.set(int(mesh.size()))
    _m_axes.set(len(axes))
    for name, size in axes.items():
        _metrics.gauge(f"mesh.axis.{name}").set(size)
    _stats.note_mesh(label, axes)


def note_sharded_compile(counts: Dict[str, int]) -> Dict[str, int]:
    """Account one program signature's first sharded step: add its
    collective ``counts`` ({kind: n}) to the ``mesh.collectives.*``
    counters, bump ``mesh.sharded_compiles``, and return the counts so
    the caller can stamp its step span."""
    _m_sharded_compiles.inc()
    for kind, n in counts.items():
        c = _m_collectives.get(kind)
        if c is not None:
            c.inc(int(n))
    _stats.note_collectives(counts)
    return counts


def mesh_status() -> Dict[str, Any]:
    """The mesh status payload (the JAX package's ``/statusz`` mesh
    section), directly callable."""
    return _stats.status()
