"""Measure-or-model candidate selection + the executor's step-timing
log — the counterpart of ``paddle_tpu/autotune/measure.py``.

  - ``measure_or_model(tunable_id, candidates, runner=...)`` — when a
    real runner exists, each candidate is timed (median of ``k`` runs
    after one warmup; on a card each run ends in
    ``torch.cuda.synchronize()``, so the wall clock covers the device
    work and not only its launch) and the fastest wins; the decision
    lands in the tuning cache under (device_kind, tunable_id,
    shape_key), so a REPEAT session returns it without running
    anything.
  - ``measure_or_model(..., cost_fn=...)`` — the zero-run fallback:
    ``cost_fn(candidate)`` returns a cost dict (``jit_cost`` below runs
    a torch callable on meta tensors under ``CostProbe``) and the
    candidate with the lowest ``flops + bytes accessed`` proxy wins.
  - ``note_step_timing(tunable_id, program, feeds, ms)`` — the
    executor hook: every steady-state step's wall time is logged under
    a stable program/shape fingerprint, so ``cached_step_ms`` can
    answer "have we measured this before?" without running it again.

``jit_cost`` is the JAX package's XLA ``cost_analysis`` of a lowered
function, redone without a compiler: ``CostProbe`` counts, for every
op dispatched while it is active, the matmul-family flops by
``torch.utils.flop_counter.FlopCounterMode``'s formulas, one flop an
output element for the elementwise arithmetic ops (XLA's count), the
transcendentals apart (XLA's ``transcendentals``), and the bytes of each
op's tensor inputs and outputs. XLA's ``bytes accessed`` also counts
the broadcast of a scalar constant as an op of its own; an eager op
takes the scalar as an argument, so a function with such constants
reads fewer bytes here.
"""
from __future__ import annotations

import hashlib
import json
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..observability import metrics as _metrics, tracing as _tracing
from .cache import TuningCache, get_cache, _median

__all__ = ["measure_or_model", "jit_cost", "model_score", "CostProbe",
           "step_shape_key", "note_step_timing", "cached_step_ms"]

# one inc per TIMED candidate run — a re-run with a warm cache proves
# the skip by this counter's delta staying 0
_m_measurements = _metrics.counter("autotune.measurements")
_m_modeled = _metrics.counter("autotune.modeled")

# aten ops XLA counts as one flop an output element
_ELEMENTWISE_FLOPS = frozenset((
    "add", "sub", "rsub", "mul", "div", "neg", "maximum", "minimum",
    "relu", "abs", "clamp", "clamp_min", "clamp_max", "pow", "square",
    "reciprocal", "sign", "floor", "ceil", "round"))
# aten ops XLA counts as transcendentals (not flops)
_TRANSCENDENTALS = frozenset((
    "exp", "log", "tanh", "sigmoid", "erf", "sqrt", "rsqrt", "sin",
    "cos", "log1p", "expm1", "exp2", "log2"))


def _canon(v: Any) -> Any:
    """JSON-round-trip normalization (tuples -> lists, int keys ->
    str): cached decisions are compared in the form they persist in."""
    try:
        return json.loads(json.dumps(v))
    except (TypeError, ValueError):
        return v


def model_score(cost: Dict[str, Any]) -> float:
    """Unitless cost-model proxy over a cost dict: ``flops +
    bytes_accessed``. Good enough to order candidates that differ
    structurally; NOT a latency estimate — measured runs always
    override it in the cache (source 'measured' vs 'model')."""
    flops = float(cost.get("flops") or 0.0)
    bytes_acc = float(cost.get("bytes accessed")
                      or cost.get("bytes_accessed") or 0.0)
    return flops + bytes_acc


def _tensor_bytes(x) -> int:
    import torch

    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(v) for v in x)
    return 0


def _numel(x) -> int:
    import torch

    if isinstance(x, torch.Tensor):
        return x.numel()
    if isinstance(x, (list, tuple)):
        return sum(_numel(v) for v in x)
    return 0


class CostProbe:
    """Context manager counting the cost of the torch ops dispatched
    inside it: ``flops`` (matmul family by FlopCounterMode, plus one a
    output element of each elementwise arithmetic op), ``transcendentals``
    and, with ``count_bytes``, ``bytes accessed`` (each op's tensor
    inputs and outputs). It counts whatever the tensors are — real, meta
    or fake — and runs the ops as they are, so on meta tensors nothing
    executes. ``cost()`` returns the dict in the JAX package's keys."""

    def __init__(self, count_bytes: bool = True):
        self._count_bytes = bool(count_bytes)
        self.elementwise = 0
        self.transcendentals = 0
        self.bytes = 0
        self._stack = None

    def __enter__(self) -> "CostProbe":
        import contextlib

        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import FlopCounterMode

        probe = self

        class _Tally(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                name = func.overloadpacket.__name__.rstrip("_")
                if name in _ELEMENTWISE_FLOPS:
                    probe.elementwise += _numel(out)
                elif name in _TRANSCENDENTALS:
                    probe.transcendentals += _numel(out)
                if probe._count_bytes:
                    probe.bytes += (_tensor_bytes(list(args))
                                    + _tensor_bytes(list((kwargs or {})
                                                         .values()))
                                    + _tensor_bytes(out))
                return out

        self._flops = FlopCounterMode(display=False)
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(self._flops)
        self._stack.enter_context(_Tally())
        return self

    def __exit__(self, *exc):
        self._stack.close()
        self._stack = None
        return False

    @property
    def flops(self) -> float:
        return float(self._flops.get_total_flops() + self.elementwise)

    def cost(self) -> Dict[str, float]:
        out = {"flops": self.flops,
               "transcendentals": float(self.transcendentals)}
        if self._count_bytes:
            out["bytes accessed"] = float(self.bytes)
        return out


def jit_cost(fn: Callable, *args, **kw) -> Dict[str, Any]:
    """Zero-run cost extraction: run ``fn`` on meta copies of its tensor
    arguments under ``CostProbe`` (shapes and dtypes only — nothing is
    computed) and return its cost dict."""
    import torch

    def meta(v):
        if isinstance(v, torch.Tensor):
            return torch.empty_like(v, device="meta")
        if isinstance(v, (list, tuple)):
            return type(v)(meta(x) for x in v)
        return v

    margs = [meta(a) for a in args]
    mkw = {k: meta(v) for k, v in kw.items()}
    with torch.no_grad(), CostProbe() as probe:
        fn(*margs, **mkw)
    return probe.cost()


def _sync():
    """End of a timed run: wait for the card's queued work when this
    process has used CUDA (a host-only runner needs no barrier)."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def measure_or_model(tunable_id: str, candidates: Sequence[Any], *,
                     runner: Optional[Callable[[Any], Any]] = None,
                     cost_fn: Optional[Callable[[Any], Dict[str, Any]]]
                     = None,
                     k: int = 5, shape_key: str = "",
                     cache: Optional[TuningCache] = None,
                     device: Optional[str] = None
                     ) -> Tuple[Any, Dict[str, Any]]:
    """Pick the best candidate and persist the decision.

    Returns ``(best, evidence)`` where evidence carries the per-
    candidate scores and the source ('cache' when a previous session
    already decided — nothing is run in that case)."""
    cands = list(candidates)
    if not cands:
        raise ValueError("measure_or_model needs at least one candidate")
    c = cache or get_cache()
    prior = c.lookup(tunable_id, shape_key=shape_key, device=device)
    if prior is not None:
        # match through JSON canonicalization: a persisted tuple comes
        # back as a list, and the repeat-session skip must still fire —
        # the caller gets ITS candidate object back, not the JSON form
        pc = _canon(prior)
        for cand in cands:
            if _canon(cand) == pc:
                return cand, {"source": "cache", "value": cand}
    scores: List[float] = []
    if runner is not None:
        with _tracing.span("autotune.measure", tunable=str(tunable_id),
                           candidates=len(cands)):
            for cand in cands:
                runner(cand)  # warmup: first-run costs never count
                _sync()
                times = []
                for _ in range(max(1, int(k))):
                    t0 = time.perf_counter()
                    runner(cand)
                    _sync()
                    times.append((time.perf_counter() - t0) * 1e3)
                    _m_measurements.inc()
                scores.append(round(_median(times), 4))
        source = "measured"
    elif cost_fn is not None:
        for cand in cands:
            scores.append(float(model_score(cost_fn(cand))))
            _m_modeled.inc()
        source = "model"
    else:
        raise ValueError("need a runner (measure) or a cost_fn (model)")
    # ties break to the FIRST candidate — callers order by preference
    best_i = min(range(len(cands)), key=lambda i: (scores[i], i))
    best = cands[best_i]
    evidence = {"source": source,
                "scores": {str(cand): s for cand, s in zip(cands, scores)},
                "value": best}
    c.put(tunable_id, best, shape_key=shape_key, source=source,
          device=device,
          extra={"scores": evidence["scores"]})
    return best, evidence


# -- the executor's per-shape step log -----------------------------------

def _program_fingerprint(program) -> str:
    """Hash of the op-type sequence AND the declared var shapes — op
    types alone would pool two same-stack models of different widths
    into one timing record. Memoized on the Program per version: the
    per-step path must not rehash a multi-thousand-op program."""
    cached = getattr(program, "_autotune_fingerprint", None)
    if cached is not None and cached[0] == program._version:
        return cached[1]
    block = program.global_block()
    ops = ",".join(op.desc.type for op in block.ops)
    shapes = ",".join(f"{n}:{tuple(v.shape) if v.shape else ()}"
                      for n, v in sorted(block.vars.items()))
    h = hashlib.md5(f"{ops}|{shapes}".encode()).hexdigest()[:8]
    program._autotune_fingerprint = (program._version, h)
    return h


def _dtype_name(v) -> str:
    # a torch dtype prints as 'torch.float32': keep numpy's spelling so
    # a numpy feed and a tensor feed of one dtype share a key
    dt = getattr(v, "dtype", None)
    if dt is None:
        dt = np.asarray(v).dtype
    return str(dt).replace("torch.", "")


def _shape(v) -> Tuple[int, ...]:
    shape = getattr(v, "shape", None)
    return tuple(int(d) for d in shape) if shape is not None \
        else tuple(np.shape(v))


def step_shape_key(program, feeds: Dict[str, Any]) -> str:
    """Stable fingerprint of (program structure, feed shapes/dtypes) —
    deliberately NOT ``program._version`` (a per-process counter that
    would never match across sessions): the op-type sequence hash plus
    the sorted feed signature."""
    sig = ";".join(
        f"{name}:{_dtype_name(v)}{_shape(v)}"
        for name, v in sorted(feeds.items()))
    return f"{_program_fingerprint(program)}|{sig}"


def note_step_timing(tunable_id: str, program, feeds: Dict[str, Any],
                     ms: float):
    """Log one steady-state step time under the program/shape key (the
    ``FLAGS['autotune']`` executor hook — a run that built its plan is
    excluded by the caller)."""
    get_cache().note_timing(tunable_id, step_shape_key(program, feeds),
                            float(ms))


def cached_step_ms(tunable_id: str, program,
                   feeds: Dict[str, Any]) -> Optional[float]:
    """Median step ms a previous session recorded for this exact
    program/shape, or None — the repeat-session measurement skip."""
    rec = get_cache().timing(tunable_id, step_shape_key(program, feeds))
    return float(rec["median_ms"]) if rec else None
