"""Typed request classes the serving stack dispatches on.

One ``kind`` field on the wire selects the workload:

    generate     next-token generation (the pre-existing behavior)
    constrained  generation under a TokenMaskSpec (masks.py)
    embed        prompt-only pooled hidden states + per-token logprobs
    beam         n-best: k sibling continuations over SHARED prompt
                 pages (beam.py)

``parse_workload`` validates a wire dict into a workload object
(unknown kinds refuse loudly — a typo must not silently decode
unconstrained); ``run_workload`` executes one against a DecodeEngine
and carries the per-kind observability: a ``serving.workload.<kind>``
fault site (chaos seam), span, request counter, and latency histogram.
The dispatch lives HERE rather than in the server so engine-direct
callers and the RPC path populate the same per-kind series.

Every workload runs on mechanism the engine already warms: constrained
decode is host-side logit masking over the plain step, embeddings ride
the chunked-prefill path in their own slot lane, and beams are prefix-
index sharing — a mixed churn of all four kinds runs no step
shape that warm() did not.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

from ...distributed import faults as _faults
from ...observability import metrics as _metrics, tracing as _tracing
from .masks import TokenMaskSpec

__all__ = ["Workload", "GenerateWorkload", "ConstrainedWorkload",
           "EmbedWorkload", "BeamWorkload", "WORKLOAD_KINDS",
           "parse_workload", "run_workload"]

WORKLOAD_KINDS = ("generate", "constrained", "embed", "beam")


def _prompt_of(d: Dict[str, Any]) -> List[int]:
    prompt = d.get("prompt")
    if not prompt:
        raise ValueError("workload needs a non-empty 'prompt'")
    return [int(t) for t in prompt]


class Workload:
    """Base class: ``kind`` + wire (de)serialization. Subclasses
    implement ``run(engine)`` returning the result dict."""

    kind = ""

    def to_dict(self) -> Dict[str, Any]:
        raise NotImplementedError

    def run(self, engine) -> Dict[str, Any]:
        raise NotImplementedError


class GenerateWorkload(Workload):
    kind = "generate"

    def __init__(self, prompt: Sequence[int], max_new_tokens: int = 16,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 deadline_ms: Optional[float] = None):
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.seed = int(seed)
        self.deadline_ms = deadline_ms

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "prompt": self.prompt,
                "max_new_tokens": self.max_new_tokens,
                "temperature": self.temperature, "top_k": self.top_k,
                "seed": self.seed, "deadline_ms": self.deadline_ms}

    def run(self, engine) -> Dict[str, Any]:
        return engine.generate(
            self.prompt, self.max_new_tokens,
            deadline_ms=self.deadline_ms, temperature=self.temperature,
            top_k=self.top_k, seed=self.seed)


class ConstrainedWorkload(GenerateWorkload):
    kind = "constrained"

    def __init__(self, prompt: Sequence[int], mask: Any,
                 max_new_tokens: int = 16, temperature: float = 0.0,
                 top_k: int = 0, seed: int = 0,
                 deadline_ms: Optional[float] = None):
        super().__init__(prompt, max_new_tokens, temperature, top_k,
                         seed, deadline_ms)
        if isinstance(mask, dict):
            mask = TokenMaskSpec.from_dict(mask)
        if not isinstance(mask, TokenMaskSpec):
            raise ValueError(
                f"constrained workload needs a TokenMaskSpec (or its "
                f"wire dict), got {type(mask).__name__}")
        self.mask = mask

    def to_dict(self) -> Dict[str, Any]:
        d = super().to_dict()
        d["kind"] = self.kind
        d["mask"] = self.mask.to_dict()
        return d

    def run(self, engine) -> Dict[str, Any]:
        return engine.generate(
            self.prompt, self.max_new_tokens,
            deadline_ms=self.deadline_ms, temperature=self.temperature,
            top_k=self.top_k, seed=self.seed, mask=self.mask)


class EmbedWorkload(Workload):
    kind = "embed"

    def __init__(self, prompt: Sequence[int],
                 deadline_ms: Optional[float] = None):
        self.prompt = [int(t) for t in prompt]
        self.deadline_ms = deadline_ms

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "prompt": self.prompt,
                "deadline_ms": self.deadline_ms}

    def run(self, engine) -> Dict[str, Any]:
        return engine.embed(self.prompt, deadline_ms=self.deadline_ms)


class BeamWorkload(Workload):
    kind = "beam"

    def __init__(self, prompt: Sequence[int], k: int = 2,
                 max_new_tokens: int = 16,
                 deadline_ms: Optional[float] = None):
        self.prompt = [int(t) for t in prompt]
        self.k = int(k)
        if self.k < 1:
            raise ValueError(f"beam width k must be >= 1, got {self.k}")
        self.max_new_tokens = int(max_new_tokens)
        self.deadline_ms = deadline_ms

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "prompt": self.prompt, "k": self.k,
                "max_new_tokens": self.max_new_tokens,
                "deadline_ms": self.deadline_ms}

    def run(self, engine) -> Dict[str, Any]:
        from .beam import beam_search

        return beam_search(engine, self.prompt, self.k,
                           self.max_new_tokens,
                           deadline_ms=self.deadline_ms)


_KIND_ARGS = {
    "generate": ("max_new_tokens", "temperature", "top_k", "seed",
                 "deadline_ms"),
    "constrained": ("mask", "max_new_tokens", "temperature", "top_k",
                    "seed", "deadline_ms"),
    "embed": ("deadline_ms",),
    "beam": ("k", "max_new_tokens", "deadline_ms"),
}

_KIND_CLS = {
    "generate": GenerateWorkload,
    "constrained": ConstrainedWorkload,
    "embed": EmbedWorkload,
    "beam": BeamWorkload,
}


def parse_workload(wire: Dict[str, Any]) -> Workload:
    """Wire dict -> workload object. Refuses unknown kinds AND unknown
    keys: a misspelled field silently falling back to a default is a
    wrong-workload dispatch (same discipline as DecoderSpec.from_dict).
    """
    if isinstance(wire, Workload):
        return wire
    if not isinstance(wire, dict):
        raise ValueError(
            f"workload must be a dict, got {type(wire).__name__}")
    kind = wire.get("kind", "generate")
    cls = _KIND_CLS.get(kind)
    if cls is None:
        raise ValueError(
            f"unknown workload kind {kind!r}; valid: "
            f"{sorted(WORKLOAD_KINDS)}")
    allowed = set(_KIND_ARGS[kind]) | {"kind", "prompt"}
    unknown = sorted(set(wire) - allowed)
    if unknown:
        raise ValueError(
            f"workload kind {kind!r} has unknown field(s) {unknown}; "
            f"valid: {sorted(allowed)}")
    kwargs = {k: wire[k] for k in _KIND_ARGS[kind] if k in wire
              and wire[k] is not None}
    return cls(_prompt_of(wire), **kwargs)


def run_workload(engine, w: Any) -> Dict[str, Any]:
    """Execute one workload against a DecodeEngine with the per-kind
    observability envelope: ``serving.workload.<kind>`` is the chaos
    fault site AND the span name; ``.requests``/``.ms`` are the
    counter/latency series a caller reads back. The
    result dict carries ``kind`` so a client can dispatch on what it
    got back."""
    w = parse_workload(w)
    kind = w.kind
    _faults.fire(f"serving.workload.{kind}")
    _metrics.counter(f"serving.workload.{kind}.requests").inc()
    t0 = time.perf_counter()
    with _tracing.span(f"serving.workload.{kind}", model=engine.name,
                       version=engine.version):
        out = dict(w.run(engine))
    _metrics.histogram(f"serving.workload.{kind}.ms").observe(
        (time.perf_counter() - t0) * 1e3)
    out["kind"] = kind
    return out
