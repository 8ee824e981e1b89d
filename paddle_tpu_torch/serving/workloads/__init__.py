"""Typed serving workloads on the shared KV substrate (the counterpart
of ``paddle_tpu/serving/workloads``).

One ``kind`` field on the wire selects among four request classes —
``generate``, ``constrained`` (TokenMaskSpec-masked logits),
``embed`` (prompt-only pooled hidden states + logprobs, zero decode
slots), and ``beam`` (k siblings over refcount-shared prompt pages).
"""
from .base import (BeamWorkload, ConstrainedWorkload, EmbedWorkload,
                   GenerateWorkload, WORKLOAD_KINDS, Workload,
                   parse_workload, run_workload)
from .beam import beam_search
from .masks import MaskAutomaton, MaskError, TokenMaskSpec

__all__ = [
    "Workload", "GenerateWorkload", "ConstrainedWorkload",
    "EmbedWorkload", "BeamWorkload", "WORKLOAD_KINDS",
    "parse_workload", "run_workload", "beam_search",
    "TokenMaskSpec", "MaskAutomaton", "MaskError",
]
