"""Static bucket ladders shared by the serving engines.

A decode step pads its slot count (and page-table width, and chunk
width) up to a fixed LADDER, so a churn of ragged requests only ever
runs a bounded set of shapes. These helpers parse and select from those
ladders; they are the part of ``paddle_tpu/serving/engine.py`` the
decode path needs. The one-shot ``InferenceEngine`` of that module
replays a saved Fluid program and waits for the Fluid port; the
``"auto"`` ladder needs the autotune layer, which is not ported yet.
"""
from __future__ import annotations

from typing import List, Sequence

__all__ = ["bucket_for", "parse_buckets", "default_buckets",
           "resolve_bucket_spec"]

# the hand-set geometric ladder (the JAX package's FLAGS default for
# serving_buckets)
_STATIC_BUCKETS = "1,2,4,8,16"


def default_buckets() -> List[int]:
    return parse_buckets(_STATIC_BUCKETS)


def _is_auto(spec) -> bool:
    return isinstance(spec, str) and spec.strip().lower() == "auto"


def resolve_bucket_spec(spec, *, tunable_id: str = "serving_buckets",
                        fallback: str = _STATIC_BUCKETS) -> List[int]:
    """Parse a literal ladder (``"1,2,4"`` or an int sequence). The
    ``"auto"`` ladder, derived from observed traffic and a per-device
    tuning cache, arrives with the autotune slice of the port."""
    if _is_auto(spec):
        raise NotImplementedError(
            f"{tunable_id}='auto' resolves through the autotune layer, "
            "which paddle_tpu_torch does not port yet (the autotune "
            f"slice) — pass a literal ladder such as {fallback!r}")
    return parse_buckets(spec)


def parse_buckets(spec) -> List[int]:
    """'1,2,4,8' (or an int sequence) -> sorted unique positive ladder."""
    if isinstance(spec, str):
        vals = [int(p) for p in spec.replace(";", ",").split(",") if p.strip()]
    else:
        vals = [int(v) for v in spec]
    vals = sorted(set(vals))
    if not vals or vals[0] < 1:
        raise ValueError(f"bucket ladder must be positive ints, got {spec!r}")
    return vals


def bucket_for(ladder: Sequence[int], n: int) -> int:
    """Smallest ladder entry >= n, clamped to the top bucket. The one
    bucket-selection rule for every engine in serving/ — admission
    bounds elsewhere keep n <= ladder[-1], so the clamp is defensive."""
    for b in ladder:
        if n <= b:
            return b
    return ladder[-1]
