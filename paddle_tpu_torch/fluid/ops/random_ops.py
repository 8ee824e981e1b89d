"""RNG ops (reference paddle/fluid/operators/{uniform_random,
gaussian_random,dropout}_op.*).
Each op instance draws from ``ctx.rng(attrs)``: a generator seeded from
the step seed and the op's seed attrs, so a replayed forward draws the
same numbers (registry.EmitCtx.rng)."""
from __future__ import annotations

import torch

from ..registry import register_op
from .common import dtype_of, one


@register_op("uniform_random", needs_rng=True,
             ref="paddle/fluid/operators/uniform_random_op.cc")
def uniform_random(ctx, ins, attrs):
    shape = [int(s) for s in attrs["shape"]]
    out = torch.empty(shape, dtype=dtype_of(attrs), device=ctx.device)
    return {"Out": out.uniform_(float(attrs.get("min", -1.0)),
                                float(attrs.get("max", 1.0)),
                                generator=ctx.rng(attrs))}


@register_op("gaussian_random", needs_rng=True,
             ref="paddle/fluid/operators/gaussian_random_op.cc")
def gaussian_random(ctx, ins, attrs):
    shape = [int(s) for s in attrs["shape"]]
    out = torch.empty(shape, dtype=dtype_of(attrs), device=ctx.device)
    return {"Out": out.normal_(float(attrs.get("mean", 0.0)),
                               float(attrs.get("std", 1.0)),
                               generator=ctx.rng(attrs))}


@register_op("dropout", needs_rng=True, ref="paddle/fluid/operators/dropout_op.cc")
def dropout(ctx, ins, attrs):
    x = one(ins, "X")
    p = float(attrs.get("dropout_prob", 0.5))
    if bool(attrs.get("is_test", False)):
        # reference-era "downgrade in infer": scale at test time
        return {"Out": x * (1.0 - p), "Mask": torch.ones_like(x)}
    u = torch.rand(x.shape, generator=ctx.rng(attrs), dtype=x.dtype,
                   device=x.device)
    mask = (u < 1.0 - p).to(x.dtype)
    return {"Out": x * mask, "Mask": mask}
