"""RNG ops (reference paddle/fluid/operators/{uniform_random,
gaussian_random,uniform_random_batch_size_like,
gaussian_random_batch_size_like,dropout}_op.*).
Each op instance draws from ``ctx.rng(attrs)``: a generator seeded from
the step seed and the op's seed attrs, so a replayed forward draws the
same numbers (registry.EmitCtx.rng)."""
from __future__ import annotations

import torch

from ..registry import register_op
from .common import dtype_of, one


def _batch_size_like(ins, attrs):
    """``shape`` with dim ``output_dim_idx`` taken from Input's dim
    ``input_dim_idx``."""
    shape = [int(s) for s in attrs["shape"]]
    shape[int(attrs.get("output_dim_idx", 0))] = \
        one(ins, "Input").shape[int(attrs.get("input_dim_idx", 0))]
    return shape


def _uniform(ctx, shape, attrs):
    out = torch.empty(shape, dtype=dtype_of(attrs), device=ctx.device)
    return {"Out": out.uniform_(float(attrs.get("min", -1.0)),
                                float(attrs.get("max", 1.0)),
                                generator=ctx.rng(attrs))}


def _gaussian(ctx, shape, attrs):
    out = torch.empty(shape, dtype=dtype_of(attrs), device=ctx.device)
    return {"Out": out.normal_(float(attrs.get("mean", 0.0)),
                               float(attrs.get("std", 1.0)),
                               generator=ctx.rng(attrs))}


@register_op("uniform_random", needs_rng=True,
             ref="paddle/fluid/operators/uniform_random_op.cc")
def uniform_random(ctx, ins, attrs):
    return _uniform(ctx, [int(s) for s in attrs["shape"]], attrs)


@register_op("uniform_random_batch_size_like", needs_rng=True,
             ref="paddle/fluid/operators/"
                 "uniform_random_batch_size_like_op.cc")
def uniform_random_batch_size_like(ctx, ins, attrs):
    return _uniform(ctx, _batch_size_like(ins, attrs), attrs)


@register_op("gaussian_random", needs_rng=True,
             ref="paddle/fluid/operators/gaussian_random_op.cc")
def gaussian_random(ctx, ins, attrs):
    return _gaussian(ctx, [int(s) for s in attrs["shape"]], attrs)


@register_op("gaussian_random_batch_size_like", needs_rng=True,
             ref="paddle/fluid/operators/"
                 "gaussian_random_batch_size_like_op.cc")
def gaussian_random_batch_size_like(ctx, ins, attrs):
    return _gaussian(ctx, _batch_size_like(ins, attrs), attrs)


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
