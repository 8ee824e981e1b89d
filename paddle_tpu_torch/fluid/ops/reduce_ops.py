"""Reduction ops (reference paddle/fluid/operators/reduce_op.cc) — the
counterpart of ``paddle_tpu/fluid/ops/reduce_ops.py``."""
from __future__ import annotations

import torch

from ..registry import register_op
from .common import one


def _amax(x, dim, keepdim):
    return torch.amax(x, dim=dim, keepdim=keepdim)


def _amin(x, dim, keepdim):
    return torch.amin(x, dim=dim, keepdim=keepdim)


def _prod(x, dim, keepdim):
    # torch.prod takes one dim: reduce the named dims one at a time,
    # the highest first so the lower indices stay valid
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _reduce(name, fn):
    @register_op(name, ref="paddle/fluid/operators/reduce_op.cc")
    def _op(ctx, ins, attrs, _fn=fn):
        x = one(ins, "X")
        keep = bool(attrs.get("keep_dim", False))
        if bool(attrs.get("reduce_all", False)):
            dims = tuple(range(x.ndim))
        else:
            dims = attrs.get("dim", [0])
            if isinstance(dims, int):
                dims = [dims]
            dims = tuple(int(d) % max(x.ndim, 1) for d in dims)
        out = _fn(x, dims, keep)
        if bool(attrs.get("reduce_all", False)) and not keep:
            out = out.reshape((1,))
        return {"Out": out}

    return _op


_reduce("reduce_sum", lambda x, d, k: torch.sum(x, dim=d, keepdim=k))
_reduce("reduce_mean", lambda x, d, k: torch.mean(x, dim=d, keepdim=k))
_reduce("reduce_max", _amax)
_reduce("reduce_min", _amin)
_reduce("reduce_prod", _prod)
