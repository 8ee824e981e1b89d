"""reference python/paddle/v2/op.py: arithmetic sugar over layers —
add/sub/mul/neg between layer outputs (and scalars) via the elementwise
and slope_intercept ops, exactly the operator set the reference
monkey-patched onto LayerOutput."""
from ..fluid import layers as _fl


def add(a, b):
    if isinstance(b, (int, float)):
        return _fl.scale(a, scale=1.0, bias=float(b))
    return _fl.elementwise_add(a, b)


def sub(a, b):
    if isinstance(b, (int, float)):
        return _fl.scale(a, scale=1.0, bias=-float(b))
    return _fl.elementwise_sub(a, b)


def neg(a):
    return _fl.scale(a, scale=-1.0)


def mul(a, b):
    if isinstance(b, (int, float)):
        return _fl.scale(a, scale=float(b))
    return _fl.elementwise_mul(a, b)
