"""Arithmetic and ordering operators on ``Variable`` (reference
python/paddle/fluid/layers/math_op_patch.py), a copy of
``paddle_tpu/fluid/layers/math_op_patch.py``: ``a + b`` appends an
``elementwise_add`` op, ``a < b`` a ``less_than`` op; a Python number
becomes a ``fill_constant`` of shape [1] in the Variable's dtype."""
from __future__ import annotations

from ..framework import Variable
from ..layer_helper import LayerHelper


def _binary(op_type, reverse=False):
    def impl(self, other):
        helper = LayerHelper(op_type)
        if not isinstance(other, Variable):
            from .tensor import fill_constant

            if isinstance(other, (int, float)):
                other = fill_constant(
                    shape=[1], dtype=self.dtype, value=float(other)
                )
            else:
                raise TypeError(f"unsupported operand for {op_type}: {type(other)}")
        x, y = (other, self) if reverse else (self, other)
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        helper.append_op(
            type=op_type, inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]},
            attrs={"axis": -1},
        )
        return out

    return impl


def _scale(scale_val=None, bias_val=None):
    def impl(self):
        helper = LayerHelper("scale")
        out = helper.create_variable_for_type_inference(dtype=self.dtype)
        helper.append_op(
            type="scale", inputs={"X": [self]}, outputs={"Out": [out]},
            attrs={"scale": scale_val if scale_val is not None else 1.0,
                   "bias": bias_val if bias_val is not None else 0.0},
        )
        return out

    return impl


Variable.__add__ = _binary("elementwise_add")
Variable.__radd__ = _binary("elementwise_add", reverse=True)
Variable.__sub__ = _binary("elementwise_sub")
Variable.__rsub__ = _binary("elementwise_sub", reverse=True)
Variable.__mul__ = _binary("elementwise_mul")
Variable.__rmul__ = _binary("elementwise_mul", reverse=True)
Variable.__truediv__ = _binary("elementwise_div")
Variable.__rtruediv__ = _binary("elementwise_div", reverse=True)
Variable.__pow__ = _binary("elementwise_pow")
Variable.__rpow__ = _binary("elementwise_pow", reverse=True)
Variable.__neg__ = _scale(scale_val=-1.0)
Variable.__lt__ = _binary("less_than")
Variable.__le__ = _binary("less_equal")
Variable.__gt__ = _binary("greater_than")
Variable.__ge__ = _binary("greater_equal")
