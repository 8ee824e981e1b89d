"""Generated thin wrappers over the unary ops (reference
python/paddle/fluid/layers/ops.py + layer_function_generator.py:222) —
a copy of ``paddle_tpu/fluid/layers/ops.py``'s activation layers."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__act_ops__ = [
    "sigmoid", "logsigmoid", "exp", "relu", "tanh", "tanh_shrink", "softshrink",
    "sqrt", "abs", "ceil", "floor", "round", "reciprocal", "log", "square",
    "softplus", "softsign", "brelu", "leaky_relu", "soft_relu", "elu", "relu6",
    "pow", "stanh", "hard_sigmoid", "swish", "thresholded_relu", "hard_shrink",
    "gelu", "cumsum", "sign", "log_softmax",
]

__all__ = list(__act_ops__)


def _make_unary(op_type):
    def layer(x, name=None, **attrs):
        helper = LayerHelper(op_type, name=name)
        out = helper.create_variable_for_type_inference(dtype=x.dtype)
        helper.append_op(
            type=op_type, inputs={"X": [x]}, outputs={"Out": [out]}, attrs=attrs
        )
        return out

    layer.__name__ = op_type
    layer.__doc__ = f"emits the `{op_type}` op (see ops/activations.py)"
    return layer


for _op in __act_ops__:
    globals()[_op] = _make_unary(_op)
