"""Generated thin wrappers over the unary ops (reference
python/paddle/fluid/layers/ops.py + layer_function_generator.py:222) and
the ``uniform_random`` / ``gaussian_random`` layers — a copy of
``paddle_tpu/fluid/layers/ops.py``."""
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


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random")
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(
        type="uniform_random", outputs={"Out": [out]},
        attrs={"shape": list(shape), "dtype": out.dtype, "min": min, "max": max,
               "seed": seed},
    )
    return out


def gaussian_random(shape, dtype="float32", mean=0.0, std=1.0, seed=0):
    helper = LayerHelper("gaussian_random")
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(
        type="gaussian_random", outputs={"Out": [out]},
        attrs={"shape": list(shape), "dtype": out.dtype, "mean": mean, "std": std,
               "seed": seed},
    )
    return out


__all__ += ["uniform_random", "gaussian_random"]
