"""Weight-decay regularizers appended as ops on gradients (reference
python/paddle/fluid/regularizer.py:25,101,155) — a copy of
``paddle_tpu/fluid/regularizer.py``: L2 adds ``scale(param)``, L1
``scale(sign(param))``, each to the gradient through a ``sum`` op."""
from __future__ import annotations


class WeightDecayRegularizer:
    def append_regularization_ops(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff: float = 0.0):
        self._regularization_coeff = float(regularization_coeff)

    def __call__(self, param, grad, block):
        decay = block.create_var(
            name=param.name + ".l2decay", dtype=param.dtype, shape=param.shape,
            stop_gradient=True,
        )
        block.append_op(
            type="scale", inputs={"X": [param]}, outputs={"Out": [decay]},
            attrs={"scale": self._regularization_coeff},
        )
        return decay


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff: float = 0.0):
        self._regularization_coeff = float(regularization_coeff)

    def __call__(self, param, grad, block):
        sign = block.create_var(
            name=param.name + ".l1sign", dtype=param.dtype, shape=param.shape,
            stop_gradient=True,
        )
        block.append_op(type="sign", inputs={"X": [param]}, outputs={"Out": [sign]})
        decay = block.create_var(
            name=param.name + ".l1decay", dtype=param.dtype, shape=param.shape,
            stop_gradient=True,
        )
        block.append_op(
            type="scale", inputs={"X": [sign]}, outputs={"Out": [decay]},
            attrs={"scale": self._regularization_coeff},
        )
        return decay


def append_regularization_ops(parameters_and_grads, regularization=None):
    """reference regularizer.py append_regularization_ops: grad += decay."""
    params_and_grads = []
    for param, grad in parameters_and_grads:
        regularization_term = None
        reg = getattr(param, "regularizer", None) or regularization
        if grad is None or reg is None:
            params_and_grads.append((param, grad))
            continue
        block = grad.block
        regularization_term = reg(param, grad, block)
        new_grad = block.create_var(
            name=grad.name + ".reg", dtype=param.dtype, shape=param.shape,
            stop_gradient=True,
        )
        block.append_op(
            type="sum",
            inputs={"X": [grad, regularization_term]},
            outputs={"Out": [new_grad]},
        )
        params_and_grads.append((param, new_grad))
    return params_and_grads


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
