"""Optimizers — graph-building, the counterpart of
``paddle_tpu/fluid/optimizer.py`` (reference python/paddle/fluid/
optimizer.py: Optimizer:34, minimize:224, SGD:250, Momentum:283,
Adam:361): minimize = append_backward + per-param device-side optimizer
ops with accumulators.

Ported so far: the ``Optimizer`` base, ``SGDOptimizer``,
``MomentumOptimizer`` and ``AdamOptimizer``. Gradient clipping and weight-decay regularization are
not ported: ``minimize`` runs with their defaults (none) and raises when a
parameter or the optimizer asks for either. The other optimizers raise
"not yet ported" when constructed.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Optional

from . import unique_name
from .backward import append_backward
from .framework import Variable, default_main_program
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper


class Optimizer:
    def __init__(self, learning_rate, regularization=None, LARS_weight_decay=0.0):
        if not isinstance(learning_rate, (float, int, Variable)):
            raise TypeError("learning rate should be float or Variable")
        self.regularization = regularization
        self._learning_rate = learning_rate
        self._learning_rate_map: dict = {}
        self._accumulators: dict = defaultdict(dict)
        self.helper: Optional[LayerHelper] = None

    def _create_global_learning_rate(self):
        program = default_main_program()
        lr = self._global_learning_rate(program)
        if isinstance(lr, Variable):
            return
        if not isinstance(self._learning_rate, (float, int)):
            self._learning_rate_map[program] = self._learning_rate
            return
        self._learning_rate_map[program] = self.helper.create_global_variable(
            name=unique_name.generate("learning_rate"),
            shape=[1],
            persistable=True,
            dtype="float32",
        )
        self.helper.set_variable_initializer(
            self._learning_rate_map[program],
            ConstantInitializer(float(self._learning_rate)),
        )
        self._learning_rate_map[program].stop_gradient = True

    def _global_learning_rate(self, program=None):
        program = program or default_main_program()
        return self._learning_rate_map.get(program)

    def _create_param_lr(self, param_and_grad):
        param = param_and_grad[0]
        param_lr = getattr(param, "optimize_attr", {}).get("learning_rate", 1.0)
        if float(param_lr) != 1.0:
            raise NotImplementedError(
                f"a per-parameter learning rate ({param.name}: {param_lr}) "
                "needs the scale layer, not yet ported to paddle_tpu_torch")
        return self._global_learning_rate()

    # --- accumulators (reference optimizer.py _add_accumulator) -----------
    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        if param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        var = self.helper.create_global_variable(
            name=unique_name.generate(f"{param.name}_{name}"),
            dtype=dtype or param.dtype,
            shape=shape or param.shape,
            persistable=True,
        )
        self.helper.set_variable_initializer(
            var, ConstantInitializer(float(fill_value))
        )
        var.stop_gradient = True
        self._accumulators[name][param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    def _create_accumulators(self, block, parameters):
        pass

    def _finish_update(self, block):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    # --- passes -----------------------------------------------------------
    def create_optimization_pass(self, parameters_and_grads, loss,
                                 startup_program=None):
        program = loss.block.program
        self.helper = LayerHelper(self.__class__.__name__)
        self._create_global_learning_rate()
        block = program.global_block()
        self._create_accumulators(
            block, [p for p, g in parameters_and_grads if g is not None]
        )
        optimize_ops = []
        for param_and_grad in parameters_and_grads:
            if param_and_grad[1] is None:
                continue
            if getattr(param_and_grad[0], "trainable", True):
                optimize_ops.append(self._append_optimize_op(block, param_and_grad))
        self._finish_update(block)
        return optimize_ops

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = append_backward(loss, parameter_list, no_grad_set)
        for p, _ in params_grads:
            if getattr(p, "gradient_clip_attr", None) is not None:
                raise NotImplementedError(
                    f"gradient clipping ({p.name}) is not yet ported to "
                    "paddle_tpu_torch")
            if getattr(p, "regularizer", None) or self.regularization:
                raise NotImplementedError(
                    f"weight-decay regularization ({p.name}) is not yet "
                    "ported to paddle_tpu_torch")
        optimize_ops = self.create_optimization_pass(
            params_grads, loss, startup_program
        )
        return optimize_ops, params_grads


class SGDOptimizer(Optimizer):
    def __init__(self, learning_rate, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        return block.append_op(
            type="sgd",
            inputs={
                "Param": [param_and_grad[0]],
                "Grad": [param_and_grad[1]],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={"ParamOut": [param_and_grad[0]]},
        )


class MomentumOptimizer(Optimizer):
    _velocity_acc_str = "velocity"

    def __init__(self, learning_rate, momentum, use_nesterov=False, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "momentum"
        self._momentum = momentum
        self._use_nesterov = bool(use_nesterov)

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._velocity_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        velocity = self._get_accumulator(self._velocity_acc_str, param_and_grad[0])
        return block.append_op(
            type="momentum",
            inputs={
                "Param": [param_and_grad[0]],
                "Grad": [param_and_grad[1]],
                "Velocity": [velocity],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={
                "ParamOut": [param_and_grad[0]],
                "VelocityOut": [velocity],
            },
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov},
        )


class AdamOptimizer(Optimizer):
    _moment1_acc_str = "moment1"
    _moment2_acc_str = "moment2"
    _beta1_pow_acc_str = "beta1_pow_acc"
    _beta2_pow_acc_str = "beta2_pow_acc"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "adam"
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment1_acc_str, p)
            self._add_accumulator(self._moment2_acc_str, p)
            self._add_accumulator(
                self._beta1_pow_acc_str, p, fill_value=self._beta1, shape=[1]
            )
            self._add_accumulator(
                self._beta2_pow_acc_str, p, fill_value=self._beta2, shape=[1]
            )

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        m1 = self._get_accumulator(self._moment1_acc_str, p)
        m2 = self._get_accumulator(self._moment2_acc_str, p)
        b1p = self._get_accumulator(self._beta1_pow_acc_str, p)
        b2p = self._get_accumulator(self._beta2_pow_acc_str, p)
        return block.append_op(
            type="adam",
            inputs={
                "Param": [p], "Grad": [param_and_grad[1]],
                "LearningRate": [self._create_param_lr(param_and_grad)],
                "Moment1": [m1], "Moment2": [m2],
                "Beta1Pow": [b1p], "Beta2Pow": [b2p],
            },
            outputs={
                "ParamOut": [p], "Moment1Out": [m1], "Moment2Out": [m2],
                "Beta1PowOut": [b1p], "Beta2PowOut": [b2p],
            },
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon},
        )


def _not_ported(name: str):
    def make(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not yet ported to paddle_tpu_torch (ported: SGD, "
            "Momentum, Adam)")

    make.__name__ = name
    return make


AdagradOptimizer = _not_ported("AdagradOptimizer")
AdamaxOptimizer = _not_ported("AdamaxOptimizer")
DecayedAdagradOptimizer = _not_ported("DecayedAdagradOptimizer")
AdadeltaOptimizer = _not_ported("AdadeltaOptimizer")
RMSPropOptimizer = _not_ported("RMSPropOptimizer")
FtrlOptimizer = _not_ported("FtrlOptimizer")
ModelAverage = _not_ported("ModelAverage")

# reference exposes short aliases
SGD = SGDOptimizer
Adam = AdamOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
