"""Optimizers — graph-building, the counterpart of
``paddle_tpu/fluid/optimizer.py`` (reference python/paddle/fluid/
optimizer.py: Optimizer:34, minimize:224, SGD:250, Momentum:276,
Adagrad:320, Adam:361, Adamax:466, DecayedAdagrad:550, Adadelta:594,
RMSProp:676, Ftrl, ModelAverage:811): ``minimize`` = append_backward
(with ``error_clip_callback``) + gradient clip + regularization + one
device-side optimizer op per parameter with its accumulators. A
per-parameter learning rate (``ParamAttr(learning_rate=)``) scales the
global rate by a ``scale`` op. ``ModelAverage`` appends an
``average_accumulates`` op per parameter and keeps two small programs
that swap the averages in (``apply``) and the live values back
(``restore``).
"""
from __future__ import annotations

import contextlib

from collections import defaultdict
from typing import Optional

from . import unique_name
from .backward import append_backward
from .clip import append_gradient_clip_ops, error_clip_callback
from .framework import Program, Variable, default_main_program, program_guard
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops


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
        base = self._global_learning_rate()
        if float(param_lr) == 1.0:
            return base
        from .layers.nn import scale as scale_layer

        return scale_layer(base, scale=float(param_lr))

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
        params_grads = append_backward(
            loss, parameter_list, no_grad_set, [error_clip_callback]
        )
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads, self.regularization)
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


class AdagradOptimizer(Optimizer):
    _moment_acc_str = "moment"

    def __init__(self, learning_rate, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "adagrad"
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment = self._get_accumulator(self._moment_acc_str, param_and_grad[0])
        return block.append_op(
            type="adagrad",
            inputs={
                "Param": [param_and_grad[0]],
                "Grad": [param_and_grad[1]],
                "Moment": [moment],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={"ParamOut": [param_and_grad[0]], "MomentOut": [moment]},
            attrs={"epsilon": self._epsilon},
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


class AdamaxOptimizer(Optimizer):
    _moment_acc_str = "moment"
    _inf_norm_acc_str = "inf_norm"
    _beta1_pow_acc_str = "beta1_pow_acc"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "adamax"
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)
            self._add_accumulator(self._inf_norm_acc_str, p)
            self._add_accumulator(
                self._beta1_pow_acc_str, p, fill_value=self._beta1, shape=[1]
            )

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        moment = self._get_accumulator(self._moment_acc_str, p)
        inf_norm = self._get_accumulator(self._inf_norm_acc_str, p)
        b1p = self._get_accumulator(self._beta1_pow_acc_str, p)
        op = block.append_op(
            type="adamax",
            inputs={
                "Param": [p], "Grad": [param_and_grad[1]],
                "LearningRate": [self._create_param_lr(param_and_grad)],
                "Moment": [moment], "InfNorm": [inf_norm], "Beta1Pow": [b1p],
            },
            outputs={
                "ParamOut": [p], "MomentOut": [moment], "InfNormOut": [inf_norm],
            },
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon},
        )
        # beta1_pow update (reference appends a scale op per param)
        block.append_op(
            type="scale", inputs={"X": [b1p]}, outputs={"Out": [b1p]},
            attrs={"scale": self._beta1},
        )
        return op


class DecayedAdagradOptimizer(Optimizer):
    _moment_acc_str = "moment"

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "decayed_adagrad"
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment = self._get_accumulator(self._moment_acc_str, param_and_grad[0])
        return block.append_op(
            type="decayed_adagrad",
            inputs={
                "Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                "Moment": [moment],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={"ParamOut": [param_and_grad[0]], "MomentOut": [moment]},
            attrs={"decay": self._decay, "epsilon": self._epsilon},
        )


class AdadeltaOptimizer(Optimizer):
    _avg_squared_grad_acc_str = "_avg_squared_grad"
    _avg_squared_update_acc_str = "_avg_squared_update"

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "adadelta"
        self._epsilon, self._rho = epsilon, rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._avg_squared_grad_acc_str, p)
            self._add_accumulator(self._avg_squared_update_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        asg = self._get_accumulator(self._avg_squared_grad_acc_str, param_and_grad[0])
        asu = self._get_accumulator(self._avg_squared_update_acc_str, param_and_grad[0])
        return block.append_op(
            type="adadelta",
            inputs={
                "Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                "AvgSquaredGrad": [asg], "AvgSquaredUpdate": [asu],
            },
            outputs={
                "ParamOut": [param_and_grad[0]],
                "AvgSquaredGradOut": [asg], "AvgSquaredUpdateOut": [asu],
            },
            attrs={"epsilon": self._epsilon, "rho": self._rho},
        )


class RMSPropOptimizer(Optimizer):
    _momentum_acc_str = "momentum"
    _mean_square_acc_str = "mean_square"

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "rmsprop"
        self._rho, self._epsilon, self._momentum = rho, epsilon, momentum

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._momentum_acc_str, p)
            self._add_accumulator(self._mean_square_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        mom = self._get_accumulator(self._momentum_acc_str, param_and_grad[0])
        ms = self._get_accumulator(self._mean_square_acc_str, param_and_grad[0])
        return block.append_op(
            type="rmsprop",
            inputs={
                "Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                "Moment": [mom], "MeanSquare": [ms],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={
                "ParamOut": [param_and_grad[0]],
                "MomentOut": [mom], "MeanSquareOut": [ms],
            },
            attrs={"epsilon": self._epsilon, "decay": self._rho,
                   "momentum": self._momentum},
        )


class FtrlOptimizer(Optimizer):
    _squared_acc_str = "squared"
    _linear_acc_str = "linear"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "ftrl"
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._squared_acc_str, p)
            self._add_accumulator(self._linear_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        sq = self._get_accumulator(self._squared_acc_str, param_and_grad[0])
        lin = self._get_accumulator(self._linear_acc_str, param_and_grad[0])
        return block.append_op(
            type="ftrl",
            inputs={
                "Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                "SquaredAccumulator": [sq], "LinearAccumulator": [lin],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={
                "ParamOut": [param_and_grad[0]],
                "SquaredAccumOut": [sq], "LinearAccumOut": [lin],
            },
            attrs={"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power},
        )


class ModelAverage(Optimizer):
    """Polyak-style windowed parameter averaging (reference optimizer.py:811):
    appends an `average_accumulates` op per parameter to the main program;
    `apply()` swaps averaged values into the params (context manager),
    `restore()` swaps the live values back."""

    def __init__(self, average_window_rate, params_grads=None,
                 min_average_window=10000, max_average_window=10000, **kwargs):
        super().__init__(0.0, **kwargs)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        self.params_grads = [] if params_grads is None else list(params_grads)

        main = default_main_program()
        existing = {p.name for p, _ in self.params_grads}
        for param in main.global_block().all_parameters():
            if param.name not in existing and getattr(param, "trainable", True):
                self.params_grads.append((param, None))

        self.helper = LayerHelper("model_average")
        for param, _ in self.params_grads:
            self._append_average_accumulate_op(param)

        self.apply_program = Program()
        block = self.apply_program.global_block()
        with program_guard(main_program=self.apply_program):
            for param_grad in self.params_grads:
                self._add_average_apply_op(block, param_grad)

        self.restore_program = Program()
        block = self.restore_program.global_block()
        with program_guard(main_program=self.restore_program):
            for param_grad in self.params_grads:
                self._add_average_restore_op(block, param_grad)

    def _clone(self, block, var):
        return block.create_var(
            name=var.name, shape=var.shape, dtype=var.dtype, persistable=True
        )

    def _add_average_apply_op(self, block, param_grad):
        from .layers import tensor as tensor_layers

        param = self._clone(block, param_grad[0])
        backup = block.create_var(
            name=param.name + "@BACKUP", shape=param.shape, dtype=param.dtype,
            persistable=True,
        )
        sum_1 = self._clone(block, self._get_accumulator("sum_1", param_grad[0]))
        sum_2 = self._clone(block, self._get_accumulator("sum_2", param_grad[0]))
        sum_3 = self._clone(block, self._get_accumulator("sum_3", param_grad[0]))
        num_accumulates = self._clone(
            block, self._get_accumulator("num_accumulates", param_grad[0])
        )
        old_num_accumulates = self._clone(
            block, self._get_accumulator("old_num_accumulates", param_grad[0])
        )
        # backup current value, then param = total_sum / total_count
        tensor_layers.assign(input=param, output=backup)
        total = tensor_layers.sums(input=[sum_1, sum_2, sum_3])
        count = tensor_layers.cast(
            tensor_layers.sums(input=[num_accumulates, old_num_accumulates]),
            "float32",
        )
        block.append_op(
            type="elementwise_div",
            inputs={"X": [total], "Y": [count]},
            outputs={"Out": [param]},
            attrs={"axis": -1},
        )

    def _add_average_restore_op(self, block, param_grad):
        from .layers import tensor as tensor_layers

        param = self._clone(block, param_grad[0])
        backup = block.create_var(
            name=param.name + "@BACKUP", shape=param.shape, dtype=param.dtype,
            persistable=True,
        )
        tensor_layers.assign(input=backup, output=param)

    def _append_average_accumulate_op(self, param):
        self.helper = LayerHelper("average_accumulate")
        sum_1 = self._add_accumulator("sum_1", param)
        sum_2 = self._add_accumulator("sum_2", param)
        sum_3 = self._add_accumulator("sum_3", param)
        num_accumulates = self._add_accumulator(
            "num_accumulates", param, dtype="int64", shape=[1]
        )
        old_num_accumulates = self._add_accumulator(
            "old_num_accumulates", param, dtype="int64", shape=[1]
        )
        num_updates = self._add_accumulator(
            "num_updates", param, dtype="int64", shape=[1]
        )
        self.helper.append_op(
            type="average_accumulates",
            inputs={
                "Param": [param], "Sum1": [sum_1], "Sum2": [sum_2],
                "Sum3": [sum_3], "NumAccumulates": [num_accumulates],
                "OldNumAccumulates": [old_num_accumulates],
                "NumUpdates": [num_updates],
            },
            outputs={
                "SumOut1": [sum_1], "SumOut2": [sum_2], "SumOut3": [sum_3],
                "NumAccumulatesOut": [num_accumulates],
                "OldNumAccumulatesOut": [old_num_accumulates],
                "NumUpdatesOut": [num_updates],
            },
            attrs={
                "average_window": self.average_window,
                "min_average_window": self.min_average_window,
                "max_average_window": self.max_average_window,
            },
        )

    @contextlib.contextmanager
    def apply(self, executor, need_restore=True):
        executor.run(self.apply_program)
        try:
            yield
        finally:
            if need_restore:
                self.restore(executor)

    def restore(self, executor):
        executor.run(self.restore_program)


# reference exposes short aliases
SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
