"""v2 optimizers (reference python/paddle/v2/optimizer.py) — wrappers
binding fluid optimizers with v2 constructor names."""
from __future__ import annotations

from ..fluid import optimizer as _fopt


class _V2Optimizer:
    def __init__(self, fluid_opt):
        self.fluid_opt = fluid_opt


class Momentum(_V2Optimizer):
    def __init__(self, momentum=0.9, learning_rate=0.01, sparse=False,
                 regularization=None, **kwargs):
        super().__init__(_fopt.Momentum(learning_rate=learning_rate,
                                        momentum=momentum,
                                        regularization=regularization))


class Adam(_V2Optimizer):
    def __init__(self, learning_rate=1e-3, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, regularization=None, **kwargs):
        super().__init__(_fopt.Adam(learning_rate=learning_rate, beta1=beta1,
                                    beta2=beta2, epsilon=epsilon,
                                    regularization=regularization))


class AdaGrad(_V2Optimizer):
    def __init__(self, learning_rate=1e-2, regularization=None, **kwargs):
        super().__init__(_fopt.Adagrad(learning_rate=learning_rate,
                                       regularization=regularization))


class RMSProp(_V2Optimizer):
    def __init__(self, learning_rate=1e-2, rho=0.95, epsilon=1e-6,
                 regularization=None, **kwargs):
        super().__init__(_fopt.RMSProp(learning_rate=learning_rate, rho=rho,
                                       epsilon=epsilon,
                                       regularization=regularization))
