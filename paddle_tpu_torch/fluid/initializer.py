"""Initializers — emit init ops into the startup program.

Capability-parity with reference `python/paddle/fluid/initializer.py`
(Constant:103, Uniform:145, Normal:196, Xavier:246, MSRA:339). A copy of
``paddle_tpu/fluid/initializer.py``: the same startup ops
(``fill_constant``, ``uniform_random``, ``gaussian_random``,
``assign_value``), whose emitters draw from ``torch.Generator``s.
"""
from __future__ import annotations

import math

import numpy as np

from .framework import Block, Variable


class Initializer:
    def __call__(self, var: Variable, block: Block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value: float = 0.0, force_cpu: bool = False):
        self._value = float(value)

    def __call__(self, var: Variable, block: Block):
        return block.append_op(
            type="fill_constant",
            outputs={"Out": [var.name]},
            attrs={"shape": list(var.shape), "dtype": var.dtype, "value": self._value},
        )


class UniformInitializer(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0, seed: int = 0):
        self._low, self._high, self._seed = float(low), float(high), int(seed)

    def __call__(self, var: Variable, block: Block):
        return block.append_op(
            type="uniform_random",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(var.shape), "dtype": var.dtype,
                "min": self._low, "max": self._high, "seed": self._seed,
            },
        )


class NormalInitializer(Initializer):
    def __init__(self, loc: float = 0.0, scale: float = 1.0, seed: int = 0):
        self._mean, self._std, self._seed = float(loc), float(scale), int(seed)

    def __call__(self, var: Variable, block: Block):
        return block.append_op(
            type="gaussian_random",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(var.shape), "dtype": var.dtype,
                "mean": self._mean, "std": self._std, "seed": self._seed,
            },
        )


def _fan_in_out(var: Variable):
    shape = var.shape
    if len(shape) < 2:
        return shape[0] if shape else 1, shape[0] if shape else 1
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    fan_in = shape[0] * receptive if len(shape) > 2 else shape[0]
    fan_out = shape[1] * receptive if len(shape) > 2 else shape[1]
    # conv weights are [out_c, in_c, kh, kw] (reference conv2d layout)
    if len(shape) > 2:
        fan_in = shape[1] * receptive
        fan_out = shape[0] * receptive
    return fan_in, fan_out


class XavierInitializer(Initializer):
    """Glorot init (reference initializer.py:246)."""

    def __init__(self, uniform: bool = True, fan_in=None, fan_out=None, seed: int = 0):
        self._uniform, self._fan_in, self._fan_out, self._seed = uniform, fan_in, fan_out, int(seed)

    def __call__(self, var: Variable, block: Block):
        f_in, f_out = _fan_in_out(var)
        f_in = self._fan_in if self._fan_in is not None else f_in
        f_out = self._fan_out if self._fan_out is not None else f_out
        if self._uniform:
            limit = math.sqrt(6.0 / (f_in + f_out))
            return UniformInitializer(-limit, limit, self._seed)(var, block)
        std = math.sqrt(2.0 / (f_in + f_out))
        return NormalInitializer(0.0, std, self._seed)(var, block)


class MSRAInitializer(Initializer):
    """He/Kaiming init (reference initializer.py:339)."""

    def __init__(self, uniform: bool = True, fan_in=None, seed: int = 0):
        self._uniform, self._fan_in, self._seed = uniform, fan_in, int(seed)

    def __call__(self, var: Variable, block: Block):
        f_in, _ = _fan_in_out(var)
        f_in = self._fan_in if self._fan_in is not None else f_in
        if self._uniform:
            limit = math.sqrt(6.0 / f_in)
            return UniformInitializer(-limit, limit, self._seed)(var, block)
        std = math.sqrt(2.0 / f_in)
        return NormalInitializer(0.0, std, self._seed)(var, block)


class NumpyArrayInitializer(Initializer):
    def __init__(self, value: np.ndarray):
        self._value = np.asarray(value)

    def __call__(self, var: Variable, block: Block):
        return block.append_op(
            type="assign_value",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(self._value.shape),
                "dtype": var.dtype,
                "values": self._value.ravel().tolist(),
            },
        )


# reference exposes aliases
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer

_global_weight_initializer = None
_global_bias_initializer = None


def force_init_on_cpu() -> bool:
    return False
