"""ParamAttr (reference python/paddle/fluid/param_attr.py)."""
from __future__ import annotations

from .initializer import ConstantInitializer, Initializer, XavierInitializer


class ParamAttr:
    def __init__(
        self,
        name=None,
        initializer: Initializer = None,
        learning_rate: float = 1.0,
        regularizer=None,
        trainable: bool = True,
        gradient_clip=None,
        do_model_average=None,
    ):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        self.do_model_average = do_model_average

    def set_default_initializer(self, initializer):
        if self.initializer is None:
            self.initializer = initializer

    def set_default_param_initializer(self):
        self.set_default_initializer(XavierInitializer())

    def set_default_bias_initializer(self):
        self.set_default_initializer(ConstantInitializer(0.0))

    @staticmethod
    def to_attr(arg) -> "ParamAttr":
        if arg is None:
            return ParamAttr()
        if isinstance(arg, (list, tuple)):
            return [ParamAttr.to_attr(a) for a in arg]
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        if arg is False:
            # explicit opt-out (e.g. bias_attr=False disables the bias)
            return False
        if arg is True:
            return ParamAttr()
        return ParamAttr(learning_rate=float(arg))

    def to_kwargs(self, with_initializer: bool = False):
        kwargs = {
            "name": self.name,
            "optimize_attr": {"learning_rate": self.learning_rate},
            "regularizer": self.regularizer,
            "trainable": self.trainable,
            "gradient_clip_attr": self.gradient_clip,
            "do_model_average": self.do_model_average,
        }
        if with_initializer:
            kwargs["initializer"] = self.initializer
        return kwargs


class WeightNormParamAttr(ParamAttr):
    def __init__(self, dim=None, **kwargs):
        super().__init__(**kwargs)
        self.dim = dim
