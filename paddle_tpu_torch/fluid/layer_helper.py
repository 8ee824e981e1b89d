"""LayerHelper — parameter creation + op appending glue for layer functions.

Capability-parity with reference `python/paddle/fluid/layer_helper.py`:
parameters are created in BOTH programs: a Parameter var in the main program's
global block and a var+init-op in the startup program (reference behavior —
startup runs once to materialize params in the scope).
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Optional

from . import unique_name
from .enforce import enforce_not_none
from .framework import (
    Parameter, Variable, default_main_program, default_startup_program,
)
from .initializer import ConstantInitializer, XavierInitializer
from .param_attr import ParamAttr


class LayerHelper:
    def __init__(self, layer_type: str, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = self.kwargs.get("name")
        if name is None:
            self.kwargs["name"] = unique_name.generate(layer_type)

    @property
    def name(self) -> str:
        return self.kwargs["name"]

    @property
    def main_program(self):
        return self.kwargs.get("main_program") or default_main_program()

    @property
    def startup_program(self):
        return self.kwargs.get("startup_program") or default_startup_program()

    @property
    def param_attr(self) -> ParamAttr:
        return ParamAttr.to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        return ParamAttr.to_attr(self.kwargs.get("bias_attr"))

    def multiple_param_attr(self, length: int):
        attr = self.param_attr
        attrs = attr if isinstance(attr, list) else [attr]
        if len(attrs) == 1 and length != 1:
            attrs = attrs + [copy.deepcopy(attrs[0]) for _ in range(length - 1)]
        return attrs

    def append_op(self, **kwargs):
        return self.main_program.current_block().append_op(**kwargs)

    def create_parameter(
        self,
        attr: ParamAttr,
        shape,
        dtype,
        is_bias: bool = False,
        default_initializer=None,
    ) -> Parameter:
        attr = copy.deepcopy(attr) if attr is not None else ParamAttr()
        if attr.name is None:
            attr.name = unique_name.generate(f"{self.name}.w")
        if default_initializer is None:
            if is_bias:
                attr.set_default_bias_initializer()
            else:
                attr.set_default_param_initializer()
        else:
            attr.set_default_initializer(default_initializer)
        if not attr.trainable and attr.initializer is None:
            attr.set_default_initializer(ConstantInitializer(0.0))

        main_block = self.main_program.global_block()
        if main_block.has_var(attr.name):
            # shared parameter (e.g. one embedding table behind several
            # lookups): return the existing Parameter instead of
            # re-creating it — and, crucially, instead of appending a
            # SECOND initializer op to the startup program, where every
            # write but the last is dead (verifier V007) and each re-init
            # wastes a random draw
            existing = main_block.var(attr.name)
            if not isinstance(existing, Parameter):
                raise ValueError(
                    f"var '{attr.name}' already exists and is not a "
                    "parameter — pick a different ParamAttr name")
            if existing.shape is not None and tuple(existing.shape) != \
                    tuple(shape):
                raise ValueError(
                    f"shared parameter '{attr.name}' re-declared with "
                    f"shape {tuple(shape)} != existing "
                    f"{tuple(existing.shape)}")
            from .core import convert_dtype

            if existing.dtype != convert_dtype(dtype):
                raise ValueError(
                    f"shared parameter '{attr.name}' re-declared with "
                    f"dtype {convert_dtype(dtype)} != existing "
                    f"{existing.dtype}")
            return existing

        startup_block = self.startup_program.global_block()
        if startup_block.has_var(attr.name):
            # a reused startup program (fresh main built against it):
            # the existing initializer must actually produce THIS
            # parameter — a silently-kept stale init would materialize a
            # wrong-shaped/typed value at scope setup
            from .core import convert_dtype

            sv = startup_block.var(attr.name)
            if (sv.shape is not None and tuple(sv.shape) != tuple(shape)) \
                    or sv.dtype != convert_dtype(dtype):
                raise ValueError(
                    f"parameter '{attr.name}' already has an initializer "
                    f"in the startup program with shape {sv.shape} / "
                    f"dtype {sv.dtype}, but is re-declared as "
                    f"{tuple(shape)} / {convert_dtype(dtype)} — use a "
                    "fresh startup program (or a different ParamAttr "
                    "name)")
        else:
            sv = startup_block.create_var(
                name=attr.name, shape=shape, dtype=dtype, persistable=True,
            )
            attr.initializer(sv, startup_block)

        return main_block.create_parameter(
            name=attr.name, shape=shape, dtype=dtype,
            **{k: v for k, v in attr.to_kwargs().items() if k != "name"},
        )

    def create_variable_for_type_inference(self, dtype, stop_gradient=False) -> Variable:
        return self.main_program.current_block().create_var(
            name=unique_name.generate(f"{self.name}.tmp"),
            dtype=dtype,
            stop_gradient=stop_gradient,
        )

    # reference-era alias
    create_tmp_variable = create_variable_for_type_inference

    def create_variable(self, **kwargs) -> Variable:
        return self.main_program.current_block().create_var(**kwargs)

    def create_global_variable(self, persistable=False, **kwargs) -> Variable:
        return self.main_program.global_block().create_var(
            persistable=persistable, **kwargs
        )

    def set_variable_initializer(self, var: Variable, initializer):
        startup_block = self.startup_program.global_block()
        if not startup_block.has_var(var.name):
            sv = startup_block.create_var(
                name=var.name, shape=var.shape, dtype=var.dtype, persistable=True,
            )
            initializer(sv, startup_block)

    def input(self, input_param_name: str = "input"):
        inputs = self.kwargs.get(input_param_name)
        if isinstance(inputs, (list, tuple)):
            return list(inputs)
        return inputs

    def append_bias_op(self, input_var: Variable, dim_start: int = 1, dim_end=None):
        enforce_not_none(
            input_var.shape,
            f"shape of '{input_var.name}' (build-time inference could not "
            f"resolve the producing op's output shape; check the dims "
            f"feeding layer '{self.layer_type}')",
            context=self.layer_type,
        )
        size = list(input_var.shape[dim_start:dim_end])
        bias_attr = self.bias_attr
        if bias_attr is False or bias_attr is None:
            return input_var
        b = self.create_parameter(bias_attr, shape=size, dtype=input_var.dtype, is_bias=True)
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(
            type="elementwise_add",
            inputs={"X": [input_var], "Y": [b]},
            outputs={"Out": [tmp]},
            attrs={"axis": dim_start},
        )
        return tmp

    def append_activation(self, input_var: Variable):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act = copy.deepcopy(act)
        act_type = act.pop("type")
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        self.append_op(
            type=act_type, inputs={"X": [input_var]}, outputs={"Out": [tmp]}, attrs=act,
        )
        return tmp
