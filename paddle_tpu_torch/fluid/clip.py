"""Gradient clipping (reference python/paddle/fluid/clip.py:
GradientClipByValue:101, ByNorm:122, ByGlobalNorm:137, set_gradient_clip:184,
append_gradient_clip_ops:215) and error clip — a copy of
``paddle_tpu/fluid/clip.py``. The clip attrs append ``clip``,
``clip_by_norm`` or (global norm) one ``squared_l2_norm`` per gradient,
one ``sum`` and ``sqrt`` per group, and one ``elementwise_mul`` per
gradient; ``error_clip_callback`` is a hook point that does nothing, as
in the JAX package.
"""
from __future__ import annotations

from .framework import default_main_program


class BaseErrorClipAttr:
    def append_clip_op(self, block, grad_name):
        raise NotImplementedError


class ErrorClipByValue(BaseErrorClipAttr):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def append_clip_op(self, block, grad_name):
        block.append_op(
            type="clip", inputs={"X": [grad_name]}, outputs={"Out": [grad_name]},
            attrs={"min": self.min, "max": self.max},
        )


def error_clip_callback(block, context):
    pass  # hook point kept for API parity


class BaseGradientClipAttr:
    def process_context(self, context, param, grad):
        pass

    def create_operators(self, param, grad):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def create_operators(self, param, grad):
        return param, grad


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def create_operators(self, param, grad):
        from .layers.nn import clip as clip_layer

        return param, clip_layer(grad, min=self.min, max=self.max)


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def create_operators(self, param, grad):
        from .layers.nn import clip_by_norm

        return param, clip_by_norm(grad, max_norm=self.clip_norm)


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def process_context(self, context, param, grad):
        if self.group_name not in context:
            context[self.group_name] = []
            context[self.group_name + "_clip_value"] = self.clip_norm
        from .layer_helper import LayerHelper

        helper = LayerHelper("global_norm")
        sq = helper.create_variable_for_type_inference(grad.dtype)
        helper.append_op(
            type="squared_l2_norm", inputs={"X": [grad]}, outputs={"Out": [sq]}
        )
        context[self.group_name].append(sq)
        self.context = context

    def create_operators(self, param, grad):
        from .layers import nn, ops, tensor

        group_scale_name = self.group_name + "_scale"
        if group_scale_name not in self.context:
            group_norm = tensor.sums(self.context[self.group_name])
            group_norm = ops.sqrt(group_norm)
            clip_var = tensor.fill_constant(
                shape=[1], dtype=group_norm.dtype, value=self.clip_norm
            )
            scale = nn.elementwise_div(
                x=clip_var, y=nn.elementwise_max(x=clip_var, y=group_norm)
            )
            self.context[group_scale_name] = scale
        new_grad = nn.elementwise_mul(x=grad, y=self.context[group_scale_name])
        return param, new_grad


def set_gradient_clip(clip, param_list=None, program=None):
    program = program or default_main_program()
    if param_list is None:
        param_list = program.global_block().all_parameters()
    param_list = [
        program.global_block().var(p) if isinstance(p, str) else p
        for p in param_list
    ]
    for param in param_list:
        param.gradient_clip_attr = clip


def append_gradient_clip_ops(param_grad):
    context = {}
    clipped = []
    any_clip = False
    for p, g in param_grad:
        clip_attr = getattr(p, "gradient_clip_attr", None)
        if clip_attr is None:
            continue
        any_clip = True
        clip_attr.process_context(context=context, param=p, grad=g)
    if not any_clip:
        return param_grad
    for p, g in param_grad:
        clip_attr = getattr(p, "gradient_clip_attr", None) or NullGradientClipAttr()
        clipped.append(clip_attr.create_operators(param=p, grad=g))
    return clipped
