"""Tensor layers (reference python/paddle/fluid/layers/tensor.py),
copied from ``paddle_tpu/fluid/layers/tensor.py``. ``save``, ``load``,
``save_combine`` and ``load_combine`` append the host io ops that the
executor runs in program order."""
from __future__ import annotations

import numpy as np

from ..framework import Variable
from ..layer_helper import LayerHelper

__all__ = [
    "create_tensor", "create_parameter", "create_global_var", "cast", "concat",
    "sums", "assign", "fill_constant", "fill_constant_batch_size_like",
    "ones", "zeros", "argmin", "argmax",
    "save", "save_combine", "load", "load_combine",
]


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.create_variable(
        name=helper.name if name else None, dtype=dtype, persistable=persistable
    )


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    from ..param_attr import ParamAttr

    helper = LayerHelper("create_parameter", name=name)
    attr = ParamAttr.to_attr(attr)
    if attr.name is None and name is not None:
        attr.name = name
    return helper.create_parameter(attr, shape, dtype, is_bias, default_initializer)


def create_global_var(shape, value, dtype, persistable=False, force_cpu=False,
                      name=None):
    """A global-block var set to ``value`` by the startup program."""
    from ..initializer import ConstantInitializer

    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(
        dtype=dtype, shape=shape, persistable=persistable, name=name
    )
    helper.set_variable_initializer(var, ConstantInitializer(value))
    return var


def cast(x, dtype):
    from ..core import convert_dtype

    helper = LayerHelper("cast")
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(
        type="cast", inputs={"X": [x]}, outputs={"Out": [out]},
        attrs={"in_dtype": x.dtype, "out_dtype": convert_dtype(dtype)},
    )
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", name=name)
    out = helper.create_variable_for_type_inference(dtype=input[0].dtype)
    helper.append_op(
        type="concat", inputs={"X": input}, outputs={"Out": [out]},
        attrs={"axis": axis},
    )
    return out


def sums(input, out=None):
    helper = LayerHelper("sum")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=input[0].dtype)
    helper.append_op(type="sum", inputs={"X": input}, outputs={"Out": [out]})
    # elementwise over the time axis: sequence lengths survive
    from .sequence import _propagate_lengths

    for x in input:
        _propagate_lengths(x, out)
    return out


def assign(input, output=None):
    helper = LayerHelper("assign")
    if output is None:
        output = helper.create_variable_for_type_inference(
            dtype=input.dtype if isinstance(input, Variable) else "float32"
        )
    if isinstance(input, Variable):
        helper.append_op(
            type="assign", inputs={"X": [input]}, outputs={"Out": [output]}
        )
    else:
        arr = np.asarray(input)
        helper.append_op(
            type="assign_value",
            outputs={"Out": [output]},
            attrs={
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "values": arr.ravel().tolist(),
            },
        )
    return output


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant")
    if out is None:
        out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(
        type="fill_constant",
        outputs={"Out": [out]},
        attrs={"shape": list(shape), "dtype": out.dtype, "value": float(value)},
    )
    out.stop_gradient = True
    return out


def fill_constant_batch_size_like(input, shape, dtype, value, input_dim_idx=0,
                                  output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype=dtype)
    helper.append_op(
        type="fill_constant_batch_size_like",
        inputs={"Input": [input]},
        outputs={"Out": [out]},
        attrs={
            "shape": list(shape), "dtype": out.dtype, "value": float(value),
            "input_dim_idx": input_dim_idx, "output_dim_idx": output_dim_idx,
        },
    )
    out.stop_gradient = True
    return out


def ones(shape, dtype, force_cpu=False):
    return fill_constant(shape=shape, dtype=dtype, value=1.0)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(shape=shape, dtype=dtype, value=0.0)


def argmin(x, axis=0):
    """int64 index of the smallest value along ``axis`` (op ``arg_min``)."""
    return _arg_min_max("arg_min", x, axis)


def argmax(x, axis=0):
    """int64 index of the largest value along ``axis`` (op ``arg_max``)."""
    return _arg_min_max("arg_max", x, axis)


def _arg_min_max(op_type, x, axis):
    helper = LayerHelper(op_type)
    out = helper.create_variable_for_type_inference(dtype="int64")
    helper.append_op(
        type=op_type, inputs={"X": [x]}, outputs={"Out": [out]},
        attrs={"axis": axis},
    )
    return out


def save(x, file_path, overwrite=True):
    """Emit an in-graph save op for one var (reference layers/tensor.py
    save -> save_op.cc; runs host-side at the program's edge)."""
    helper = LayerHelper("save")
    helper.main_program.current_block().append_op(
        "save", inputs={"X": [x]}, outputs={},
        attrs={"file_path": str(file_path), "overwrite": bool(overwrite)},
    )


def save_combine(x, file_path, overwrite=True):
    """Save several vars into one file (reference save_combine_op.cc)."""
    helper = LayerHelper("save_combine")
    helper.main_program.current_block().append_op(
        "save_combine", inputs={"X": list(x)}, outputs={},
        attrs={"file_path": str(file_path), "overwrite": bool(overwrite)},
    )


def load(out, file_path):
    """Emit an in-graph load op into `out` (reference load_op.cc)."""
    helper = LayerHelper("load")
    helper.main_program.current_block().append_op(
        "load", inputs={}, outputs={"Out": [out]},
        attrs={"file_path": str(file_path)},
    )


def load_combine(out, file_path):
    """Load several vars from one file (reference load_combine_op.cc)."""
    helper = LayerHelper("load_combine")
    helper.main_program.current_block().append_op(
        "load_combine", inputs={}, outputs={"Out": list(out)},
        attrs={"file_path": str(file_path)},
    )
