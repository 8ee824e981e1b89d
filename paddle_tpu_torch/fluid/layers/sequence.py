"""Sequence layer functions — the reference's LoD-consuming layers
(dynamic_lstm nn.py:277, sequence_pool, sequence_first_step/last_step) on
the padded+lengths representation, copied from
``paddle_tpu/fluid/layers/sequence.py`` (the other sequence layers are not
ported yet).

Convention: a data var with lod_level > 0 is a padded dense tensor [N, T, ...]
with a companion int32 lengths var named `<name>@LEN` (created by layers.data,
fed by DataFeeder). Layers propagate the companion through sequence-preserving
ops via `Variable._seq_lengths`.
"""
from __future__ import annotations

from ..framework import Variable
from ..layer_helper import LayerHelper

__all__ = [
    "dynamic_lstm", "sequence_pool", "sequence_first_step",
    "sequence_last_step", "seq_lengths_of",
]

LEN_SUFFIX = "@LEN"


def seq_lengths_of(var: Variable):
    """Resolve the lengths companion of a sequence var (or None)."""
    direct = getattr(var, "_seq_lengths", None)
    if direct is not None:
        return direct
    return var.block._var_recursive(var.name + LEN_SUFFIX)


def _propagate_lengths(src: Variable, dst: Variable):
    lens = seq_lengths_of(src)
    if lens is not None:
        dst._seq_lengths = lens
    return dst


def dynamic_lstm(input, size, use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", param_attr=None, bias_attr=None,
                 dtype="float32", name=None):
    """reference layers/nn.py:277 — input is the x-projection [N, T, 4H];
    ``size`` is 4H, so the LSTM's hidden width is ``size // 4``."""
    helper = LayerHelper("lstm", param_attr=param_attr, bias_attr=bias_attr,
                         name=name)
    size = size // 4
    weight = helper.create_parameter(helper.param_attr, shape=[size, 4 * size],
                                     dtype=dtype)
    bias_size = 7 * size if use_peepholes else 4 * size
    bias = helper.create_parameter(helper.bias_attr, shape=[bias_size],
                                   dtype=dtype, is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    batch_gate = helper.create_variable_for_type_inference(dtype)
    batch_cell_pre = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    lens = seq_lengths_of(input)
    if lens is not None:
        inputs["Lengths"] = [lens]
    helper.append_op(
        type="lstm",
        inputs=inputs,
        outputs={"Hidden": [hidden], "Cell": [cell],
                 "BatchGate": [batch_gate],
                 "BatchCellPreAct": [batch_cell_pre]},
        attrs={
            "use_peepholes": use_peepholes, "is_reverse": is_reverse,
            "gate_activation": gate_activation,
            "cell_activation": cell_activation,
            "candidate_activation": candidate_activation,
        },
    )
    _propagate_lengths(input, hidden)
    _propagate_lengths(input, cell)
    return hidden, cell


def _seq_pool(input, pool_type):
    helper = LayerHelper("sequence_pool")
    out = helper.create_variable_for_type_inference(input.dtype)
    max_index = helper.create_variable_for_type_inference("int32")
    inputs = {"X": [input]}
    lens = seq_lengths_of(input)
    if lens is not None:
        inputs["Lengths"] = [lens]
    helper.append_op(
        type="sequence_pool",
        inputs=inputs,
        outputs={"Out": [out], "MaxIndex": [max_index]},
        attrs={"pooltype": pool_type.upper()},
    )
    return out


def sequence_pool(input, pool_type):
    return _seq_pool(input, pool_type)


def sequence_first_step(input):
    return _seq_pool(input, "first")


def sequence_last_step(input):
    return _seq_pool(input, "last")
