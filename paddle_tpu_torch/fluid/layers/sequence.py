"""Sequence layer functions — the reference's LoD-consuming layers
(dynamic_lstm nn.py:277, sequence_pool, sequence_first_step/last_step,
sequence_mask, beam_search, beam_search_decode) and batch_gather on the
padded+lengths representation, copied from
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
    "sequence_last_step", "seq_lengths_of", "sequence_mask", "batch_gather",
    "beam_search", "beam_search_decode",
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


def sequence_mask(x, maxlen=None, maxlen_ref=None, dtype="int64"):
    """mask[i, t] = t < x[i] (reference-era sequence padding mask). Provide
    `maxlen` (static) or `maxlen_ref` (a padded [N, T, ...] var whose
    time extent supplies it at run time)."""
    helper = LayerHelper("sequence_mask")
    out = helper.create_variable_for_type_inference(dtype)
    inputs = {"X": [x]}
    if maxlen_ref is not None:
        inputs["MaxLenRef"] = [maxlen_ref]
    helper.append_op(
        type="sequence_mask", inputs=inputs, outputs={"Y": [out]},
        attrs={"maxlen": -1 if maxlen is None else int(maxlen),
               "out_dtype": dtype},
    )
    return out


def batch_gather(x, index):
    """x [B, K, ...], index [B, K'] -> [B, K', ...]: per-batch gather on
    axis 1 (beam-search parent selection)."""
    helper = LayerHelper("batch_gather")
    out = helper.create_variable_for_type_inference(x.dtype)
    if x.shape is not None and index.shape is not None:
        out.desc.shape = list(index.shape[:2]) + list(x.shape[2:])
    helper.append_op(
        type="batch_gather", inputs={"X": [x], "Index": [index]},
        outputs={"Out": [out]},
    )
    return out


def beam_search(pre_ids, pre_scores, scores, beam_size, end_id, ids=None,
                level=0):
    """One beam expansion step over fixed [B, beam] state (reference
    beam_search_op.cc keeps beams as LoD levels and shrinks finished ones;
    here finished beams are frozen — see ops/beam_search_ops.py). `scores`
    are this step's log-probs [B, beam, V]."""
    helper = LayerHelper("beam_search")
    sel_ids = helper.create_variable_for_type_inference("int64")
    sel_scores = helper.create_variable_for_type_inference(scores.dtype)
    parent = helper.create_variable_for_type_inference("int32")
    inputs = {"PreIds": [pre_ids], "PreScores": [pre_scores],
              "Scores": [scores]}
    if ids is not None:
        inputs["Ids"] = [ids]
    helper.append_op(
        type="beam_search", inputs=inputs,
        outputs={"SelectedIds": [sel_ids], "SelectedScores": [sel_scores],
                 "ParentIdx": [parent]},
        attrs={"beam_size": int(beam_size), "end_id": int(end_id),
               "level": int(level)},
    )
    return sel_ids, sel_scores, parent


def beam_search_decode(ids, scores, parents, beam_size=None, end_id=0):
    """Backtrack stacked per-step beam selections ([T, B, beam] each) into
    sentences [B, beam, T] + final scores [B, beam] (reference
    beam_search_decode_op.cc)."""
    helper = LayerHelper("beam_search_decode")
    sent_ids = helper.create_variable_for_type_inference("int64")
    sent_scores = helper.create_variable_for_type_inference(scores.dtype)
    helper.append_op(
        type="beam_search_decode",
        inputs={"Ids": [ids], "Scores": [scores], "Parents": [parents]},
        outputs={"SentenceIds": [sent_ids], "SentenceScores": [sent_scores]},
        attrs={"end_id": int(end_id)},
    )
    return sent_ids, sent_scores
