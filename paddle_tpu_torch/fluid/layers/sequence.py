"""Sequence layer functions — the reference's LoD-consuming layers
(dynamic_lstm nn.py:277, dynamic_gru nn.py:609, dynamic_lstmp nn.py:423,
sequence_pool, sequence_conv, sequence_expand, sequence_first_step/
last_step, the CRF and CTC layers) on the padded+lengths representation,
copied from ``paddle_tpu/fluid/layers/sequence.py``.

Convention: a data var with lod_level > 0 is a padded dense tensor [N, T, ...]
with a companion int32 lengths var named `<name>@LEN` (created by layers.data,
fed by DataFeeder). Layers propagate the companion through sequence-preserving
ops via `Variable._seq_lengths`.
"""
from __future__ import annotations

from ..framework import Variable
from ..layer_helper import LayerHelper

__all__ = [
    "dynamic_lstm", "dynamic_gru", "sequence_pool", "sequence_conv",
    "sequence_expand", "sequence_first_step", "sequence_last_step",
    "sequence_softmax", "sequence_reshape", "sequence_concat", "seq_lengths_of",
    "linear_chain_crf", "crf_decoding", "lod_reset",
    "dynamic_lstmp", "ctc_greedy_decoder",
    "gru_unit", "sequence_mask", "batch_gather", "beam_search",
    "beam_search_decode",
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
    """reference layers/nn.py:277 — input is the x-projection [N, T, 4H]."""
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


def dynamic_gru(input, size, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", h_0=None, dtype="float32"):
    """reference layers/nn.py:609 — input is the x-projection [N, T, 3H]."""
    helper = LayerHelper("gru", param_attr=param_attr, bias_attr=bias_attr)
    weight = helper.create_parameter(helper.param_attr, shape=[size, 3 * size],
                                     dtype=dtype)
    bias = helper.create_parameter(helper.bias_attr, shape=[3 * size],
                                   dtype=dtype, is_bias=True)
    hidden = helper.create_variable_for_type_inference(dtype)
    bg = helper.create_variable_for_type_inference(dtype)
    brh = helper.create_variable_for_type_inference(dtype)
    bh = helper.create_variable_for_type_inference(dtype)
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    lens = seq_lengths_of(input)
    if lens is not None:
        inputs["Lengths"] = [lens]
    helper.append_op(
        type="gru",
        inputs=inputs,
        outputs={"Hidden": [hidden], "BatchGate": [bg],
                 "BatchResetHiddenPrev": [brh], "BatchHidden": [bh]},
        attrs={
            "is_reverse": is_reverse, "gate_activation": gate_activation,
            "activation": candidate_activation,
        },
    )
    _propagate_lengths(input, hidden)
    return hidden


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


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None):
    """reference layers/nn.py sequence_conv."""
    helper = LayerHelper("sequence_conv", param_attr=param_attr,
                         bias_attr=bias_attr, act=act)
    dtype = input.dtype
    filter_shape = [filter_size * input.shape[-1], num_filters]
    filter_param = helper.create_parameter(helper.param_attr,
                                           shape=filter_shape, dtype=dtype)
    pre_bias = helper.create_variable_for_type_inference(dtype)
    inputs = {"X": [input], "Filter": [filter_param]}
    lens = seq_lengths_of(input)
    if lens is not None:
        inputs["Lengths"] = [lens]
    helper.append_op(
        type="sequence_conv",
        inputs=inputs,
        outputs={"Out": [pre_bias]},
        attrs={
            "contextStride": filter_stride,
            "contextStart": -int(filter_size // 2),
            "contextLength": filter_size,
        },
    )
    pre_act = helper.append_bias_op(pre_bias, dim_start=2)
    out = helper.append_activation(pre_act)
    _propagate_lengths(input, out)
    return out


def sequence_expand(x, y, ref_level=-1):
    helper = LayerHelper("sequence_expand")
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(
        type="sequence_expand", inputs={"X": [x], "Y": [y]},
        outputs={"Out": [out]}, attrs={"ref_level": ref_level},
    )
    _propagate_lengths(y, out)
    return out


def sequence_softmax(input, use_cudnn=True):
    helper = LayerHelper("sequence_softmax")
    out = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"X": [input]}
    lens = seq_lengths_of(input)
    if lens is not None:
        inputs["Lengths"] = [lens]
    helper.append_op(
        type="sequence_softmax", inputs=inputs, outputs={"Out": [out]},
    )
    _propagate_lengths(input, out)
    return out


def sequence_reshape(input, new_dim):
    helper = LayerHelper("sequence_reshape")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(
        type="sequence_reshape", inputs={"X": [input]},
        outputs={"Out": [out]}, attrs={"new_dim": new_dim},
    )
    return out


def sequence_reverse(x, name=None):
    """Reverse each sequence's valid prefix (reference
    paddle/fluid/operators/sequence_reverse_op.h); padding stays put, so
    the output shares x's lengths companion."""
    helper = LayerHelper("sequence_reverse", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    inputs = {"X": [x]}
    lens = seq_lengths_of(x)
    if lens is not None:
        inputs["Lengths"] = [lens]
    helper.append_op(type="sequence_reverse", inputs=inputs,
                     outputs={"Out": [out]})
    _propagate_lengths(x, out)
    return out


def sequence_concat(input, name=None):
    helper = LayerHelper("sequence_concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    lens = [seq_lengths_of(v) for v in input]
    inputs = {"X": input}
    if any(l is not None for l in lens):
        if any(l is None for l in lens):
            raise ValueError(
                "sequence_concat: either all inputs carry lengths or none"
            )
        inputs["Lengths"] = lens
        # result lengths = elementwise sum of input lengths
        total = helper.create_variable_for_type_inference("int32")
        helper.append_op(type="sum", inputs={"X": lens},
                         outputs={"Out": [total]})
        out._seq_lengths = total
    helper.append_op(
        type="sequence_concat", inputs=inputs, outputs={"Out": [out]},
    )
    return out


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid", dtype="float32"):
    """One GRU cell step (reference gru_unit_op.cc): input [N, 3H] (the
    x-projection), hidden [N, H] -> new hidden [N, H]. Returns
    (hidden, reset_hidden_prev, gate)."""
    acts = {"identity": 0, "sigmoid": 1, "tanh": 2, "relu": 3}
    helper = LayerHelper("gru_unit", param_attr=param_attr,
                         bias_attr=bias_attr)
    H = size // 3
    weight = helper.create_parameter(helper.param_attr, shape=[H, 3 * H],
                                     dtype=dtype)
    bias = helper.create_parameter(helper.bias_attr, shape=[1, 3 * H],
                                   dtype=dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(dtype)
    gate = helper.create_variable_for_type_inference(dtype)
    reset = helper.create_variable_for_type_inference(dtype)
    if hidden.shape is not None:
        out.desc.shape = list(hidden.shape)
    helper.append_op(
        type="gru_unit",
        inputs={"Input": [input], "HiddenPrev": [hidden], "Weight": [weight],
                "Bias": [bias]},
        outputs={"Hidden": [out], "Gate": [gate], "ResetHiddenPrev": [reset]},
        attrs={"activation": acts[activation],
               "gate_activation": acts[gate_activation]},
    )
    return out, reset, gate


def sequence_mask(x, maxlen=None, maxlen_ref=None, dtype="int64"):
    """mask[i, t] = t < x[i] (reference-era sequence padding mask). Provide
    `maxlen` (static) or `maxlen_ref` (a padded [N, T, ...] var whose traced
    time extent supplies it)."""
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


def linear_chain_crf(input, label, param_attr=None):
    """Linear-chain CRF NLL (reference layers/nn.py linear_chain_crf, op
    linear_chain_crf_op.cc). `input` is the padded emission [N, T, D] with
    lengths companion; `label` [N, T] (+lengths). The transition parameter
    is [D+2, D]: rows 0/1 are start/end weights, rows 2: the tag-to-tag
    matrix. Returns per-sequence NLL [N, 1]."""
    helper = LayerHelper("linear_chain_crf", param_attr=param_attr)
    size = input.shape[-1]
    transition = helper.create_parameter(
        helper.param_attr, [size + 2, size], input.dtype)
    ll = helper.create_variable_for_type_inference(input.dtype)
    alpha = helper.create_variable_for_type_inference(input.dtype)
    e_exps = helper.create_variable_for_type_inference(input.dtype)
    t_exps = helper.create_variable_for_type_inference(input.dtype)
    inputs = {"Emission": [input], "Transition": [transition],
              "Label": [label]}
    lengths = seq_lengths_of(input) or seq_lengths_of(label)
    if lengths is not None:
        inputs["Lengths"] = [lengths]
    helper.append_op(
        type="linear_chain_crf", inputs=inputs,
        outputs={"LogLikelihood": [ll], "Alpha": [alpha],
                 "EmissionExps": [e_exps], "TransitionExps": [t_exps]},
    )
    return ll


def crf_decoding(input, param_attr, label=None):
    """Viterbi decode against the CRF transition parameter created by
    linear_chain_crf (reference layers/nn.py crf_decoding). With `label`,
    returns per-position agreement 0/1 instead of the path (reference
    crf_decoding_op.cc semantics)."""
    helper = LayerHelper("crf_decoding", param_attr=param_attr)
    # the transition parameter already exists (created by linear_chain_crf
    # under the shared ParamAttr name, e.g. 'crfw') — look it up, don't re-init
    transition = helper.main_program.global_block().var(helper.param_attr.name)
    path = helper.create_variable_for_type_inference("int64")
    inputs = {"Emission": [input], "Transition": [transition]}
    if label is not None:
        inputs["Label"] = [label]
    lengths = seq_lengths_of(input) or (
        seq_lengths_of(label) if label is not None else None)
    if lengths is not None:
        inputs["Lengths"] = [lengths]
    helper.append_op(
        type="crf_decoding", inputs=inputs,
        outputs={"ViterbiPath": [path]},
    )
    _propagate_lengths(input, path)
    return path


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


def lod_reset(x, y=None, target_lod=None):
    """Repartition x's token stream under new sequence boundaries
    (reference layers lod_reset -> lod_reset_op.cc): boundaries come from
    `y`'s lengths or the static offset vector `target_lod`. Returns the
    re-padded tensor; its lengths companion is `<out>@LEN`."""
    if y is None and target_lod is None:
        raise ValueError("lod_reset requires y or target_lod")
    helper = LayerHelper("lod_reset")
    out = helper.create_variable_for_type_inference(x.dtype)
    out_lens = helper.main_program.current_block().create_var(
        name=out.name + LEN_SUFFIX, shape=[-1], dtype="int32",
        stop_gradient=True, persistable=False,
    )
    inputs = {"X": [x]}
    x_lens = seq_lengths_of(x)
    if x_lens is not None:
        inputs["XLengths"] = [x_lens]
    attrs = {}
    if y is not None:
        inputs["Y"] = [y]
        y_lens = seq_lengths_of(y)
        if y_lens is None:
            raise ValueError(f"'{y.name}' has no lengths companion")
        inputs["YLengths"] = [y_lens]
    else:
        attrs["target_lod"] = [int(v) for v in target_lod]
    helper.append_op(
        type="lod_reset", inputs=inputs,
        outputs={"Out": [out], "OutLengths": [out_lens]}, attrs=attrs,
    )
    out._seq_lengths = out_lens
    return out


def dynamic_lstmp(input, size, proj_size, use_peepholes=True,
                  is_reverse=False, gate_activation="sigmoid",
                  cell_activation="tanh", candidate_activation="tanh",
                  proj_activation="tanh", param_attr=None, bias_attr=None,
                  dtype="float32", name=None):
    """LSTM with recurrent projection (reference layers/nn.py:423
    dynamic_lstmp -> lstmp_op): input carries the x-projection
    [N, T, 4*size]; the recurrent state fed back is proj(h_t) of width
    proj_size. Returns (projection, cell)."""
    helper = LayerHelper("lstmp", param_attr=param_attr,
                         bias_attr=bias_attr, name=name)
    size = size // 4
    weight = helper.create_parameter(
        helper.param_attr, shape=[proj_size, 4 * size], dtype=dtype)
    proj_weight = helper.create_parameter(
        helper.param_attr, shape=[size, proj_size], dtype=dtype)
    inputs_bias = {}
    if helper.bias_attr is not False:  # bias_attr=False opts out
        bias_size = 7 * size if use_peepholes else 4 * size
        inputs_bias["Bias"] = [helper.create_parameter(
            helper.bias_attr, shape=[1, bias_size], dtype=dtype,
            is_bias=True)]
    projection = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    extras = [helper.create_variable_for_type_inference(dtype)
              for _ in range(5)]
    inputs = {"Input": [input], "Weight": [weight],
              "ProjWeight": [proj_weight], **inputs_bias}
    lens = seq_lengths_of(input)
    if lens is not None:
        inputs["Lengths"] = [lens]
    helper.append_op(
        type="lstmp", inputs=inputs,
        outputs={"Projection": [projection], "Cell": [cell],
                 "BatchedProjection": [extras[0]],
                 "BatchedCell": [extras[1]], "BatchedInput": [extras[2]],
                 "BatchedHidden": [extras[3]], "OrderedP0": [extras[4]]},
        attrs={
            "use_peepholes": use_peepholes, "is_reverse": is_reverse,
            "gate_activation": gate_activation,
            "cell_activation": cell_activation,
            "candidate_activation": candidate_activation,
            "proj_activation": proj_activation,
        },
    )
    _propagate_lengths(input, projection)
    _propagate_lengths(input, cell)
    return projection, cell


def ctc_greedy_decoder(input, blank, name=None):
    """Greedy CTC decoding (reference layers/nn.py ctc_greedy_decoder ->
    ctc_align): argmax per step, merge repeats, drop blanks. Returns the
    left-packed token tensor ([N, T], -1 padded — the dense equivalent of
    the reference's variable-length LoD output)."""
    from .tensor import argmax

    helper = LayerHelper("ctc_greedy_decoder", name=name)
    ids = argmax(input, axis=-1)
    out = helper.create_variable_for_type_inference("int64")
    out_len = helper.create_variable_for_type_inference("int32")
    inputs = {"Input": [ids]}
    lens = seq_lengths_of(input)
    if lens is not None:
        inputs["InputLength"] = [lens]
    helper.append_op(
        type="ctc_align", inputs=inputs,
        outputs={"Output": [out], "OutputLength": [out_len]},
        attrs={"blank": int(blank), "merge_repeated": True},
    )
    # ctc_align emits [N, 1] (reference padding-mode shape); the repo's
    # lengths convention is flat [N] — reshape before attaching
    flat_len = helper.create_variable_for_type_inference("int32")
    helper.append_op(
        type="reshape", inputs={"X": [out_len]},
        outputs={"Out": [flat_len]}, attrs={"shape": [-1]},
    )
    out._seq_lengths = flat_len
    return out
