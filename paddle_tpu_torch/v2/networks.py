"""v2 network compositions (reference python/paddle/v2/networks.py →
trainer_config_helpers/networks.py): the multi-layer building blocks the
legacy DSL shipped — conv groups, bidirectional RNNs, text conv-pool,
whole-model VGG, and the seq2seq attention step — composed from the v2
layer functions / fluid layers."""
from __future__ import annotations

from ..fluid import layers as _fl
from ..fluid import nets as _nets
from . import layer as _v2


def simple_img_conv_pool(input, filter_size, num_filters, pool_size,
                         pool_stride, act=None, **kwargs):
    """reference networks.simple_img_conv_pool."""
    return _nets.simple_img_conv_pool(
        input=input, filter_size=filter_size, num_filters=num_filters,
        pool_size=pool_size, pool_stride=pool_stride,
        act=_v2._act_name(act),
    )


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None,
                   conv_with_batchnorm=False, pool_stride=1,
                   pool_type="max", **kwargs):
    """reference networks.img_conv_group: N convs (+optional BN) then one
    pool — the VGG building block."""
    return _nets.img_conv_group(
        input=input, conv_num_filter=conv_num_filter, pool_size=pool_size,
        conv_padding=conv_padding, conv_filter_size=conv_filter_size,
        conv_act=_v2._act_name(conv_act),
        conv_with_batchnorm=conv_with_batchnorm,
        pool_stride=pool_stride, pool_type=pool_type,
    )


def sequence_conv_pool(input, context_len, hidden_size, pool_type="max",
                       **kwargs):
    """reference networks.sequence_conv_pool / text_conv_pool."""
    return _nets.sequence_conv_pool(
        input=input, num_filters=hidden_size, filter_size=context_len,
        pool_type=pool_type,
    )


text_conv_pool = sequence_conv_pool


def lstmemory_group(input, size=None, reverse=False, param_attr=None,
                    lstm_bias_attr=None, input_proj_bias_attr=None,
                    act=None, **kwargs):
    """reference networks.lstmemory_group: the step-level LSTM — input
    already carries the 4*size projected gates (like lstmemory), but the
    recurrence is an explicit recurrent_group so other step-local layers
    can attach. param_attr names the recurrent weight; a shared name
    shares it across groups (tests/configs/shared_lstm.py)."""
    width = int(input.shape[-1])
    size = size or width // 4
    if width != size * 4:
        raise ValueError(
            f"lstmemory_group(size={size}) needs an input of width "
            f"{size * 4} (4*size projected gates), got {width}")

    def step(x_t):
        h_prev = _v2.memory(size=size)
        c_prev = _v2.memory(size=size)
        rec = _fl.fc(input=h_prev, size=size * 4, act=None,
                     param_attr=param_attr, bias_attr=lstm_bias_attr)
        gates = _fl.elementwise_add(x_t, rec)
        h, c = _v2.lstm_step_layer(gates, c_prev, size=size)
        return h, c

    outs = _v2.recurrent_group(step=step, input=input, reverse=reverse)
    return outs[0] if isinstance(outs, (list, tuple)) else outs


def gru_group(input, size=None, reverse=False, param_attr=None,
              gru_bias_attr=None, act=None, **kwargs):
    """reference networks.gru_group: step-level GRU over 3*size projected
    gates (the recurrent_group form of grumemory)."""
    width = int(input.shape[-1])
    size = size or width // 3
    if width != size * 3:
        raise ValueError(
            f"gru_group(size={size}) needs an input of width {size * 3} "
            f"(3*size projected gates), got {width}")

    def step(x_t):
        h_prev = _v2.memory(size=size)
        return _v2.gru_step_layer(x_t, h_prev, size=size)

    return _v2.recurrent_group(step=step, input=input, reverse=reverse)


def simple_lstm(input, size, reverse=False, **kwargs):
    """reference networks.simple_lstm: fc gate projection + lstmemory."""
    return _v2.simple_lstm(input, size, reverse=reverse)


def simple_gru(input, size, reverse=False, **kwargs):
    return _v2.simple_gru(input, size, reverse=reverse)


def bidirectional_lstm(input, size, return_seq=False, **kwargs):
    """reference networks.bidirectional_lstm: forward + backward lstm,
    concat (last states when return_seq=False, per-step otherwise)."""
    fwd = _v2.simple_lstm(input, size)
    bwd = _v2.simple_lstm(input, size, reverse=True)
    if return_seq:
        from ..fluid.layers import tensor as _t

        return _t.concat([fwd, bwd], axis=-1)
    from ..fluid.layers import tensor as _t

    # the reversed RNN's whole-sequence summary sits at the FIRST timestep
    # (the fused ops flip outputs back to original time order) — reference
    # networks.bidirectional_lstm: last_seq(fwd) + first_seq(bwd)
    return _t.concat(
        [_fl.sequence_last_step(fwd), _fl.sequence_first_step(bwd)], axis=-1)


def bidirectional_gru(input, size, return_seq=False, **kwargs):
    fwd = _v2.simple_gru(input, size)
    bwd = _v2.simple_gru(input, size, reverse=True)
    from ..fluid.layers import tensor as _t

    if return_seq:
        return _t.concat([fwd, bwd], axis=-1)
    return _t.concat(
        [_fl.sequence_last_step(fwd), _fl.sequence_first_step(bwd)], axis=-1)


def simple_attention(encoded_sequence, encoded_proj, decoder_state,
                     **kwargs):
    """reference networks.simple_attention (Bahdanau): score each encoder
    step against the decoder state, softmax over time, weighted sum."""
    size = int(encoded_proj.shape[-1])
    dec = _fl.fc(input=decoder_state, size=size, act=None)
    dec_expanded = _fl.sequence_expand(dec, encoded_proj)
    mix = _fl.tanh(_fl.elementwise_add(encoded_proj, dec_expanded))
    scores = _fl.fc(input=mix, size=1, num_flatten_dims=2, act=None)
    weights = _fl.sequence_softmax(scores)
    scaled = _fl.elementwise_mul(encoded_sequence, weights)
    return _fl.sequence_pool(scaled, "sum")


def vgg_16_network(input_image, num_channels, num_classes=1000, **kwargs):
    """reference networks.vgg_16_network: the canonical 5-group VGG-16."""
    del num_channels  # carried by the input's shape
    tmp = input_image
    for filters, n_convs in ((64, 2), (128, 2), (256, 3), (512, 3),
                             (512, 3)):
        tmp = img_conv_group(
            tmp, conv_num_filter=[filters] * n_convs, pool_size=2,
            conv_filter_size=3, conv_act="relu", pool_stride=2,
        )
    tmp = _fl.fc(input=tmp, size=4096, act="relu")
    tmp = _fl.dropout(tmp, dropout_prob=0.5)
    tmp = _fl.fc(input=tmp, size=4096, act="relu")
    tmp = _fl.dropout(tmp, dropout_prob=0.5)
    return _fl.fc(input=tmp, size=num_classes, act="softmax")
