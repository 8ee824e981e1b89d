"""Recurrent programs built on Fluid control flow: the reference suite's
DynamicRNN LSTM classifier (benchmark/fluid/stacked_dynamic_lstm.py, as
``benchmarks/fluid_suite_bench.py:115-162`` builds it), the book's
machine-translation train and beam decode (reference
tests/book/test_machine_translation.py, as
``tests/test_machine_translation.py:49-200``) and its seq2seq model
(``tests/test_rnn_encoder_decoder.py:36-105``).

Every function here takes the ``layers`` module it appends to as its first
argument (``paddle_tpu_torch.fluid.layers``), so the same function
builds the same program with another Fluid package's layers.
Parameters are named so that the decode program reads the weights the
train program learns.
"""
from __future__ import annotations

import numpy as np

START_ID, END_ID = 0, 1  # dataset/wmt14.py


def dynamic_rnn_lstm(layers, words, label, vocab, emb_dim=512, hidden=512,
                     class_dim=2):
    """embedding -> fc tanh -> a DynamicRNN whose LSTM cell is four pairs
    of fc gates -> sequence_last_step -> fc softmax -> cross_entropy.
    Returns the mean cost."""
    sent = layers.embedding(words, size=[vocab, emb_dim])
    sent = layers.fc(input=sent, size=hidden, act="tanh", num_flatten_dims=2)
    rnn = layers.DynamicRNN()
    with rnn.block():
        word = rnn.step_input(sent)
        prev_h = rnn.memory(value=0.0, shape=[hidden])
        prev_c = rnn.memory(value=0.0, shape=[hidden])

        def gate(ipt, h):
            g0 = layers.fc(input=ipt, size=hidden, bias_attr=True)
            g1 = layers.fc(input=h, size=hidden, bias_attr=False)
            return layers.sums(input=[g0, g1])

        f = layers.sigmoid(gate(word, prev_h))
        i = layers.sigmoid(gate(word, prev_h))
        o = layers.sigmoid(gate(word, prev_h))
        c_t = layers.tanh(gate(word, prev_h))
        cell = layers.sums(input=[layers.elementwise_mul(x=f, y=prev_c),
                                  layers.elementwise_mul(x=i, y=c_t)])
        h_t = layers.elementwise_mul(x=o, y=layers.tanh(cell))
        rnn.update_memory(prev_c, cell)
        rnn.update_memory(prev_h, h_t)
        rnn.output(h_t)
    last = layers.sequence_last_step(rnn())
    logit = layers.fc(input=last, size=class_dim, act="softmax")
    return layers.mean(layers.cross_entropy(input=logit, label=label))


def _masked_mean_ce(layers, logits, label, batch):
    ce = layers.softmax_with_cross_entropy(logits=logits, label=label)
    ce = layers.reshape(ce, [batch, -1])  # [N, T]
    mask = layers.sequence_mask(layers.seq_lengths_of(label), maxlen_ref=ce,
                                dtype="float32")
    return layers.elementwise_div(
        layers.reduce_sum(layers.elementwise_mul(ce, mask)),
        layers.reduce_sum(mask))


def mt_encoder(layers, dict_size, word_dim, hidden):
    """src ids -> embedding 'vemb' -> fc 4H tanh -> dynamic_lstm ->
    sequence_last_step: the context [N, H]."""
    src = layers.data(name="src_word_id", shape=[1], dtype="int64",
                      lod_level=1)
    emb = layers.embedding(input=src, size=[dict_size, word_dim],
                           param_attr="vemb")
    fc1 = layers.fc(input=emb, size=hidden * 4, act="tanh", num_flatten_dims=2)
    lstm_h, _ = layers.dynamic_lstm(input=fc1, size=hidden * 4)
    return layers.sequence_last_step(lstm_h)


def mt_train(layers, dict_size, word_dim, hidden, batch):
    """The encoder, a DynamicRNN decoder fed the target (teacher
    forcing) from the context, and the masked mean cross-entropy of the
    next words. Returns the cost."""
    context = mt_encoder(layers, dict_size, word_dim, hidden)
    trg = layers.data(name="target_language_word", shape=[1], dtype="int64",
                      lod_level=1)
    trg_emb = layers.embedding(input=trg, size=[dict_size, word_dim],
                               param_attr="vemb")
    rnn = layers.DynamicRNN()
    with rnn.block():
        current_word = rnn.step_input(trg_emb)
        pre_state = rnn.memory(init=context)
        current_state = layers.fc(input=[current_word, pre_state], size=hidden,
                                  act="tanh")
        current_logits = layers.fc(input=current_state, size=dict_size)
        rnn.update_memory(pre_state, current_state)
        rnn.output(current_logits)
    label = layers.data(name="target_language_next_word", shape=[1],
                        dtype="int64", lod_level=1)
    return _masked_mean_ce(layers, rnn(), label, batch)


def mt_decode(layers, dict_size, word_dim, hidden, batch, beam, max_len,
              end_id=END_ID):
    """The beam decode: the encoder's context expanded over ``beam``
    lanes, then a While over tensor arrays of ids, scores, parents and
    states (``max_len`` + 1 slots) that embeds the last ids, steps the
    decoder cell, takes log-softmax scores, expands the beams
    (beam_search) and reorders the states to their parents
    (batch_gather); beam_search_decode backtracks. The cell's fc lists
    the word before the state, as the train program's does, so the
    decode reads the trained weights as trained. Feeds: ``init_ids``,
    ``init_scores`` [batch, beam]. Returns (sentence ids [B, beam,
    max_len + 1], sentence scores [B, beam], the (ids, scores, parents)
    arrays [max_len + 1, B, beam])."""
    context = mt_encoder(layers, dict_size, word_dim, hidden)
    ctx3 = layers.expand(layers.reshape(context, [batch, 1, hidden]),
                         [1, beam, 1])
    counter = layers.zeros(shape=[1], dtype="int64")
    array_len = layers.fill_constant(shape=[1], dtype="int64", value=max_len)
    ids_array = layers.create_array("int64", max_len + 1, [batch, beam])
    scores_array = layers.create_array("float32", max_len + 1, [batch, beam])
    parents_array = layers.create_array("int32", max_len + 1, [batch, beam])
    state_array = layers.create_array("float32", max_len + 1,
                                      [batch, beam, hidden])
    init_ids = layers.data(name="init_ids", shape=[batch, beam], dtype="int64",
                           append_batch_size=False)
    init_scores = layers.data(name="init_scores", shape=[batch, beam],
                              dtype="float32", append_batch_size=False)
    layers.array_write(init_ids, counter, ids_array)
    layers.array_write(init_scores, counter, scores_array)
    layers.array_write(ctx3, counter, state_array)

    cond = layers.less_than(counter, array_len)
    w = layers.While(cond)
    with w.block():
        pre_ids = layers.array_read(ids_array, counter)
        pre_scores = layers.array_read(scores_array, counter)
        pre_state = layers.array_read(state_array, counter)
        pre_ids_emb = layers.embedding(input=pre_ids,
                                       size=[dict_size, word_dim],
                                  param_attr="vemb")
        current_state = layers.fc(input=[pre_ids_emb, pre_state], size=hidden,
                                  act="tanh", num_flatten_dims=2)  # [B, K, H]
        logits = layers.fc(input=current_state, size=dict_size,
                           num_flatten_dims=2)  # [B, K, V]
        logp = layers.log(layers.softmax(logits))
        sel_ids, sel_scores, parent = layers.beam_search(
            pre_ids, pre_scores, logp, beam, end_id=end_id)
        new_state = layers.batch_gather(current_state, parent)
        layers.increment(counter, value=1)
        layers.array_write(sel_ids, counter, ids_array)
        layers.array_write(sel_scores, counter, scores_array)
        layers.array_write(parent, counter, parents_array)
        layers.array_write(new_state, counter, state_array)
        layers.less_than(counter, array_len, cond=cond)
    ids, scores = layers.beam_search_decode(ids_array, scores_array,
                                            parents_array, end_id=end_id)
    return ids, scores, (ids_array, scores_array, parents_array)


def decode_init(batch, beam):
    """The decode's first ids (START) and scores: lane 0 live, the others
    at -1e9 so the first expansion does not pick one word ``beam`` times
    (the reference gets this from the beams' LoD)."""
    scores = np.full((batch, beam), -1e9, np.float32)
    scores[:, 0] = 0.0
    return {"init_ids": np.full((batch, beam), START_ID, np.int64),
            "init_scores": scores}


def seq_to_seq_net(layers, dict_size, word_dim, hidden, batch):
    """The reference's seq2seq benchmark model: a bi-LSTM encoder
    (forward last step, backward first step), a DynamicRNN decoder with
    an LSTM cell of fc gates and two memories (hidden booted from the
    backward state, cell from zeros), the encoding as a static input, and
    the masked mean cross-entropy. Returns the cost."""
    src = layers.data(name="source_sequence", shape=[1], dtype="int64",
                      lod_level=1)
    src_emb = layers.embedding(input=src, size=[dict_size, word_dim])

    def lstm_proj(reverse):
        proj = layers.fc(input=src_emb, size=hidden * 4, num_flatten_dims=2)
        h, _ = layers.dynamic_lstm(input=proj, size=hidden * 4,
                                   is_reverse=reverse)
        return h

    fwd_last = layers.sequence_last_step(input=lstm_proj(False))
    bwd_first = layers.sequence_first_step(input=lstm_proj(True))
    encoded = layers.concat(input=[fwd_last, bwd_first], axis=1)
    decoder_boot = layers.fc(input=bwd_first, size=hidden, act="tanh")
    cell_init = layers.fill_constant_batch_size_like(
        input=decoder_boot, shape=[-1, hidden], dtype="float32", value=0.0)
    cell_init.stop_gradient = False

    trg = layers.data(name="target_sequence", shape=[1], dtype="int64",
                      lod_level=1)
    trg_emb = layers.embedding(input=trg, size=[dict_size, word_dim])
    rnn = layers.DynamicRNN()
    with rnn.block():
        current_word = rnn.step_input(trg_emb)
        context = rnn.static_input(encoded)
        hidden_mem = rnn.memory(init=decoder_boot)
        cell_mem = rnn.memory(init=cell_init)
        x_t = layers.concat(input=[context, current_word], axis=1)

        def linear():
            return layers.fc(input=[hidden_mem, x_t], size=hidden,
                             bias_attr=True)

        forget_gate = layers.sigmoid(x=linear())
        input_gate = layers.sigmoid(x=linear())
        output_gate = layers.sigmoid(x=linear())
        cell_tilde = layers.tanh(x=linear())
        cell_t = layers.sums(input=[
            layers.elementwise_mul(x=forget_gate, y=cell_mem),
            layers.elementwise_mul(x=input_gate, y=cell_tilde)])
        hidden_t = layers.elementwise_mul(x=output_gate,
                                          y=layers.tanh(x=cell_t))
        rnn.update_memory(hidden_mem, hidden_t)
        rnn.update_memory(cell_mem, cell_t)
        rnn.output(layers.fc(input=hidden_t, size=dict_size, bias_attr=True))
    label = layers.data(name="label_sequence", shape=[1], dtype="int64",
                        lod_level=1)
    return _masked_mean_ce(layers, rnn(), label, batch)
