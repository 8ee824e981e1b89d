"""Stacked LSTM text classifier (reference benchmark/fluid/
stacked_dynamic_lstm.py: embedding -> N x [fc -> dynamic_lstm] -> pools ->
fc softmax), copied from ``paddle_tpu/models/stacked_lstm.py``."""
from __future__ import annotations

from ..fluid import layers


def build(data, label, dict_dim, emb_dim=512, hid_dim=512, stacked_num=3,
          class_dim=2):
    """data: int64 ids [N, T] (lod_level=1 padded+lengths), label: [N, 1].
    Returns (avg_cost, accuracy, prediction)."""
    emb = layers.embedding(input=data, size=[dict_dim, emb_dim])

    fc1 = layers.fc(input=emb, size=hid_dim, num_flatten_dims=2)
    lstm1, cell1 = layers.dynamic_lstm(input=fc1, size=hid_dim,
                                       use_peepholes=False)

    inputs = [fc1, lstm1]
    for _ in range(2, stacked_num + 1):
        fc = layers.fc(input=inputs, size=hid_dim, num_flatten_dims=2)
        lstm, cell = layers.dynamic_lstm(
            input=fc, size=hid_dim, is_reverse=False, use_peepholes=False
        )
        inputs = [fc, lstm]

    fc_last = layers.sequence_pool(input=inputs[0], pool_type="max")
    lstm_last = layers.sequence_pool(input=inputs[1], pool_type="max")

    logits = layers.fc(input=[fc_last, lstm_last], size=class_dim)
    cost = layers.softmax_with_cross_entropy(logits=logits, label=label)
    avg_cost = layers.mean(cost)
    prediction = layers.softmax(logits)
    acc = layers.accuracy(input=prediction, label=label)
    return avg_cost, acc, prediction
