"""Real book-example Program builders for the port's analysis passes —
the JAX package's ``analysis/examples.py`` built with
``paddle_tpu_torch.fluid``.

These are the same model graphs the book tests train (fit_a_line,
recognize_digits LeNet, word2vec, understand_sentiment), built WITHOUT
datasets or training — the verifier needs the IR, not the data. The CLI
and the tests run `verify_program` over every one of them, so a
verifier regression (or a layer/backward change that emits a malformed
graph) fails the moment it lands.

Each builder returns (main, startup); `build_all()` returns a dict of
name -> (main, startup)."""
from __future__ import annotations

from typing import Callable, Dict, Tuple


def _programs():
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import unique_name
    from paddle_tpu_torch.fluid.framework import Program, program_guard

    main, startup = Program(), Program()
    main.random_seed = startup.random_seed = 7
    return fluid, unique_name, main, startup, program_guard


def build_fit_a_line():
    """reference tests/book/test_fit_a_line.py — linear regression."""
    fluid, unique_name, main, startup, program_guard = _programs()
    from paddle_tpu_torch.fluid import layers

    with unique_name.guard(), program_guard(main, startup):
        x = layers.data(name="x", shape=[13], dtype="float32")
        y = layers.data(name="y", shape=[1], dtype="float32")
        y_predict = layers.fc(input=x, size=1)
        cost = layers.square_error_cost(input=y_predict, label=y)
        avg_cost = layers.mean(cost)
        fluid.optimizer.SGD(learning_rate=0.01).minimize(avg_cost)
    return main, startup


def build_recognize_digits_conv():
    """reference tests/book/test_recognize_digits.py (conv variant)."""
    fluid, unique_name, main, startup, program_guard = _programs()
    from paddle_tpu_torch.fluid import layers
    from paddle_tpu_torch.models import lenet

    with unique_name.guard(), program_guard(main, startup):
        img = layers.data(name="img", shape=[1, 28, 28], dtype="float32")
        label = layers.data(name="label", shape=[1], dtype="int64")
        avg_cost, acc, prediction = lenet.build(img, label)
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(avg_cost)
    return main, startup


def build_word2vec(dict_size: int = 200, embed_size: int = 16,
                   hidden_size: int = 32, n: int = 5):
    """reference tests/book/test_word2vec.py — n-gram next-word model
    with a shared embedding table."""
    fluid, unique_name, main, startup, program_guard = _programs()
    from paddle_tpu_torch.fluid import layers

    with unique_name.guard(), program_guard(main, startup):
        words = [layers.data(name=f"word_{i}", shape=[1], dtype="int64")
                 for i in range(n - 1)]
        next_word = layers.data(name="next_word", shape=[1], dtype="int64")
        embeds = [
            layers.embedding(input=w, size=[dict_size, embed_size],
                             param_attr=fluid.ParamAttr(name="shared_w"))
            for w in words
        ]
        concat = layers.concat(input=embeds, axis=1)
        hidden = layers.fc(input=concat, size=hidden_size, act="sigmoid")
        logits = layers.fc(input=hidden, size=dict_size)
        cost = layers.softmax_with_cross_entropy(logits=logits,
                                                 label=next_word)
        avg_cost = layers.mean(cost)
        fluid.optimizer.Adam(learning_rate=5e-3).minimize(avg_cost)
    return main, startup


def build_understand_sentiment_conv(dict_dim: int = 100, emb_dim: int = 16,
                                    hid_dim: int = 16, class_dim: int = 2):
    """reference tests/book/test_understand_sentiment.py
    (convolution_net)."""
    fluid, unique_name, main, startup, program_guard = _programs()
    from paddle_tpu_torch.fluid import layers, nets

    with unique_name.guard(), program_guard(main, startup):
        data = layers.data(name="words", shape=[1], dtype="int64",
                           lod_level=1)
        label = layers.data(name="label", shape=[1], dtype="int64")
        emb = layers.embedding(input=data, size=[dict_dim, emb_dim])
        conv_3 = nets.sequence_conv_pool(input=emb, num_filters=hid_dim,
                                         filter_size=3, act="tanh",
                                         pool_type="sqrt")
        conv_4 = nets.sequence_conv_pool(input=emb, num_filters=hid_dim,
                                         filter_size=4, act="tanh",
                                         pool_type="sqrt")
        merged = layers.concat(input=[conv_3, conv_4], axis=1)
        logits = layers.fc(input=merged, size=class_dim)
        cost = layers.softmax_with_cross_entropy(logits=logits, label=label)
        avg_cost = layers.mean(cost)
        fluid.optimizer.Adam(learning_rate=2e-3).minimize(avg_cost)
    return main, startup


BOOK_EXAMPLES: Dict[str, Callable[[], Tuple[object, object]]] = {
    "fit_a_line": build_fit_a_line,
    "recognize_digits_conv": build_recognize_digits_conv,
    "word2vec": build_word2vec,
    "understand_sentiment_conv": build_understand_sentiment_conv,
}


def build_all() -> Dict[str, Tuple[object, object]]:
    return {name: fn() for name, fn in BOOK_EXAMPLES.items()}
