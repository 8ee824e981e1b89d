"""The control-flow programs of ``paddle_tpu_torch/models/seq2seq.py``
built by both packages and run by both executors, on the CPU at a small
width (dictionary 64, word width 16, hidden 16–32):

  (a) the reference suite's DynamicRNN LSTM classifier
      (``benchmarks/fluid_suite_bench.py:115-162``), ragged lengths
      including 1 and T;
  (b) the book's machine-translation train program
      (``tests/test_machine_translation.py:49-116``) fed by the wmt14
      reader through ``batch`` and ``DataFeeder``;
  (c) ``seq_to_seq_net`` (``tests/test_rnn_encoder_decoder.py:65-105``):
      a bi-LSTM encoder and a DynamicRNN decoder with two memories and a
      static input;
  (d) the machine-translation While beam decode
      (``tests/test_machine_translation.py:118-200``) on the JAX scope's
      trained values.

Each program has the same bytes in both packages (up to the int64 vars
the JAX package's shape inference records as int32); the port's scope
starts from the JAX scope's values (``params_from_jax``). Held: (a)–(c)
5 Adam steps, losses within 1e-5 relative, and (a) the step-1
gradients within rtol 1e-5 / atol 1e-6; (d) ids and parents bitwise,
scores within 1e-5 relative.
"""
import json

import numpy as np

import paddle_tpu
import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid import unique_name as junique
import paddle_tpu_torch
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import layers as tlayers
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.models import seq2seq

LOSS_RTOL = 1e-5
RTOL, ATOL = 1e-5, 1e-6
DICT, WORD, HID, BATCH, BEAM, MAX_LEN = 64, 16, 32, 8, 3, 8
JAX = (paddle_tpu, jfluid, jlayers, junique)
PORT = (paddle_tpu_torch, tfluid, tlayers, tunique)


def _same_program(tp, jp):
    """``to_bytes()`` equal, up to one known difference: a var declared
    int64 is int64 in the port's bytes and int32 in the JAX package's
    where its shape inference (no x64) recorded the int32 it computes
    in."""
    tj, jj = json.loads(tp.to_bytes()), json.loads(jp.to_bytes())
    for tb, jb in zip(tj["blocks"], jj["blocks"]):
        for name, jv in jb["vars"].items():
            tv = tb["vars"].get(name)
            if tv and (tv["dtype"], jv["dtype"]) == ("int64", "int32"):
                jv["dtype"] = "int64"
    assert tj == jj


def _build(pkg, fn, lr=1e-2):
    _, fluid, layers, unique_name = pkg
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 31
    with unique_name.guard(), fluid.program_guard(main, startup):
        out = fn(layers)
        if lr:
            fluid.optimizer.Adam(learning_rate=lr).minimize(out)
    return main, startup, out


def _both(fn, lr=1e-2):
    (jm, js, jo), (tm, ts, to) = _build(JAX, fn, lr), _build(PORT, fn, lr)
    _same_program(tm, jm)
    _same_program(ts, js)
    return (jm, js, jo), (tm, ts, to)


def _persistables(program, scope):
    return {n: np.asarray(scope.find_var(n))
            for n, v in program.global_block().vars.items()
            if v.persistable and scope.find_var(n) is not None}


def _executors(jm, js):
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    tfluid.params_from_jax(_persistables(jm, jscope), tscope, device="cpu")
    return (jexe, jscope), (texe, tscope)


def _train_alike(fn, feeds, grads=()):
    """5 Adam steps in each package from the JAX scope's values; returns
    the two loss lists, the step-1 gradients and the scopes."""
    (jm, js, jc), (tm, ts, tc) = _both(fn)
    (jexe, jscope), (texe, tscope) = _executors(jm, js)
    out = {"jax": [], "torch": [], "g_jax": None, "g_torch": None}
    for i, (jfeed, tfeed) in enumerate(feeds(jm, tm)):
        extra = list(grads) if i == 0 else []
        j = jexe.run(jm, feed=jfeed, fetch_list=[jc] + extra, scope=jscope)
        t = texe.run(tm, feed=tfeed, fetch_list=[tc] + extra, scope=tscope)
        out["jax"].append(float(np.asarray(j[0]).reshape(-1)[0]))
        out["torch"].append(float(np.asarray(t[0]).reshape(-1)[0]))
        if i == 0:
            out["g_jax"] = [np.asarray(g) for g in j[1:]]
            out["g_torch"] = [np.asarray(g) for g in t[1:]]
    assert len(out["torch"]) == 5 and all(np.isfinite(out["torch"]))
    np.testing.assert_allclose(out["torch"], out["jax"], rtol=LOSS_RTOL)
    return out, jscope, jm


def _fed(names, reader):
    """Each package's DataFeeder over the same 5 batches."""
    def feeds(jm, tm):
        jf = jfluid.DataFeeder(feed_list=names, program=jm)
        tf = tfluid.DataFeeder(feed_list=names, program=tm,
                               place=tfluid.CPUPlace())
        for i, data in enumerate(reader()):
            if i == 5:
                return
            yield jf.feed(data), tf.feed(data)
    return feeds


def test_a_dynamic_rnn_lstm_trains_alike():
    rng = np.random.RandomState(3)
    batches = []
    for _ in range(5):
        lens = rng.randint(1, 9, 4).astype(np.int32)
        lens[:2] = [1, 8]  # 1 and T
        batches.append({
            "words": rng.randint(0, DICT, (4, 8, 1)).astype(np.int64),
            "words@LEN": lens,
            "label": rng.randint(0, 2, (4, 1)).astype(np.int64)})

    def fn(layers):
        words = layers.data(name="words", shape=[1], dtype="int64",
                            lod_level=1)
        label = layers.data(name="label", shape=[1], dtype="int64")
        return seq2seq.dynamic_rnn_lstm(layers, words, label, DICT,
                                        emb_dim=WORD, hidden=16)

    grads = ["embedding_0.w_0@GRAD", "fc_0.w_0@GRAD", "fc_1.w_0@GRAD",
             "fc_2.w_0@GRAD", "fc_8.w_0@GRAD", "fc_9.w_0@GRAD"]
    out, _, _ = _train_alike(fn, lambda jm, tm: ((b, b) for b in batches),
                             grads)
    for name, a, b in zip(grads, out["g_torch"], out["g_jax"]):
        assert np.abs(b).max() > 0, name
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)


def _wmt_batches():
    return paddle_tpu_torch.batch(
        paddle_tpu_torch.dataset.wmt14.train(DICT), batch_size=BATCH)


MT_FEEDS = ["src_word_id", "target_language_word",
            "target_language_next_word"]


def test_b_machine_translation_train_alike_and_c_beam_decode_bitwise():
    out, jscope, jm = _train_alike(
        lambda layers: seq2seq.mt_train(layers, DICT, WORD, HID, BATCH),
        _fed(MT_FEEDS, _wmt_batches()))
    assert out["torch"][-1] < out["torch"][0]

    # the decode on the JAX scope's trained values, in both packages
    jdec, tdec = _both(
        lambda layers: seq2seq.mt_decode(layers, DICT, WORD, HID, BATCH,
                                         BEAM, MAX_LEN), lr=0)
    (dj, _, (ji, jsc, (_, _, jp))), (dt, _, (ti, tsc, (_, _, tp))) = \
        jdec, tdec
    trained = _persistables(jm, jscope)
    for n in _persistables(dj, jscope):
        assert n in trained, n
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    tfluid.params_from_jax(trained, tscope, device="cpu")
    data = [(d[0],) for d in next(iter(_wmt_batches()()))]
    jfeed = jfluid.DataFeeder(feed_list=["src_word_id"], program=dj).feed(
        data)
    tfeed = tfluid.DataFeeder(feed_list=["src_word_id"], program=dt,
                              place=tfluid.CPUPlace()).feed(data)
    jfeed.update(seq2seq.decode_init(BATCH, BEAM))
    tfeed.update(seq2seq.decode_init(BATCH, BEAM))
    j = jfluid.Executor(jfluid.CPUPlace()).run(
        dj, feed=jfeed, fetch_list=[ji, jsc, jp], scope=jscope)
    t = texe.run(dt, feed=tfeed, fetch_list=[ti, tsc, tp], scope=tscope)
    ids, scores, parents = (np.asarray(v) for v in t)
    assert ids.shape == (BATCH, BEAM, MAX_LEN + 1) and ids.dtype == np.int64
    np.testing.assert_array_equal(ids, np.asarray(j[0]))
    np.testing.assert_array_equal(parents, np.asarray(j[2]))
    np.testing.assert_allclose(scores, np.asarray(j[1]), rtol=1e-5)
    assert (np.diff(scores, axis=1) <= 0).all()  # best hypothesis first
    for row in ids.reshape(-1, MAX_LEN + 1):  # END stays END
        ends = np.where(row == seq2seq.END_ID)[0]
        assert not len(ends) or (row[ends[0]:] == seq2seq.END_ID).all()


def test_d_seq_to_seq_net_trains_alike():
    out, _, _ = _train_alike(
        lambda layers: seq2seq.seq_to_seq_net(layers, DICT, WORD, HID,
                                              BATCH),
        _fed(["source_sequence", "target_sequence", "label_sequence"],
             _wmt_batches()))
    assert out["torch"][-1] < out["torch"][0]
