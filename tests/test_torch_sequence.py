"""The port's padded-sequence path (``fluid/ops/sequence_ops.py``:
``sequence_pool``, ``lstm``; ``fluid/layers/sequence.py``;
``models/stacked_lstm.py``) against the JAX package's, on the CPU:

  (a) ``sequence_pool`` for all six pool types: output and the gradient
      in X (the port through its record-and-grad path) against the JAX op
      and its ``jax.vjp`` on ragged lengths including 1 and T; a MAX tie
      spreads its gradient evenly in both;
  (b) ``lstm`` with peepholes on and off, ``is_reverse``, ragged lengths
      and non-default activations: Hidden, Cell and the gradients in
      Input, Weight and Bias;
  (c) the stacked LSTM (dict 100, emb 16, hid 16, 2 stacked) builds the
      same program bytes and trains alike for 5 Adam steps from the JAX
      scope's values;
  (d) the book's dynamic_lstm + sequence_last_step sentiment program
      (tests/test_book.py:176-215) fed by the imdb reader through
      DataFeeder trains alike.

Tolerances (float32; XLA and PyTorch sum in other orders): op outputs
and gradients rtol 1e-5 / atol 1e-6; losses 1e-5 relative.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.fluid.registry import get_op_info as jax_op_info
from paddle_tpu.models import stacked_lstm as jstacked
import paddle_tpu_torch
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import layers as tlayers
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.fluid.registry import (
    FWD_META_ATTR, EmitCtx, forward_with_grad, run_grad)
from paddle_tpu_torch.models import stacked_lstm as tstacked

OP_RTOL, OP_ATOL = 1e-5, 1e-6
LOSS_RTOL = 1e-5
JAX = (paddle_tpu, jfluid, jlayers, junique)
PORT = (paddle_tpu_torch, tfluid, tlayers, tunique)


def _port_op(op_type, ins, attrs, dys, no_grad=()):
    """Outputs and the input gradients for the cotangents ``dys``."""
    ctx = EmitCtx(device="cpu", root_seed=1)
    tins = {s: [torch.from_numpy(v)] for s, v in ins.items()}
    outs, record = forward_with_grad(ctx, op_type, tins, attrs)
    grad_attrs = {FWD_META_ATTR: {"type": op_type, "attrs": attrs,
                                  "in_slots": list(ins),
                                  "out_slots": list(outs)}}
    gins = dict(tins)
    gins.update({"Out@" + s: v for s, v in outs.items()})
    gins.update({"GRAD@" + s: [torch.from_numpy(d)] for s, d in dys.items()})
    grads = run_grad(ctx, gins, grad_attrs, record)
    return ({s: v[0].detach().numpy() for s, v in outs.items()},
            {s[5:]: v[0].numpy() for s, v in grads.items()
             if v and v[0] is not None})


def _jax_op(op_type, ins, attrs, diff_slots, dys):
    fwd = jax_op_info(op_type).forward

    def fn(*diffs):
        full = {s: [jnp.asarray(v)] for s, v in ins.items()}
        full.update({s: [d] for s, d in zip(diff_slots, diffs)})
        return fwd(None, full, attrs)

    primals = [jnp.asarray(ins[s]) for s in diff_slots]
    _, vjp = jax.vjp(lambda *d: {s: fn(*d)[s] for s in dys}, *primals)
    grads = vjp({s: jnp.asarray(d) for s, d in dys.items()})
    return ({s: np.asarray(v) for s, v in fn(*primals).items()},
            dict(zip(diff_slots, (np.asarray(g) for g in grads))))


def _op_parity(op_type, ins, attrs, diff_slots, dys, out_slots):
    tout, tgrads = _port_op(op_type, ins, attrs, dys)
    jout, jgrads = _jax_op(op_type, ins, attrs, diff_slots, dys)
    for s in out_slots:
        assert tout[s].dtype == jout[s].dtype, s
        np.testing.assert_allclose(tout[s], jout[s], rtol=OP_RTOL,
                                   atol=OP_ATOL, err_msg=s)
    for s in diff_slots:
        np.testing.assert_allclose(tgrads[s], jgrads[s], rtol=OP_RTOL,
                                   atol=OP_ATOL, err_msg="grad " + s)
    return tout, tgrads


# --- (a) sequence_pool ------------------------------------------------

POOLS = ["AVERAGE", "SUM", "SQRT", "MAX", "LAST", "FIRST"]


@pytest.mark.parametrize("pooltype", POOLS)
def test_a_sequence_pool_matches_jax(pooltype):
    rng = np.random.RandomState(3)
    x = rng.randn(5, 8, 3).astype(np.float32)
    lengths = np.array([1, 8, 5, 3, 8], np.int32)  # 1 and T among them
    dy = rng.randn(5, 3).astype(np.float32)
    out, grads = _op_parity("sequence_pool", {"X": x, "Lengths": lengths},
                            {"pooltype": pooltype}, ["X"], {"Out": dy},
                            ["Out"])
    assert out["Out"].shape == (5, 3)
    # nothing flows into the padding
    pad = np.arange(8)[None, :] >= lengths[:, None]
    assert not grads["X"][pad].any()


def test_a_sequence_pool_max_spreads_a_tie_like_jax():
    x = np.zeros((2, 4, 2), np.float32)
    x[0, :, 0] = [1.0, 3.0, 3.0, 9.0]   # a tie at 3 inside the length 3
    x[0, :, 1] = [2.0, 2.0, 2.0, 2.0]   # a three-way tie
    x[1, :, 0] = [5.0, 5.0, 1.0, 0.0]
    x[1, :, 1] = [-1.0, 4.0, 4.0, 4.0]
    lengths = np.array([3, 4], np.int32)
    dy = np.array([[6.0, 6.0], [6.0, 6.0]], np.float32)
    _, grads = _op_parity("sequence_pool", {"X": x, "Lengths": lengths},
                          {"pooltype": "MAX"}, ["X"], {"Out": dy}, ["Out"])
    np.testing.assert_array_equal(grads["X"][0, :, 0], [0, 3, 3, 0])
    np.testing.assert_array_equal(grads["X"][0, :, 1], [2, 2, 2, 0])
    np.testing.assert_array_equal(grads["X"][1, :, 1], [0, 2, 2, 2])


# --- (b) lstm -----------------------------------------------------------

LSTMS = [  # use_peepholes, is_reverse, gate, cell, candidate activations
    (False, False, "sigmoid", "tanh", "tanh"),
    (True, False, "sigmoid", "tanh", "tanh"),
    (True, True, "sigmoid", "tanh", "tanh"),
    (False, True, "sigmoid", "relu", "identity"),
    (True, False, "tanh", "identity", "relu"),
]


@pytest.mark.parametrize("peep,rev,gate,cell,cand", LSTMS)
def test_b_lstm_matches_jax(peep, rev, gate, cell, cand):
    rng = np.random.RandomState(7)
    N, T, H = 4, 6, 5
    ins = {"Input": rng.randn(N, T, 4 * H).astype(np.float32),
           "Weight": (0.5 * rng.randn(H, 4 * H)).astype(np.float32),
           "Bias": (0.5 * rng.randn((7 if peep else 4) * H)).astype(
               np.float32),
           "Lengths": np.array([6, 1, 3, 4], np.int32)}
    attrs = {"use_peepholes": peep, "is_reverse": rev,
             "gate_activation": gate, "cell_activation": cell,
             "candidate_activation": cand}
    dys = {"Hidden": rng.randn(N, T, H).astype(np.float32),
           "Cell": rng.randn(N, T, H).astype(np.float32)}
    out, _ = _op_parity("lstm", ins, attrs, ["Input", "Weight", "Bias"],
                        dys, ["Hidden", "Cell", "BatchCellPreAct"])
    # Hidden and Cell are zero past each sequence's length
    pad = np.arange(T)[None, :] >= ins["Lengths"][:, None]
    assert not out["Hidden"][pad].any() and not out["Cell"][pad].any()


# --- (c) the stacked LSTM model ----------------------------------------

def _build_stacked(pkg, dict_dim=100, emb=16, hid=16, stacked=2):
    _, fluid, layers, unique_name = pkg
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with unique_name.guard(), fluid.program_guard(main, startup):
        data = layers.data(name="words", shape=[1], dtype="int64",
                           lod_level=1)
        label = layers.data(name="label", shape=[1], dtype="int64")
        cost, acc, _ = (jstacked if pkg is JAX else tstacked).build(
            data, label, dict_dim=dict_dim, emb_dim=emb, hid_dim=hid,
            stacked_num=stacked)
        fluid.optimizer.Adam(1e-3).minimize(cost)
    return main, startup, cost, [data, label]


def _persistables(program, scope):
    return {n: np.asarray(scope.find_var(n))
            for n, v in program.global_block().vars.items()
            if v.persistable and scope.find_var(n) is not None}


def _assert_same_program(tp, jp):
    """``to_bytes()`` equal, up to the one known difference: the top_k
    Indices var is int64 in both programs, but the JAX package runs
    without x64 and its shape inference records the int32 it computes in
    (tests/test_torch_resnet_train.py pins the same)."""
    if tp.to_bytes() == jp.to_bytes():
        return
    tj, jj = json.loads(tp.to_bytes()), json.loads(jp.to_bytes())
    tvars, jvars = tj["blocks"][0]["vars"], jj["blocks"][0]["vars"]
    for op in tp.global_block().ops:
        if op.type == "top_k":
            name = op.output("Indices")[0]
            assert (jvars[name]["dtype"], tvars[name]["dtype"]) == \
                ("int32", "int64")
            jvars[name]["dtype"] = "int64"
    assert tj == jj


def _train_alike(build, batches, steps):
    """Build in both packages, run the JAX startup, copy its state into
    the port's scope, and train both on the same batches through each
    package's DataFeeder. Returns the losses of each."""
    jm, js, jcost, jfeeds = build(JAX)
    tm, ts, tcost, tfeeds = build(PORT)
    _assert_same_program(tm, jm)
    assert ts.to_bytes() == js.to_bytes()
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    tfluid.params_from_jax(_persistables(jm, jscope), tscope, device="cpu")
    jfeeder = jfluid.DataFeeder(feed_list=jfeeds, program=jm)
    tfeeder = tfluid.DataFeeder(feed_list=tfeeds, program=tm,
                                place=tfluid.CPUPlace())
    out = {"jax": [], "torch": []}
    for i, batch in enumerate(batches()):
        if i == steps:
            break
        for side, exe, prog, cost, scope, feeder in (
                ("jax", jexe, jm, jcost, jscope, jfeeder),
                ("torch", texe, tm, tcost, tscope, tfeeder)):
            (loss,) = exe.run(prog, feed=feeder.feed(batch),
                              fetch_list=[cost], scope=scope)
            out[side].append(float(np.asarray(loss).reshape(-1)[0]))
    assert len(out["torch"]) == steps
    return out


def test_c_stacked_lstm_program_equals_jax_and_trains_alike():
    rng = np.random.RandomState(11)

    def batches():
        while True:
            yield [(rng.randint(0, 100, rng.randint(1, 15)).tolist(),
                    int(rng.randint(0, 2))) for _ in range(6)]

    out = _train_alike(_build_stacked, batches, 5)
    np.testing.assert_allclose(out["torch"], out["jax"], rtol=LOSS_RTOL)
    assert all(np.isfinite(out["torch"]))


def _build_book_sentiment(pkg):
    """tests/test_book.py:176-215's program."""
    paddle, fluid, layers, unique_name = pkg
    dict_dim = len(paddle.dataset.imdb.word_dict())
    emb_dim = hid_dim = 32
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 23
    with unique_name.guard(), fluid.program_guard(main, startup):
        data = layers.data(name="words", shape=[1], dtype="int64",
                           lod_level=1)
        label = layers.data(name="label", shape=[1], dtype="int64")
        emb = layers.embedding(input=data, size=[dict_dim, emb_dim])
        fc1 = layers.fc(input=emb, size=hid_dim * 4, num_flatten_dims=2)
        lstm1, _ = layers.dynamic_lstm(input=fc1, size=hid_dim * 4)
        lstm_last = layers.sequence_last_step(lstm1)
        logits = layers.fc(input=lstm_last, size=2)
        cost = layers.softmax_with_cross_entropy(logits=logits, label=label)
        avg_cost = layers.mean(cost)
        fluid.optimizer.Adam(learning_rate=2e-3).minimize(avg_cost)
    return main, startup, avg_cost, [data, label]


def test_d_book_dynamic_lstm_sentiment_from_the_imdb_reader(monkeypatch,
                                                            tmp_path):
    monkeypatch.setenv("PADDLE_TPU_DATA", str(tmp_path))  # synthetic imdb
    batches = paddle_tpu_torch.batch(
        paddle_tpu_torch.dataset.imdb.train(), batch_size=16)
    out = _train_alike(_build_book_sentiment, batches, 3)
    np.testing.assert_allclose(out["torch"], out["jax"], rtol=LOSS_RTOL)
    assert all(np.isfinite(out["torch"]))
