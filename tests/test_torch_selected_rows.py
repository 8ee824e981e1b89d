"""The port's SelectedRows sparse gradients (``fluid/selected_rows.py``,
the sparse ``lookup_table`` grad, ``sum``/``clip`` on SelectedRows, the
optimizer ops' sparse branches, ``split_ids``/``split_selected_rows``)
against the JAX package's, on the CPU — tests/test_selected_rows.py
with both packages:

  - ``merged()`` and ``add_any`` against the JAX functions;
  - an embedding trained sparse for 3 steps with repeated ids equals the
    JAX package's sparse run and the port's dense run, for SGD,
    Momentum, Adam and Adagrad (the merged-row branches) and for every
    other optimizer (which densify); each other optimizer op alone on a
    SelectedRows gradient against the JAX op;
  - the grad var is ``selected_rows`` in the IR and a SelectedRows of
    [N, D] at run time, fetched as one; its dense form is the JAX one;
  - a 2,000-row word2vec-style program (Adam, fc head) trains alike in
    both packages and its loss falls;
  - global-norm clipping of a sparse gradient;
  - a sparse step repeated from the same state is bitwise the same.

Tolerances (float32; XLA and PyTorch sum in other orders): parameters and
losses rtol 1e-5 / atol 1e-6; the port's sparse run against its dense run
rtol 2e-5 / atol 2e-6 (tests/test_selected_rows.py's bound: a repeated row
adds its terms one by one in place of their sum); rows and index outputs
exactly equal. The word2vec table after 4 Adam steps: atol 1e-5, a
thousandth of the rate 0.01 (Adam divides by the gradient's own scale, so
an element whose gradient is at the rounding level moves by a rounding-
sized fraction of the rate).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.fluid.registry import get_op_info as jax_op_info
from paddle_tpu.fluid.selected_rows import (
    SelectedRows as JSelectedRows, add_any as jadd_any)
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import layers as tlayers
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.fluid.registry import EmitCtx, run_forward
from paddle_tpu_torch.fluid.selected_rows import SelectedRows, add_any

RTOL, ATOL = 1e-5, 1e-6
SPARSE_DENSE_RTOL, SPARSE_DENSE_ATOL = 2e-5, 2e-6
W2V_LR = 0.01
ADAM_TABLE_ATOL = 1e-3 * W2V_LR
JAX = (jfluid, jlayers, junique)
PORT = (tfluid, tlayers, tunique)


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _same_program(tp, jp):
    """``to_bytes()`` equal, up to a var declared int64 that the JAX
    package's bytes record as int32 (no x64), and the dtype attr (a
    cast's ``in_dtype``) read from such a var."""
    tj, jj = json.loads(tp.to_bytes()), json.loads(jp.to_bytes())
    for tb, jb in zip(tj["blocks"], jj["blocks"]):
        for name, jv in jb["vars"].items():
            tv = tb["vars"].get(name)
            if tv and (tv["dtype"], jv["dtype"]) == ("int64", "int32"):
                jv["dtype"] = "int64"
        for to, jo in zip(tb["ops"], jb["ops"]):
            for key, jv in jo["attrs"].items():
                if (to["attrs"].get(key), jv) == ("int64", "int32"):
                    jo["attrs"][key] = "int64"
    assert tj == jj


def _pair(rows, value, height):
    """The same SelectedRows in each package."""
    return (SelectedRows(torch.tensor(rows, dtype=torch.int64),
                         torch.from_numpy(value), height),
            JSelectedRows(jnp.asarray(rows, jnp.int32), jnp.asarray(value),
                          height))


# --- the class ------------------------------------------------------------

def test_merged_matches_jax():
    rows = [3, 1, 3, 7, 1, 3]
    vals = np.random.RandomState(0).randn(6, 2).astype(np.float32)
    t, j = _pair(rows, vals, 10)
    for got, want in zip(t.merged(), j.merged()):
        _close(got.numpy(), want)
    r_s, merged, mask = t.merged()
    np.testing.assert_array_equal(r_s.numpy(), [1, 1, 3, 3, 3, 7])
    np.testing.assert_array_equal(mask.numpy(), [1, 0, 1, 0, 0, 1])
    dense = np.zeros((10, 2), np.float32)
    np.add.at(dense, r_s.numpy(), mask.numpy()[:, None] * merged.numpy())
    _close(dense, t.to_dense().numpy())
    _close(t.to_dense().numpy(), j.to_dense())


def test_add_any_sparse_sparse_and_mixed_match_jax():
    rng = np.random.RandomState(1)
    ta, ja = _pair([0, 2], rng.randn(2, 3).astype(np.float32), 4)
    tb, jb = _pair([2, 3, 2], rng.randn(3, 3).astype(np.float32), 4)
    ss = add_any(ta, tb)
    assert isinstance(ss, SelectedRows) and ss.value.shape == (5, 3)
    np.testing.assert_array_equal(ss.rows.numpy(),
                                  np.asarray(jadd_any(ja, jb).rows))
    _close(ss.to_dense().numpy(), jadd_any(ja, jb).to_dense())
    dense = rng.randn(4, 3).astype(np.float32)
    for got, want in ((add_any(ta, torch.from_numpy(dense)),
                       jadd_any(ja, jnp.asarray(dense))),
                      (add_any(torch.from_numpy(dense), tb),
                       jadd_any(jnp.asarray(dense), jb))):
        assert isinstance(got, torch.Tensor)
        _close(got.numpy(), want)


# --- an embedding trained sparse -----------------------------------------

VOCAB, DIM, BATCH = 50, 8, 16

OPTIMIZERS = {
    "sgd": lambda o: o.SGD(learning_rate=0.1),
    "momentum": lambda o: o.Momentum(learning_rate=0.1, momentum=0.9),
    "momentum_nesterov": lambda o: o.Momentum(learning_rate=0.1,
                                              momentum=0.9,
                                              use_nesterov=True),
    "adam": lambda o: o.Adam(learning_rate=0.1),
    "adagrad": lambda o: o.Adagrad(learning_rate=0.1),
    "adamax": lambda o: o.Adamax(learning_rate=0.1),
    "decayed_adagrad": lambda o: o.DecayedAdagrad(learning_rate=0.1),
    "adadelta": lambda o: o.Adadelta(learning_rate=0.1),
    "rmsprop": lambda o: o.RMSProp(learning_rate=0.1),
    "ftrl": lambda o: o.Ftrl(learning_rate=0.1, l1=0.01, l2=0.01),
}
# the merged-row branches; the others densify
ROW_WISE = ("sgd", "momentum", "momentum_nesterov", "adam", "adagrad")


def _embedding_program(pkg, is_sparse, opt):
    fluid, layers, unique_name = pkg
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = 7
    with unique_name.guard(), fluid.program_guard(prog, startup):
        ids = layers.data(name="ids", shape=[1], dtype="int64")
        label = layers.data(name="label", shape=[DIM], dtype="float32")
        emb = layers.embedding(input=ids, size=[VOCAB, DIM],
                               is_sparse=is_sparse, param_attr="emb_w")
        cost = layers.mean(layers.square_error_cost(input=emb, label=label))
        OPTIMIZERS[opt](fluid.optimizer).minimize(cost)
    return prog, startup, cost


def _train_feeds(steps=3):
    """W0, and a fixed id set with repeats (the lazy sparse moments then
    equal the dense ones: untouched rows keep zero moments), a label a
    step."""
    rng = np.random.RandomState(0)
    w0 = (rng.rand(VOCAB, DIM) * 0.1).astype(np.float32)
    ids = rng.randint(0, VOCAB, size=(BATCH, 1)).astype(np.int64)
    ids[3] = ids[5] = ids[9]
    ids[11] = ids[2]
    return w0, [{"ids": ids, "label": rng.rand(BATCH, DIM).astype(
        np.float32)} for _ in range(steps)]


def _train(pkg, is_sparse, opt, steps=3):
    prog, startup, cost = _embedding_program(pkg, is_sparse, opt)
    fluid = pkg[0]
    w0, feeds = _train_feeds(steps)
    scope, exe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    scope.set_var("emb_w", jnp.asarray(w0) if pkg is JAX
                  else torch.from_numpy(w0.copy()))
    losses = [float(np.asarray(exe.run(prog, feed=f, fetch_list=[cost],
                                       scope=scope)[0]).reshape(-1)[0])
              for f in feeds]
    return np.asarray(scope.find_var("emb_w")), losses, prog, startup


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_sparse_embedding_trains_as_jax_and_as_dense(opt):
    tw, tl, tp, ts = _train(PORT, True, opt)
    jw, jl, jp, js = _train(JAX, True, opt)
    _same_program(tp, jp)
    _same_program(ts, js)
    assert tp.global_block().var("emb_w@GRAD").desc.type == "selected_rows"
    _close(tl, jl, what="losses")
    _close(tw, jw, what="W against the JAX package's sparse run")
    dw, dl, _, _ = _train(PORT, False, opt)
    _close(tw, dw, SPARSE_DENSE_RTOL, SPARSE_DENSE_ATOL,
           "W against the port's dense run")
    if opt in ROW_WISE:  # rows no batch touched stay where they were
        w0, feeds = _train_feeds()
        untouched = np.setdiff1d(np.arange(VOCAB), feeds[0]["ids"])
        np.testing.assert_array_equal(tw[untouched], w0[untouched])


def _optimizer_op_case(op, rng):
    """A [6, 3] parameter, its state and a SelectedRows gradient over
    rows [4, 1, 4, 0] (row 4 twice)."""
    p = lambda: rng.rand(6, 3).astype(np.float32) + 0.1  # noqa: E731
    lr = np.array([0.1], np.float32)
    state = {
        "adamax": {"Moment": p(), "InfNorm": p(),
                   "Beta1Pow": np.array([0.9 ** 3], np.float32)},
        "decayed_adagrad": {"Moment": p()},
        "adadelta": {"AvgSquaredGrad": p(), "AvgSquaredUpdate": p()},
        "rmsprop": {"MeanSquare": p(), "Moment": p()},
        "ftrl": {"SquaredAccumulator": p(), "LinearAccumulator": p()},
        "proximal_gd": {},
        "proximal_adagrad": {"Moment": p()},
    }[op]
    attrs = {"ftrl": {"l1": 0.05, "l2": 0.01, "lr_power": -0.5},
             "proximal_gd": {"l1": 0.05, "l2": 0.01},
             "proximal_adagrad": {"l1": 0.05, "l2": 0.01}}.get(op, {})
    dense = {"Param": p(), "LearningRate": lr, **state}
    grad = rng.randn(4, 3).astype(np.float32)
    return dense, grad, attrs


@pytest.mark.parametrize("op", ["adamax", "decayed_adagrad", "adadelta",
                                "rmsprop", "ftrl", "proximal_gd",
                                "proximal_adagrad"])
def test_densifying_optimizer_op_on_selected_rows_matches_jax(op):
    dense, grad, attrs = _optimizer_op_case(op, np.random.RandomState(5))
    tg, jg = _pair([4, 1, 4, 0], grad, 6)
    tout = run_forward(EmitCtx(device="cpu", root_seed=1), op, {
        **{s: [torch.from_numpy(v)] for s, v in dense.items()},
        "Grad": [tg]}, attrs)
    jout = jax_op_info(op).forward(None, {
        **{s: [jnp.asarray(v)] for s, v in dense.items()},
        "Grad": [jg]}, attrs)
    assert set(tout) == set(jout)
    for s in tout:
        _close(tout[s][0].numpy(), jout[s], what=s)


def test_sparse_grad_is_selected_rows_in_ir_and_at_runtime():
    ids = np.array([[1], [4], [1], [9]], dtype=np.int64)
    lbl = np.ones((4, DIM), np.float32)
    got = {}
    for pkg in (PORT, JAX):
        prog, startup, cost = _embedding_program(
            pkg, True, "sgd")
        fluid = pkg[0]
        assert prog.global_block().var("emb_w@GRAD").desc.type == \
            "selected_rows"
        scope, exe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        w0, _ = _train_feeds()
        scope.set_var("emb_w", jnp.asarray(w0) if pkg is JAX
                      else torch.from_numpy(w0.copy()))
        got[pkg] = exe.run(prog, feed={"ids": ids, "label": lbl},
                           fetch_list=["emb_w@GRAD"], scope=scope)[0]
    g, jg = got[PORT], got[JAX]
    assert isinstance(g, SelectedRows)
    assert isinstance(g.value, np.ndarray) and g.value.shape == (4, DIM)
    assert g.height == VOCAB
    np.testing.assert_array_equal(g.rows, [1, 4, 1, 9])
    np.testing.assert_array_equal(g.rows, np.asarray(jg.rows))
    _close(g.value, jg.value)
    _close(g.to_dense(), jg.to_dense())
    # return_numpy=False: a SelectedRows of tensors
    prog, startup, cost = _embedding_program(PORT, True, "sgd")
    scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    (gt,) = exe.run(prog, feed={"ids": ids, "label": lbl},
                    fetch_list=["emb_w@GRAD"], scope=scope,
                    return_numpy=False)
    assert isinstance(gt, SelectedRows) and isinstance(gt.value,
                                                       torch.Tensor)


def test_sparse_step_repeats_bitwise():
    prog, startup, cost = _embedding_program(PORT, True, "adam")
    w0, feeds = _train_feeds(1)
    params = []
    for _ in range(2):
        scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        scope.set_var("emb_w", torch.from_numpy(w0.copy()))
        exe.run(prog, feed=feeds[0], fetch_list=[cost], scope=scope)
        params.append(scope.find_var("emb_w").numpy())
    np.testing.assert_array_equal(params[0], params[1])


# --- a word2vec-style program ---------------------------------------------

W2V_VOCAB, W2V_DIM, W2V_BATCH = 2000, 64, 64


def _w2v(pkg):
    fluid, layers, unique_name = pkg
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = 11
    with unique_name.guard(), fluid.program_guard(prog, startup):
        ids = layers.data(name="ids", shape=[1], dtype="int64")
        label = layers.data(name="label", shape=[1], dtype="int64")
        emb = layers.embedding(input=ids, size=[W2V_VOCAB, W2V_DIM],
                               is_sparse=True, param_attr="w2v_emb")
        fc = layers.fc(input=emb, size=32, act="relu")
        logit = layers.fc(input=fc, size=16)
        loss = layers.mean(layers.softmax_with_cross_entropy(
            logits=logit, label=label))
        fluid.optimizer.Adam(learning_rate=W2V_LR).minimize(loss)
    return prog, startup, loss


def test_word2vec_style_program_trains_as_jax():
    """tests/test_selected_rows.py's large-vocabulary program at 2,000
    rows (the card runs 100,000 and 1,000,000): the same start, 4 Adam
    steps on Zipf-drawn ids in both packages."""
    (tp, ts, tloss), (jp, js, jloss) = _w2v(PORT), _w2v(JAX)
    _same_program(tp, jp)
    _same_program(ts, js)
    jscope, jexe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
    jexe.run(js, scope=jscope)
    tscope, texe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    texe.run(ts, scope=tscope)
    for name, v in jp.global_block().vars.items():
        if v.persistable and jscope.find_var(name) is not None:
            tscope.set_var(name, torch.from_numpy(np.array(
                jscope.find_var(name))))
    rng = np.random.RandomState(3)
    ids = np.minimum(rng.zipf(1.2, (W2V_BATCH, 1)), W2V_VOCAB) - 1
    feed = {"ids": ids.astype(np.int64),
            "label": (ids % 16).astype(np.int64)}
    assert len(np.unique(ids)) < W2V_BATCH  # the Zipf draw repeats rows
    tl, jl = [], []
    for _ in range(4):
        tout = texe.run(tp, feed=feed, fetch_list=[tloss, "w2v_emb@GRAD"],
                        scope=tscope)
        jout = jexe.run(jp, feed=feed, fetch_list=[jloss, "w2v_emb@GRAD"],
                        scope=jscope)
        assert isinstance(tout[1], SelectedRows)
        assert tout[1].value.shape == (W2V_BATCH, W2V_DIM)
        _close(tout[1].to_dense(), jout[1].to_dense(), what="grad")
        tl.append(float(tout[0][0]))
        jl.append(float(np.asarray(jout[0]).reshape(-1)[0]))
    _close(tl, jl, what="losses")
    assert tl[-1] < tl[0]
    _close(tscope.find_var("w2v_emb").numpy(),
           np.asarray(jscope.find_var("w2v_emb")), atol=ADAM_TABLE_ATOL,
           what="table")


# --- clipping ---------------------------------------------------------------

def test_global_norm_clip_on_sparse_grad_matches_jax():
    out = {}
    for pkg in (PORT, JAX):
        fluid, layers, unique_name = pkg
        prog, startup = fluid.Program(), fluid.Program()
        prog.random_seed = startup.random_seed = 5
        with unique_name.guard(), fluid.program_guard(prog, startup):
            ids = layers.data(name="ids", shape=[1], dtype="int64")
            label = layers.data(name="label", shape=[4], dtype="float32")
            emb = layers.embedding(input=ids, size=[20, 4], is_sparse=True,
                                   param_attr="clip_emb")
            cost = layers.mean(layers.square_error_cost(input=emb,
                                                        label=label))
            fluid.clip.set_gradient_clip(
                fluid.clip.GradientClipByGlobalNorm(clip_norm=1e-4),
                program=prog)
            fluid.optimizer.SGD(learning_rate=1.0).minimize(cost)
        scope, exe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        w0 = (np.arange(80, dtype=np.float32).reshape(20, 4) / 80.0)
        scope.set_var("clip_emb", jnp.asarray(w0) if pkg is JAX
                      else torch.from_numpy(w0.copy()))
        exe.run(prog, feed={"ids": np.array([[2], [2], [7]], np.int64),
                            "label": 100.0 * np.ones((3, 4), np.float32)},
                fetch_list=[cost], scope=scope)
        out[pkg] = (prog, np.asarray(scope.find_var("clip_emb")) - w0)
    _same_program(out[PORT][0], out[JAX][0])
    moved = out[PORT][1]
    _close(moved, out[JAX][1], what="the update")
    assert 0 < np.abs(moved).sum() < 1e-3
    np.testing.assert_array_equal(np.delete(moved, [2, 7], axis=0), 0.0)
    # the clipped update's global norm is the clip norm
    _close(np.sqrt((moved ** 2).sum()), 1e-4, rtol=1e-4)


@pytest.mark.parametrize("op,attrs", [
    ("clip", {"min": -0.2, "max": 0.3}),
    ("clip", {"min": 0.1, "max": 0.3}),          # 0 outside the range
    ("clip_by_norm", {"max_norm": 0.5}),
    ("squared_l2_norm", {}),
])
def test_clip_ops_on_selected_rows_match_jax(op, attrs):
    vals = np.random.RandomState(2).randn(5, 3).astype(np.float32) * 0.4
    tg, jg = _pair([3, 0, 3, 3, 1], vals, 6)
    tout = run_forward(EmitCtx(device="cpu", root_seed=1), op,
                       {"X": [tg]}, attrs)["Out"][0]
    jout = jax_op_info(op).forward(None, {"X": [jg]}, attrs)["Out"]
    if op == "squared_l2_norm":
        _close(tout.numpy(), jout)
        return
    assert isinstance(tout, SelectedRows)
    np.testing.assert_array_equal(tout.rows.numpy(), np.asarray(jout.rows))
    _close(tout.value.numpy(), jout.value)


def test_scalar_mul_keeps_selected_rows():
    tg, jg = _pair([1, 1, 0], np.ones((3, 2), np.float32), 3)
    scale = np.array([0.5], np.float32)
    for op in ("elementwise_mul", "elementwise_div"):
        tout = run_forward(EmitCtx(device="cpu", root_seed=1), op, {
            "X": [tg], "Y": [torch.from_numpy(scale)]}, {})["Out"][0]
        jout = jax_op_info(op).forward(None, {
            "X": [jg], "Y": [jnp.asarray(scale)]}, {})["Out"]
        assert isinstance(tout, SelectedRows)
        _close(tout.to_dense().numpy(), jout.to_dense())


# --- split_ids, split_selected_rows ---------------------------------------

def test_split_ids_matches_jax():
    ids = np.array([[7], [2], [5], [0], [-1], [9], [4]], np.int64)
    attrs = {"num_shards": 3}
    tout = run_forward(EmitCtx(device="cpu", root_seed=1), "split_ids",
                       {"Ids": [torch.from_numpy(ids)]}, attrs)["Out"]
    jout = jax_op_info("split_ids").forward(
        None, {"Ids": [jnp.asarray(ids)]}, attrs)["Out"]
    assert len(tout) == len(jout) == 3
    for t, j in zip(tout, jout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_split_selected_rows_matches_jax():
    vals = np.random.RandomState(4).randn(6, 2).astype(np.float32)
    tg, jg = _pair([7, 0, 3, 9, 3, 5], vals, 10)
    attrs = {"height_sections": [3, 4, 3]}
    tout = run_forward(EmitCtx(device="cpu", root_seed=1),
                       "split_selected_rows", {"X": [tg]}, attrs)["Out"]
    jout = jax_op_info("split_selected_rows").forward(
        None, {"X": [jg]}, attrs)["Out"]
    assert [t.height for t in tout] == [j.height for j in jout] == [3, 4, 3]
    for t, j in zip(tout, jout):
        np.testing.assert_array_equal(t.rows.numpy(), np.asarray(j.rows))
        np.testing.assert_array_equal(t.value.numpy(), np.asarray(j.value))
    # the sections' rows, shifted back, rebuild the input
    whole = np.zeros((10, 2), np.float32)
    start = 0
    for t in tout:
        keep = t.rows.numpy() >= 0
        np.add.at(whole, t.rows.numpy()[keep] + start, t.value.numpy()[keep])
        start += t.height
    _close(whole, tg.to_dense().numpy())
