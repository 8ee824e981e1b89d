"""The book's four text chapters and a CTC program in the port, against
the JAX package, on the CPU:

  (a) the datasets ``imikolov``, ``movielens`` and ``conll05``: every
      sample of the port's readers equals the JAX package's, and so do
      their dictionaries and id bounds; the ops that rewrite a lengths
      companion (``sequence_concat``, ``lod_reset``) in programs built by
      both packages (tests/test_sequence_and_rnn.py:238, :364, :388),
      outputs and ``@LEN`` equal;
  (b) word2vec (tests/test_book.py:76), sentiment conv
      (tests/test_book.py:124), the recommender system
      (tests/test_book_more.py:122) and label semantic roles
      (tests/test_book_more.py:206) at those tests' widths, and a CTC
      program (fc -> warpctc -> SGD; ctc_greedy_decoder -> edit_distance):
      each built by both packages (the same program bytes, up to the
      int32 the JAX package records for an int64 var), the JAX startup's
      parameters copied into the port, 3 steps from the dataset readers
      through each package's DataFeeder. Losses within 2e-5 relative;
      the step-1 gradient of a parameter that several layers share (the
      six word slots' ``emb``, word2vec's ``shared_w``) within 1e-4 of
      its max — one tensor, its gradient summed over every use; the SRL
      Viterbi path and the CTC edit distances exactly equal after
      training.
"""
import json
import types

import numpy as np
import pytest

import chip_smoke
import paddle_tpu
import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid import nets as jnets
from paddle_tpu.fluid import unique_name as junique
import paddle_tpu_torch
import paddle_tpu_torch.fluid as tfluid

LOSS_RTOL = 2e-5
GRAD_TOL = 1e-4  # of the gradient's largest |value|
STEPS = 3
JAX = types.SimpleNamespace(paddle=paddle_tpu, fluid=jfluid, layers=jlayers,
                            nets=jnets, unique_name=junique)
PORT = chip_smoke.port_pkg()


# --- (a) datasets -----------------------------------------------------------

@pytest.mark.parametrize("name,make", [
    ("imikolov", lambda ds: [ds.imikolov.train(ds.imikolov.build_dict(), 5),
                             ds.imikolov.test(n=3)]),
    ("movielens", lambda ds: [ds.movielens.train(), ds.movielens.test()]),
    ("conll05", lambda ds: [ds.conll05.train(), ds.conll05.test()]),
])
def test_a_dataset_samples_equal_jax(name, make):
    for jr, tr in zip(make(paddle_tpu.dataset), make(paddle_tpu_torch.dataset)):
        j, t = list(jr()), list(tr())
        assert len(t) == len(j) > 0
        assert t == j
    jm, tm = getattr(paddle_tpu.dataset, name), getattr(
        paddle_tpu_torch.dataset, name)
    for fn in ("build_dict", "max_user_id", "max_movie_id", "max_job_id",
               "age_table", "movie_categories", "get_movie_title_dict",
               "get_dict"):
        if hasattr(jm, fn):
            assert getattr(tm, fn)() == getattr(jm, fn)(), fn


# --- the @LEN companions through programs ------------------------------------

def _concat_program(pkg):
    """tests/test_sequence_and_rnn.py:238: sequence_concat packs b's rows
    behind a's valid ones; its lengths companion is the sum's output."""
    layers = pkg.layers
    a = layers.data(name="a", shape=[-1, 2], dtype="float32", lod_level=1)
    b = layers.data(name="b", shape=[-1, 2], dtype="float32", lod_level=1)
    cc = layers.sequence_concat([a, b])
    rng = np.random.RandomState(3)
    feed = {"a": rng.randn(3, 4, 2).astype(np.float32),
            "a@LEN": np.array([2, 4, 1], np.int32),
            "b": rng.randn(3, 4, 2).astype(np.float32),
            "b@LEN": np.array([3, 0, 4], np.int32)}
    return feed, [cc, layers.sequence_pool(cc, "sum"), cc._seq_lengths]


def _lod_reset_static(pkg):
    """tests/test_sequence_and_rnn.py:364: a dense X under target_lod."""
    x = pkg.layers.data(name="lr_x", shape=[1], dtype="float32",
                        append_batch_size=False)
    x.desc.shape = [6, 1]
    out = pkg.layers.lod_reset(x, target_lod=[0, 2, 5, 6])
    feed = {"lr_x": np.arange(6, dtype=np.float32).reshape(6, 1)}
    return feed, [out, out.name + "@LEN"]


def _lod_reset_from_y(pkg):
    """tests/test_sequence_and_rnn.py:388, then a GRU over the new
    partition (the companion it rewrote feeds the next sequence op)."""
    layers = pkg.layers
    x = layers.data(name="lr2_x", shape=[2], dtype="float32", lod_level=1)
    y = layers.data(name="lr2_y", shape=[2], dtype="float32", lod_level=1)
    out = layers.lod_reset(x, y=y)
    hid = layers.dynamic_gru(input=layers.fc(
        input=out, size=9, num_flatten_dims=2), size=3, is_reverse=True)
    rng = np.random.RandomState(4)
    feed = {"lr2_x": rng.randn(3, 4, 2).astype(np.float32),
            "lr2_x@LEN": np.array([3, 1, 4], np.int32),
            "lr2_y": np.zeros((4, 4, 2), np.float32),
            "lr2_y@LEN": np.array([1, 4, 2, 1], np.int32)}
    return feed, [out, out.name + "@LEN", hid]


@pytest.mark.parametrize("build", [_concat_program, _lod_reset_static,
                                   _lod_reset_from_y])
def test_lengths_companions_match_jax(build):
    """The ops that rewrite a lengths companion (sequence_concat,
    lod_reset) in programs built by both packages: the outputs and the
    companions equal, downstream sequence ops reading the new one."""
    got = []
    for pkg in (JAX, PORT):
        main, startup = pkg.fluid.Program(), pkg.fluid.Program()
        main.random_seed = startup.random_seed = 5
        with pkg.unique_name.guard(), pkg.fluid.program_guard(main, startup):
            feed, fetch = build(pkg)
        got.append((main, startup, feed, fetch))
    (jm, js, feed, jfetch), (tm, ts, _, tfetch) = got
    _same_program(tm, jm)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(js, scope=jscope)
    tscope = tfluid.Scope()
    tfluid.params_from_jax(_persistables(jm, jscope), tscope, device="cpu")
    jout = jexe.run(jm, feed=feed, fetch_list=jfetch, scope=jscope)
    tout = tfluid.Executor(tfluid.CPUPlace()).run(
        tm, feed=feed, fetch_list=tfetch, scope=tscope)
    for j, t in zip(jout, tout):
        j, t = np.asarray(j), np.asarray(t)
        assert t.shape == j.shape
        if t.dtype.kind in "iu":
            np.testing.assert_array_equal(t, j)
        else:
            np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)


# --- (b) the chapters -------------------------------------------------------

def _same_program(tp, jp):
    """``to_bytes()`` equal, up to the int32 the JAX package records for a
    var the port keeps int64 (it runs without x64)."""
    if tp.to_bytes() == jp.to_bytes():
        return
    tj, jj = json.loads(tp.to_bytes()), json.loads(jp.to_bytes())
    for tb, jb in zip(tj["blocks"], jj["blocks"]):
        for name, tv in tb["vars"].items():
            jv = jb["vars"].get(name)
            if jv is not None and (jv.get("dtype"), tv.get("dtype")) == (
                    "int32", "int64"):
                jv["dtype"] = "int64"
    assert tj == jj


def _persistables(program, scope):
    return {n: np.asarray(scope.find_var(n))
            for n, v in program.global_block().vars.items()
            if v.persistable and scope.find_var(n) is not None}


def _word2vec(pkg):
    built = chip_smoke.build_word2vec(pkg, emb=32, hidden=64, n=5, lr=5e-3)
    ds = pkg.paddle.dataset.imikolov
    return built, pkg.paddle.batch(ds.train(ds.build_dict(), 5), 64)


def _sentiment_conv(pkg):
    built = chip_smoke.build_sentiment_conv(pkg, emb=32, hid=32, lr=2e-3)
    return built, pkg.paddle.batch(pkg.paddle.dataset.imdb.train(), 32)


def _recommender(pkg):
    built = chip_smoke.build_recommender(pkg, combined=64, lr=0.2)
    return built, pkg.paddle.batch(pkg.paddle.dataset.movielens.train(), 64)


def _srl(pkg):
    built = chip_smoke.build_srl(pkg, word_dim=16, mark_dim=4, hidden=32,
                                 depth=2, lr=1e-2)
    return built, pkg.paddle.batch(pkg.paddle.dataset.conll05.train(), 16)


CTC_FEAT, CTC_CLASSES = 12, 9  # 8 symbols and the blank 0


def _ctc(pkg):
    built = chip_smoke.build_ctc(pkg, feat=CTC_FEAT, classes=CTC_CLASSES,
                                 lr=0.5)
    data = chip_smoke.ctc_samples(7, 40, (6, 15), (1, 4), CTC_FEAT,
                                  CTC_CLASSES)

    def reader():
        for i in range(0, len(data), 8):
            yield data[i:i + 8]

    return built, reader


def _train_alike(build, monkeypatch, tmp_path):
    """Build in both packages, copy the JAX startup's state into the port,
    train STEPS steps on the same batches; the losses, the step-1
    gradient of the shared parameter and, after training, the test
    program's decode on the first batch."""
    monkeypatch.setenv("PADDLE_TPU_DATA", str(tmp_path))  # synthetic data
    (jb, jreader), (tb, treader) = build(JAX), build(PORT)
    for key in ("main", "startup", "test"):
        _same_program(tb[key], jb[key])
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(jb["startup"], scope=jscope)
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    tfluid.params_from_jax(_persistables(jb["main"], jscope), tscope,
                           device="cpu")
    jfeeder = jfluid.DataFeeder(feed_list=jb["feeds"], program=jb["main"])
    tfeeder = tfluid.DataFeeder(feed_list=tb["feeds"], program=tb["main"],
                                place=tfluid.CPUPlace())
    grad = [tb["shared"] + "@GRAD"] if "shared" in tb else []
    out = {"jax": [], "torch": [], "grad": {}}
    batches = list(zip(range(STEPS), jreader(), treader()))
    for i, jbatch, tbatch in batches:
        for side, exe, b, scope, feeder, data in (
                ("jax", jexe, jb, jscope, jfeeder, jbatch),
                ("torch", texe, tb, tscope, tfeeder, tbatch)):
            got = exe.run(b["main"], feed=feeder.feed(data), scope=scope,
                          fetch_list=[b["cost"]] + (grad if i == 0 else []))
            out[side].append(float(np.asarray(got[0]).reshape(-1)[0]))
            if i == 0 and grad:
                out["grad"][side] = np.asarray(got[1])
    assert len(out["torch"]) == STEPS
    np.testing.assert_allclose(out["torch"], out["jax"], rtol=LOSS_RTOL)
    assert all(np.isfinite(out["torch"]))
    if grad:
        g_t, g_j = out["grad"]["torch"], out["grad"]["jax"]
        assert g_t.shape == g_j.shape
        assert np.abs(g_j).max() > 0
        np.testing.assert_allclose(g_t, g_j, rtol=0,
                                   atol=GRAD_TOL * np.abs(g_j).max())
    if "decode" in tb:
        (dj,) = jexe.run(jb["test"], feed=jfeeder.feed(batches[0][1]),
                         scope=jscope, fetch_list=[jb["decode"]])
        (dt,) = texe.run(tb["test"], feed=tfeeder.feed(batches[0][2]),
                         scope=tscope, fetch_list=[tb["decode"]])
        np.testing.assert_array_equal(np.asarray(dt), np.asarray(dj))
        out["decode"] = np.asarray(dt)
    return out


def test_b_word2vec_trains_alike(monkeypatch, tmp_path):
    _train_alike(_word2vec, monkeypatch, tmp_path)


def test_b_sentiment_conv_trains_alike(monkeypatch, tmp_path):
    _train_alike(_sentiment_conv, monkeypatch, tmp_path)


def test_b_recommender_trains_alike(monkeypatch, tmp_path):
    _train_alike(_recommender, monkeypatch, tmp_path)


def test_b_label_semantic_roles_trains_alike(monkeypatch, tmp_path):
    out = _train_alike(_srl, monkeypatch, tmp_path)
    path = out["decode"]
    assert path.min() >= 0 and path.max() < \
        paddle_tpu_torch.dataset.conll05.LABEL_DICT_LEN


def test_b_ctc_program_trains_alike(monkeypatch, tmp_path):
    out = _train_alike(_ctc, monkeypatch, tmp_path)
    assert out["decode"].shape == (8, 1) and (out["decode"] >= 0).all()
