"""The port's data-input stack (``paddle_tpu_torch.reader``,
``.dataset``, ``.batch``; ``fluid.DataFeeder``, ``fluid.readers``, the
reader layers and the executor's reader pre-pass; ``native.recordio``,
``fluid.recordio_writer``) against the JAX package's, on the CPU:

  (a) DataFeeder: dense, reshaped and ragged slots (an empty sequence,
      lengths whose T buckets to 8, 16 and 128; int64 and float32) give
      bitwise the JAX feeder's dict;
  (b) the reader decorators give the same sequences;
  (c) recordio files written by one package read in the other, record
      for record, and the port's writer writes the JAX writer's bytes;
  (d) the synthetic uci_housing, mnist, cifar and imdb readers give
      identical samples;
  (e) a reader program (open_recordio_file -> shuffle(seed) -> batch ->
      multi_pass -> double_buffer -> read_file) has the same bytes and,
      run by both executors, gives identical batches, EOFException at
      the same step, and rewinds on reset_reader;
  (f) fit_a_line through ``paddle_tpu_torch.batch`` + DataFeeder from the
      JAX scope's values: losses within 1e-5 relative over 3 epochs;
  (g) the double buffer's failures reach read_next(), and it needs a
      card unless given the CPU.
"""
import os
import pickle
import random

import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import core as jcore
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid import recordio_writer as jwriter
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.native import recordio as jrio
import paddle_tpu.reader.creator  # noqa: F401
import paddle_tpu_torch
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import core as tcore
from paddle_tpu_torch.fluid import layers as tlayers
from paddle_tpu_torch.fluid import readers as treaders
from paddle_tpu_torch.fluid import recordio_writer as twriter
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.native import recordio as trio
import paddle_tpu_torch.reader.creator  # noqa: F401

LOSS_RTOL = 1e-5
JAX = (paddle_tpu, jfluid, jlayers, junique, jcore)
PORT = (paddle_tpu_torch, tfluid, tlayers, tunique, tcore)


@pytest.fixture(autouse=True)
def synthetic_data(monkeypatch, tmp_path):
    """Both packages read the same (empty) data home: synthetic data."""
    monkeypatch.setenv("PADDLE_TPU_DATA", str(tmp_path / "data"))


def _same(a, b):
    """Bitwise equality of nested samples (arrays, tuples, lists, ints)."""
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b


# --- (a) DataFeeder ---------------------------------------------------

def _feeder_vars(pkg):
    _, fluid, layers, unique_name, _ = pkg
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        out = [layers.data(name="x", shape=[13], dtype="float32"),
               layers.data(name="img", shape=[1, 4, 4], dtype="float32"),
               layers.data(name="label", shape=[1], dtype="int64"),
               layers.data(name="words", shape=[1], dtype="int64",
                           lod_level=1),
               layers.data(name="frames", shape=[3], dtype="float32",
                           lod_level=1)]
    return main, out


@pytest.mark.parametrize("lengths", [[0, 3, 5], [1, 9, 16], [100, 0, 7],
                                     [128, 2, 0]])
def test_a_data_feeder_matches_jax(lengths):
    rng = np.random.RandomState(sum(lengths))
    samples = [(rng.randn(13).astype(np.float32),
                rng.randn(16).astype(np.float32),  # reshaped to [1, 4, 4]
                [int(rng.randint(0, 10))],
                rng.randint(0, 5147, n).tolist(),
                rng.randn(n, 3).astype(np.float32).tolist())
               for n in lengths]
    feeds = []
    for pkg in (JAX, PORT):
        main, feed_list = _feeder_vars(pkg)
        feeds.append(pkg[1].DataFeeder(feed_list=feed_list,
                                       program=main).feed(samples))
    jfeed, tfeed = feeds
    assert sorted(tfeed) == sorted(jfeed) == sorted(
        ["x", "img", "label", "words", "words@LEN", "frames", "frames@LEN"])
    for k in jfeed:
        _same(tfeed[k], jfeed[k])
    T = tfeed["words"].shape[1]
    assert T == max(8, 1 << (max(lengths) - 1).bit_length())
    assert tfeed["img"].shape == (3, 1, 4, 4)
    assert tfeed["frames"].shape == (3, T, 3)
    assert tfeed["words@LEN"].dtype == np.int32


def test_a_data_feeder_refuses_nested_sequences():
    for pkg in (JAX, PORT):
        _, fluid, layers, unique_name, _ = pkg
        main, startup = fluid.Program(), fluid.Program()
        with unique_name.guard(), fluid.program_guard(main, startup):
            v = layers.data(name="s", shape=[1], dtype="int64", lod_level=2)
        with pytest.raises(NotImplementedError, match="lod_level>1"):
            fluid.DataFeeder(feed_list=[v], program=main).feed([([[1]],)])


def test_a_data_feeder_feeds_a_bfloat16_var_as_float32():
    feeds = []
    for pkg in (JAX, PORT):
        _, fluid, layers, unique_name, _ = pkg
        main, startup = fluid.Program(), fluid.Program()
        with unique_name.guard(), fluid.program_guard(main, startup):
            v = layers.data(name="h", shape=[2], dtype="bfloat16")
        feeds.append(fluid.DataFeeder(feed_list=[v], program=main).feed(
            [([1.5, -2.25],), ([3.0, 0.5],)]))
    _same(feeds[1]["h"], feeds[0]["h"])
    assert feeds[1]["h"].dtype == np.float32


# --- (b) reader decorators --------------------------------------------

def _decorated(pkg, name):
    paddle = pkg[0]
    r = paddle.reader
    base = paddle.reader.creator.np_array(np.arange(23).reshape(23, 1))
    other = paddle.reader.creator.np_array(np.arange(100, 123))
    return {
        "batch": paddle.batch(base, 5),
        "batch_drop_last": paddle.batch(base, 5, drop_last=True),
        "shuffle": r.shuffle(base, 7),
        "chain": r.chain(base, other),
        "compose": r.compose(base, other),
        "buffered": r.buffered(base, 3),
        "firstn": r.firstn(base, 9),
        "cache": r.cache(r.shuffle(base, 4)),
        "map_readers": r.map_readers(lambda a, b: a * b, base, other),
        "xmap_readers": r.xmap_readers(lambda v: v * 2, base, 3, 4,
                                       order=True),
    }[name]


@pytest.mark.parametrize("name", [
    "batch", "batch_drop_last", "shuffle", "chain", "compose", "buffered",
    "firstn", "cache", "map_readers", "xmap_readers"])
def test_b_reader_decorators_match_jax(name):
    runs = []
    for pkg in (JAX, PORT):
        reader = _decorated(pkg, name)
        random.seed(1234)
        runs.append([list(reader()) for _ in range(2)])
    _same(runs[1], runs[0])
    if name == "batch_drop_last":
        assert [len(b) for b in runs[1][0]] == [5] * 4
    if name == "cache":  # the second pass replays the first
        _same(runs[1][1], runs[1][0])


def test_b_text_file_and_np_array_creators_match_jax(tmp_path):
    path = tmp_path / "lines.txt"
    path.write_text("first line\n\nthird, with a comma\nlast")
    arr = np.arange(12, dtype=np.float32).reshape(4, 3)
    for creator in ("text_file", "np_array"):
        arg = str(path) if creator == "text_file" else arr
        got = list(getattr(paddle_tpu_torch.reader.creator, creator)(arg)())
        _same(got, list(getattr(paddle_tpu.reader.creator, creator)(arg)()))
        assert len(got) == 4


def test_b_cloud_reader_names_what_it_needs(tmp_path):
    # the reader leases its shards from a master (ported since it pinned a
    # stub): a shard the master hands out but the reader cannot open is
    # named in the error, and its lease is failed back to the master
    from paddle_tpu_torch.distributed.master import MasterService

    missing = str(tmp_path / "missing.recordio")
    svc = MasterService(chunks_per_task=1, lease_timeout=60)
    addr = svc.serve()
    try:
        reader = paddle_tpu_torch.reader.creator.cloud_reader(
            [missing], f"{addr[0]}:{addr[1]}")
        with pytest.raises(OSError, match="missing.recordio"):
            next(reader())
        assert svc.stats()["todo"] == 1 and svc.stats()["pending"] == 0
    finally:
        svc.shutdown()


# --- (c) recordio -----------------------------------------------------

def _records(rng, n):
    return [rng.bytes(int(k)) for k in rng.randint(0, 3000, n)]


def test_c_recordio_files_cross_read(tmp_path):
    rng = np.random.RandomState(0)
    recs = _records(rng, 200)
    paths = {}
    for name, writer in (("port", trio.RecordIOWriter),
                         ("jax_py", jrio._PyWriter),
                         ("jax", jrio.RecordIOWriter)):
        paths[name] = str(tmp_path / f"{name}.rio")
        w = writer(paths[name], 8192)  # small chunks: many of them
        for r in recs:
            w.write(r)
        w.close()
    with open(paths["port"], "rb") as a, open(paths["jax_py"], "rb") as b:
        assert a.read() == b.read()
    for p in paths.values():
        assert trio.read_all(p) == recs
        assert jrio.read_all(p) == recs
    assert list(trio.multi_file_reader([paths["port"], paths["jax"]])) == \
        recs + recs


def test_c_recordio_writer_and_creator_match_jax(tmp_path):
    samples = paddle_tpu_torch.dataset.uci_housing.train()
    tpath, jpath = str(tmp_path / "t.rio"), str(tmp_path / "j.rio")
    assert twriter.convert_reader_to_recordio_file(tpath, samples) == 404
    assert jwriter.convert_reader_to_recordio_file(jpath, samples) == 404
    want = list(samples())
    for path in (tpath, jpath):
        _same(list(paddle_tpu_torch.reader.creator.recordio(path)()), want)
        _same(list(paddle_tpu.reader.creator.recordio(path)()), want)
    shards = twriter.convert_reader_to_recordio_files(
        str(tmp_path / "shard"), 150, samples)
    assert [os.path.basename(s) for s in shards] == \
        ["shard-00000", "shard-00001", "shard-00002"]
    _same([pickle.loads(r) for s in shards for r in jrio.read_all(s)], want)


# --- (d) datasets -----------------------------------------------------

@pytest.mark.parametrize("name,split,n", [
    ("uci_housing", "train", 404), ("uci_housing", "test", 102),
    ("mnist", "train", 2048), ("mnist", "test", 2048),
    ("cifar", "train10", 1024), ("cifar", "test100", 1024),
    ("imdb", "train", 512), ("imdb", "test", 512)])
def test_d_synthetic_datasets_match_jax(name, split, n):
    jr = getattr(getattr(paddle_tpu.dataset, name), split)()
    tr = getattr(getattr(paddle_tpu_torch.dataset, name), split)()
    got = list(tr())
    assert len(got) == n
    _same(got, list(jr()))
    if name == "imdb":
        lengths = [len(s) for s, _ in got]
        assert min(lengths) >= 8 and max(lengths) <= 119
        assert max(max(s) for s, _ in got) < \
            paddle_tpu_torch.dataset.imdb.VOCAB_SIZE == 5147


# --- (e) the reader program -------------------------------------------

def _sample_file(path):
    rng = np.random.RandomState(4)

    def samples():
        for _ in range(23):
            yield (rng.randint(0, 256, 12).astype(np.uint8),
                   rng.randint(0, 10, (1,)).astype(np.int64),
                   rng.randint(0, 50, rng.randint(1, 20)).astype(np.int64))

    jwriter.convert_reader_to_recordio_file(path, samples)


def _reader_program(pkg, path, batch_size=4):
    _, fluid, layers, unique_name, _ = pkg
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        r = layers.open_recordio_file(
            path, shapes=[[3, 2, 2], [1], [-1]], lod_levels=[0, 0, 1],
            dtypes=["float32", "int64", "int64"])
        r = layers.shuffle(r, buffer_size=8, seed=17)
        r = layers.batch(r, batch_size=batch_size)
        r = layers.multi_pass(r, pass_num=2)
        r = layers.double_buffer(r, capacity=2)
        img, label, seq = layers.read_file(r)
    return main, startup, r, [img, label, seq, seq.name + "@LEN"]


def _drain(pkg, main, startup, fetch, place, limit=100):
    _, fluid, _, _, core = pkg
    exe, scope = fluid.Executor(place), fluid.Scope()
    exe.run(startup, scope=scope)
    out = []
    with pytest.raises(core.EOFException):
        for _ in range(limit):
            out.append([np.asarray(v) for v in
                        exe.run(main, fetch_list=fetch, scope=scope)])
    return out, exe, scope


def test_e_reader_program_runs_like_jax(tmp_path):
    path = str(tmp_path / "s.rio")
    _sample_file(path)
    jm, js, jr, jfetch = _reader_program(JAX, path)
    tm, ts, tr, tfetch = _reader_program(PORT, path)
    assert tm.to_bytes() == jm.to_bytes()
    assert ts.to_bytes() == js.to_bytes()
    jout, jexe, jscope = _drain(JAX, jm, js, jfetch, jfluid.CPUPlace())
    tout, texe, tscope = _drain(PORT, tm, ts, tfetch, tfluid.CPUPlace())
    # rewound, each reads again: the shuffle's generator goes on, so the
    # first batch after the rewind is the JAX package's, not the first's
    jlayers.reset_reader(jr, jscope)
    tlayers.reset_reader(tr, tscope)
    jout.append([np.asarray(v) for v in
                 jexe.run(jm, fetch_list=jfetch, scope=jscope)])
    tout.append([np.asarray(v) for v in
                 texe.run(tm, fetch_list=tfetch, scope=tscope)])
    # 23 samples a pass in batches of 4 (the last of 3), two passes, and
    # one batch after the rewind
    assert len(tout) == len(jout) == 13
    for tb, jb in zip(tout, jout):
        for t, j in zip(tb, jb):
            if t.dtype == np.int64:  # the JAX package runs without x64
                assert j.dtype == np.int32
                t = t.astype(np.int32)
            _same(t, j)
    img, label, seq, lens = tout[0]
    assert img.dtype == np.float32 and img.shape == (4, 3, 2, 2)
    assert label.dtype == np.int64 and seq.dtype == np.int64
    assert lens.dtype == np.int32 and seq.shape == (4, lens.max())


def _classifier(path):
    """A softmax classifier fed by a recordio pipeline (``path``) or, with
    ``path`` None, by data vars; the same parameter names either way."""
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 2
    with tunique.guard(), tfluid.program_guard(main, startup):
        if path:
            r = tlayers.open_recordio_file(
                path, shapes=[[3, 2, 2], [1], [-1]], lod_levels=[0, 0, 1],
                dtypes=["float32", "int64", "int64"])
            r = tlayers.batch(r, batch_size=5, drop_last=True)
            img, label, _ = tlayers.read_file(r)
        else:
            img = tlayers.data(name="img", shape=[3, 2, 2], dtype="float32")
            label = tlayers.data(name="label", shape=[1], dtype="int64")
        cost = tlayers.mean(tlayers.softmax_with_cross_entropy(
            tlayers.fc(img, size=10), label))
        tfluid.optimizer.SGD(0.1).minimize(cost)
    return main, startup, cost


def test_e_reader_feeds_a_training_step_like_a_dict(tmp_path):
    """Batches from the pipeline and the same batches from feed dicts give
    bitwise the same losses and state; the executor conforms the records'
    flat uint8 images to the slot's [3, 2, 2] float32."""
    path = str(tmp_path / "s.rio")
    _sample_file(path)
    main, startup, cost = _classifier(path)
    dmain, _, dcost = _classifier(None)
    exe = tfluid.Executor(tfluid.CPUPlace())
    s1, s2 = tfluid.Scope(), tfluid.Scope()
    exe.run(startup, scope=s1)
    params = [p.name for p in main.global_block().all_parameters()]
    assert params == [p.name for p in dmain.global_block().all_parameters()]
    for n in s1.var_names():  # the parameters and the learning rate
        if isinstance(s1.find_var(n), torch.Tensor):
            s2.set_var(n, s1.find_var(n).clone())
    samples = [pickle.loads(x) for x in trio.read_all(path)]
    for step in range(4):
        (l1,) = exe.run(main, fetch_list=[cost], scope=s1)
        batch = samples[5 * step:5 * step + 5]
        feed = {"img": np.stack([s[0] for s in batch]).reshape(
                    5, 3, 2, 2).astype(np.float32),
                "label": np.stack([s[1] for s in batch])}
        (l2,) = exe.run(dmain, feed=feed, fetch_list=[dcost], scope=s2)
        np.testing.assert_array_equal(l1, l2)
    for n in params:
        assert torch.equal(s1.find_var(n), s2.find_var(n)), n
    with pytest.raises(tcore.EOFException):
        exe.run(main, fetch_list=[cost], scope=s1)


# --- (f) fit_a_line through the feeder --------------------------------

def _fit_a_line(pkg):
    """tests/test_fit_a_line.py's program."""
    _, fluid, layers, unique_name, _ = pkg
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data(name="x", shape=[13], dtype="float32")
        y = layers.data(name="y", shape=[1], dtype="float32")
        y_predict = layers.fc(input=x, size=1, act=None)
        cost = layers.square_error_cost(input=y_predict, label=y)
        avg_cost = layers.mean(cost)
        fluid.optimizer.SGD(learning_rate=0.01).minimize(avg_cost)
    return main, startup, avg_cost, [x, y]


def test_f_fit_a_line_through_batch_and_feeder_matches_jax():
    jm, js, jcost, jvars = _fit_a_line(JAX)
    tm, ts, tcost, tvars = _fit_a_line(PORT)
    assert tm.to_bytes() == jm.to_bytes()
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    tfluid.params_from_jax(
        {n: np.asarray(jscope.find_var(n))
         for n, v in jm.global_block().vars.items()
         if v.persistable and jscope.find_var(n) is not None},
        tscope, device="cpu")
    losses = {}
    for side, paddle, fluid, exe, prog, cost, scope, feed_vars in (
            ("jax", paddle_tpu, jfluid, jexe, jm, jcost, jscope, jvars),
            ("torch", paddle_tpu_torch, tfluid, texe, tm, tcost, tscope,
             tvars)):
        reader = paddle.batch(paddle.reader.shuffle(
            paddle.dataset.uci_housing.train(), buf_size=500), batch_size=20)
        feeder = fluid.DataFeeder(place=fluid.CPUPlace(), feed_list=feed_vars,
                                  program=prog)
        random.seed(7)
        losses[side] = [
            float(np.asarray(exe.run(prog, feed=feeder.feed(data),
                                     fetch_list=[cost], scope=scope)[0])[0])
            for _ in range(3) for data in reader()]
    assert len(losses["torch"]) == 3 * 21
    np.testing.assert_allclose(losses["torch"], losses["jax"],
                               rtol=LOSS_RTOL)
    assert losses["torch"][-1] < losses["torch"][0] / 10


# --- (g) the double buffer --------------------------------------------

class _List(treaders.HostReader):
    def __init__(self, items):
        self._items, self._i = items, 0

    def read_next(self):
        if self._i >= len(self._items):
            raise StopIteration
        self._i += 1
        return self._items[self._i - 1]

    def reset(self):
        self._i = 0


def test_g_double_buffer_hands_over_cpu_tensors_and_surfaces_failures(
        monkeypatch):
    items = [(np.full((2, 3), i, np.uint8),
              (np.arange(4, dtype=np.int64).reshape(2, 2),
               np.array([2, 1], np.int32)))
             for i in range(3)]
    slots = [{"shape": [-1, 3], "dtype": "float32", "lod_level": 0},
             {"shape": [-1, -1], "dtype": "int64", "lod_level": 1}]
    db = treaders.DoubleBufferReader(_List(items), slots=slots, device="cpu")
    try:
        got = db.read_next()
        assert isinstance(got, treaders.DeviceBatch) and got.ready is None
        assert got[0].dtype == torch.float32 and got[1][1].dtype == \
            torch.int32
        assert [t.shape for t in got.tensors()] == [(2, 3), (2, 2), (2,)]
        assert [float(db.read_next()[0][0, 0]) for _ in range(2)] == [1, 2]
        with pytest.raises(StopIteration):
            db.read_next()

        def fail(sample):
            raise RuntimeError("transfer failed")

        monkeypatch.setattr(db, "_to_device", fail)
        db.reset()
        for _ in range(2):  # raised again until reset
            with pytest.raises(RuntimeError, match="transfer failed"):
                db.read_next()
    finally:
        db.close()


def test_g_double_buffer_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        treaders.DoubleBufferReader(_List([]))


def test_g_transport_ops_still_refused():
    """The plain Executor runs the transport ops now
    (tests/test_torch_pserver.py); one that sends a var with no value is
    refused before any RPC, and the ParallelExecutor refuses them all."""
    main = tfluid.Program()
    main.global_block().append_op(type="send", inputs={"X": ["g"]},
                                  outputs={})
    with pytest.raises(RuntimeError, match="send op: var 'g' has no value"):
        tfluid.Executor("cpu").run(main)
    with pytest.raises(NotImplementedError, match="parameter-server"):
        tfluid.ParallelExecutor(use_cuda=False, main_program=main)
