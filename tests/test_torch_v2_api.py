"""The port's v2 API (``init``, ``create``, ``Parameters``, ``SGD`` and its
events, ``infer``, ``Topology``, ``trainer_cli``, ``plot``,
``master.client``) against the JAX package's, on the CPU:

  - tests/test_v2_api.py's fit_a_line event loop in both packages from
    the same parameters and the same reader order (no shuffle): every
    iteration's cost within rtol 2e-5, the same event counts, the costs
    falling 3x, and ``infer`` on 8 test samples within rtol/atol 1e-5;
  - the DSL-surface LSTM/GRU classifier trained with Adam for 6 batches
    in both packages from the same parameters: costs within rtol 2e-5;
  - the parameters' tar, written by either package and read by the other:
    every array equal;
  - ``Topology`` serialize -> deserialize -> run in a fresh scope with
    transplanted parameters, as tests/test_v2_api.py does;
  - ``trainer_cli`` and ``plot`` as tests/test_v2_api.py:197-262 drive
    them, the submodule surface, and ``v2.master.client`` on the cases of
    tests/test_distributed.py's v2 master client tests.
"""
import pickle

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu.v2 as jv2
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import unique_name as junique
import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.v2 as tv2
from paddle_tpu_torch.distributed.master import MasterService
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.fluid.recordio_writer import (
    convert_reader_to_recordio_file,
)
from paddle_tpu_torch.v2.master import client as v2c

RTOL = 2e-5
JAX = (jfluid, jv2, junique, jframework)
PORT = (tfluid, tv2, tunique, tframework)


def _in_world(pkg, body):
    """``body(paddle)`` inside a fresh scope, programs and name guard of
    ``pkg``, with the v2 device set to the CPU."""
    fluid, paddle, unique, fw = pkg
    main, startup, scope = fw.Program(), fw.Program(), fluid.Scope()
    with fluid.scope_guard(scope), fw.program_guard(main, startup), \
            unique.guard():
        paddle.init(use_gpu=False, trainer_count=1)
        return body(paddle)


def _copy_params(dst, values):
    assert sorted(dst.names()) == sorted(values)
    for n, v in values.items():
        dst.set(n, v)


def _fit_a_line(paddle, values=None):
    """tests/test_v2_api.py::test_v2_fit_a_line_event_loop's topology and
    loop, without the shuffle; ``values`` overrides the parameters."""
    x = paddle.layer.data(name="x",
                          type=paddle.layer.data_type.dense_vector(13))
    y = paddle.layer.data(name="y",
                          type=paddle.layer.data_type.dense_vector(1))
    pred = paddle.layer.fc_layer(input=x, size=1)
    cost = paddle.layer.square_error_cost(input=pred, label=y)
    parameters = paddle.create(cost)
    if values is not None:
        _copy_params(parameters, values)
    start = {n: parameters.get(n).copy() for n in parameters.names()}
    trainer = paddle.SGD(cost=cost, parameters=parameters,
                         update_equation=paddle.optimizer.Momentum(
                             momentum=0.9, learning_rate=1e-2))
    events = {"begin_pass": 0, "begin_iter": 0, "passes": 0, "costs": []}

    def handler(e):
        if isinstance(e, paddle.event.BeginPass):
            events["begin_pass"] += 1
        elif isinstance(e, paddle.event.BeginIteration):
            events["begin_iter"] += 1
        elif isinstance(e, paddle.event.EndIteration):
            events["costs"].append(e.cost)
        elif isinstance(e, paddle.event.EndPass):
            events["passes"] += 1

    trainer.train(reader=paddle.batch(paddle.dataset.uci_housing.train(),
                                      batch_size=32),
                  num_passes=3, event_handler=handler,
                  feeding={"x": 0, "y": 1})
    samples = [s for _, s in zip(range(8),
                                 paddle.dataset.uci_housing.test()())]
    out = paddle.infer(output_layer=pred, parameters=parameters,
                       input=[(s[0],) for s in samples], feeding={"x": 0})
    test = trainer.test(reader=paddle.batch(
        paddle.dataset.uci_housing.test(), batch_size=32),
        feeding={"x": 0, "y": 1})
    return start, events, out, test.cost


def test_fit_a_line_event_loop_matches_jax():
    start, tev, tout, ttest = _in_world(PORT, _fit_a_line)
    _, jev, jout, jtest = _in_world(JAX, lambda p: _fit_a_line(p, start))
    assert tev["passes"] == jev["passes"] == 3
    assert tev["begin_pass"] == jev["begin_pass"] == 3
    assert tev["begin_iter"] == jev["begin_iter"] == len(tev["costs"]) > 10
    assert len(tev["costs"]) == len(jev["costs"])
    np.testing.assert_allclose(tev["costs"], jev["costs"], rtol=RTOL)
    assert tev["costs"][-1] < tev["costs"][0] / 3
    assert tout.shape == (8, 1) and np.isfinite(tout).all()
    np.testing.assert_allclose(tout, np.asarray(jout), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ttest, jtest, rtol=RTOL)


def _dsl_surface(paddle, values=None):
    """tests/test_v2_api.py::test_v2_layer_dsl_surface's classifier, one
    pass over 6 seeded batches."""
    words = paddle.layer.data(
        name="words",
        type=paddle.layer.data_type.integer_value_sequence(100),
        lod_level=1)
    label = paddle.layer.data(
        name="label", type=paddle.layer.data_type.integer_value(2))
    emb = paddle.layer.embedding_layer(input=words, size=16)
    lstm = paddle.layer.simple_lstm(input=emb, size=8)
    gru = paddle.layer.simple_gru(input=emb, size=8)
    merged = paddle.layer.concat_layer(
        [paddle.layer.last_seq(input=lstm),
         paddle.layer.pooling_layer(input=gru,
                                    pooling_type=paddle.pooling.Max())],
        axis=1)
    hid = paddle.layer.fc_layer(input=merged, size=16,
                                act=paddle.activation.Relu())
    prob = paddle.layer.fc_layer(input=hid, size=2,
                                 act=paddle.activation.Softmax())
    cost = paddle.layer.classification_cost(input=prob, label=label)
    parameters = paddle.create(cost)
    if values is not None:
        _copy_params(parameters, values)
    start = {n: parameters.get(n).copy() for n in parameters.names()}
    trainer = paddle.SGD(cost=cost, parameters=parameters,
                         update_equation=paddle.optimizer.Adam(
                             learning_rate=5e-3))
    rng = np.random.RandomState(0)
    batches = []
    for _ in range(6):
        batch = []
        for _ in range(16):
            w = rng.randint(3, 100, size=int(rng.randint(3, 9))).tolist()
            batch.append((w, [int(w[0] % 2)]))
        batches.append(batch)
    costs = []
    trainer.train(reader=lambda: iter(batches), num_passes=1,
                  event_handler=lambda e: costs.append(e.cost)
                  if isinstance(e, paddle.event.EndIteration) else None)
    return start, costs


def test_dsl_surface_training_matches_jax():
    start, tcosts = _in_world(PORT, _dsl_surface)
    _, jcosts = _in_world(JAX, lambda p: _dsl_surface(p, start))
    assert len(tcosts) == 6 and np.isfinite(tcosts).all()
    np.testing.assert_allclose(tcosts, jcosts, rtol=RTOL)


def _tar_params(paddle, values=None):
    x = paddle.layer.data(name="x",
                          type=paddle.layer.data_type.dense_vector(4))
    pred = paddle.layer.fc_layer(input=x, size=3)
    params = paddle.create(pred)
    if values is not None:
        _copy_params(params, values)
    return params


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_parameters_tar_round_trip_between_packages(tmp_path, writer):
    """A tar written by one package loads in the other: numpy arrays by
    name, equal."""
    rng = np.random.RandomState(3)
    values = {"fc_0.w_0": rng.randn(4, 3).astype(np.float32),
              "fc_0.w_1": rng.randn(3).astype(np.float32)}
    src, dst = (PORT, JAX) if writer == "port" else (JAX, PORT)
    path = tmp_path / "params.tar"

    def write(paddle):
        params = _tar_params(paddle, values)
        with open(path, "wb") as f:
            params.to_tar(f)

    _in_world(src, write)
    with open(path, "rb") as f:
        raw = pickle.load(f)
    assert all(type(v) is np.ndarray for v in raw.values())

    def read(paddle):
        x = paddle.layer.data(name="x",
                              type=paddle.layer.data_type.dense_vector(4))
        pred = paddle.layer.fc_layer(input=x, size=3)
        with open(path, "rb") as f:
            params = paddle.Parameters.from_tar(f, pred)
        return {n: params.get(n) for n in params.names()}

    got = _in_world(dst, read)
    assert sorted(got) == sorted(values)
    for n, v in values.items():
        np.testing.assert_array_equal(np.asarray(got[n]), v)


def test_topology_serialize_roundtrip(tmp_path):
    """DSL -> serialize -> deserialize -> run in a fresh scope with
    transplanted parameters (tests/test_v2_api.py's topology test)."""
    main, startup = tframework.Program(), tframework.Program()
    scope = tfluid.Scope()
    xin = np.random.RandomState(1).rand(3, 4).astype(np.float32)
    with tfluid.scope_guard(scope):
        with tframework.program_guard(main, startup), tunique.guard():
            x = tv2.layer.data(name="x",
                               type=tv2.layer.data_type.dense_vector(4))
            label = tv2.layer.data(
                name="label", type=tv2.layer.data_type.integer_value(2))
            h = tv2.layer.fc_layer(input=x, size=8,
                                   act=tv2.activation.Tanh())
            out = tv2.layer.fc_layer(input=h, size=2,
                                     act=tv2.activation.Softmax())
            cost = tv2.layer.classification_cost(input=out, label=label)
            parameters = tv2.create(cost, device="cpu")
            tfluid.optimizer.Adam(learning_rate=1e-3).minimize(cost)
            topo = tv2.Topology(out)
            assert topo.data_names() == ["x"]
            assert topo.output_names() == [out.name]
            ship = [op.desc.type
                    for op in topo.main_program.global_block().ops]
            assert "cross_entropy" not in ship and "adam" not in ship
            assert not any(o.endswith("_grad") for o in ship)
            blob = topo.serialize()
        exe = tfluid.Executor(tfluid.CPUPlace())
        (expect,) = exe.run(topo.main_program, feed={"x": xin},
                            fetch_list=topo.layers)
    topo2 = tv2.Topology.deserialize(blob)
    scope2 = tfluid.Scope()
    with tfluid.scope_guard(scope2):
        exe2 = tfluid.Executor(tfluid.CPUPlace())
        exe2.run(topo2.startup_program)
        fresh = tv2.Parameters(scope2, topo2.main_program,
                               topo2.startup_program, device="cpu")
        for name in parameters.names():
            fresh.set(name, parameters.get(name))
        (got,) = exe2.run(topo2.main_program, feed={"x": xin},
                          fetch_list=topo2.layers)
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-6)


def test_trainer_cli(tmp_path, capsys):
    """paddle_trainer-style CLI: config file in, passes + checkpoints
    out; ``--use_gpu 0`` for this machine."""
    from paddle_tpu_torch.v2 import trainer_cli

    cfg = tmp_path / "config.py"
    cfg.write_text(
        "import numpy as np\n"
        "import paddle_tpu_torch.v2 as paddle\n"
        "x = paddle.layer.data(name='x', type=paddle.layer.data_type"
        ".dense_vector(4))\n"
        "y = paddle.layer.data(name='y', type=paddle.layer.data_type"
        ".dense_vector(1))\n"
        "pred = paddle.layer.fc_layer(input=x, size=1)\n"
        "cost = paddle.layer.square_error_cost(input=pred, label=y)\n"
        "optimizer = paddle.optimizer.Momentum(learning_rate=0.05)\n"
        "_w = np.arange(4).astype('float32').reshape(4, 1)\n"
        "_rng = np.random.RandomState(0)\n"
        "def train_reader():\n"
        "    for _ in range(8):\n"
        "        xb = _rng.rand(8, 4).astype('float32')\n"
        "        yield [(xb[i], xb[i] @ _w) for i in range(8)]\n"
        "test_reader = train_reader\n"
    )
    main, startup = tframework.Program(), tframework.Program()
    with tfluid.scope_guard(tfluid.Scope()), \
            tframework.program_guard(main, startup), tunique.guard():
        rc = trainer_cli.main([
            "--config", str(cfg), "--num-passes", "2", "--use_gpu", "0",
            "--save-dir", str(tmp_path / "ckpt"), "--log-period", "4",
        ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "pass 0 batch 0" in out and "test cost" in out
    assert (tmp_path / "ckpt" / "params_pass_1.tar").exists()
    tests = [float(line.split()[-1]) for line in out.splitlines()
             if "test cost" in line]
    assert tests[-1] < tests[0]
    # the tar holds numpy arrays by name, as the JAX package's does
    with open(tmp_path / "ckpt" / "params_pass_1.tar", "rb") as f:
        saved = pickle.load(f)
    assert sorted(saved) == ["fc_0.w_0", "fc_0.w_1"]


def test_ploter(capsys, monkeypatch):
    """Series accumulate; DISABLE_PLOT (or no matplotlib) degrades to
    text."""
    from paddle_tpu_torch.v2.plot import Ploter

    p = Ploter("train cost", "test cost")
    for i in range(3):
        p.append("train cost", i, 1.0 / (i + 1))
    p.append("test cost", 0, 0.5)
    assert p.data("train cost")[1][0] == 1.0
    with pytest.raises(KeyError):
        p.append("bogus", 0, 0.0)
    monkeypatch.setenv("DISABLE_PLOT", "True")
    p.plot()
    out = capsys.readouterr().out
    assert "train cost" in out and "3 points" in out
    p.reset()
    assert p.data("train cost") == ([], [])


def test_package_submodule_surface():
    for name in ("attr", "data_type", "evaluator", "event", "image",
                 "layer", "minibatch", "networks", "op", "optimizer",
                 "plot", "topology", "data_feeder"):
        assert hasattr(tv2, name), name
    assert tv2.attr.ParamAttr is tfluid.ParamAttr
    assert tv2.minibatch.batch is tv2.batch
    im = (np.arange(24 * 32 * 3) % 255).reshape(24, 32, 3).astype(np.uint8)
    for a, b in ((tv2.image.resize_short(im, 16),
                  jv2.image.resize_short(im, 16)),
                 (tv2.image.simple_transform(im, 20, 16, is_train=False,
                                             mean=[1.0, 2.0, 3.0]),
                  jv2.image.simple_transform(im, 20, 16, is_train=False,
                                             mean=[1.0, 2.0, 3.0]))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tv2.image.left_right_flip(im)[:, 0],
                                  im[:, -1])


# --- v2.master.client (tests/test_distributed.py's v2 master client cases) --

def _shards(tmp_path, prefix, rows):
    paths = []
    for i, r in enumerate(rows):
        p = str(tmp_path / f"{prefix}_{i}.recordio")
        convert_reader_to_recordio_file(p, lambda r=r: iter(r))
        paths.append(p)
    return paths


def _drain(c):
    got = []
    while True:
        r = c.next_record()
        if r is None:
            return got
        got.append(pickle.loads(r))


def test_master_client_facade(tmp_path):
    (p,) = _shards(tmp_path, "v2m", [range(5)])
    svc = MasterService(chunks_per_task=1, lease_timeout=60)
    addr = svc.serve()
    try:
        c = v2c(f"{addr[0]}:{addr[1]}", timeout_sec=5)
        c.set_dataset([p])
        assert sorted(_drain(c)) == [0, 1, 2, 3, 4]
        assert c.request_save_model(0, 100) == 1
        assert c.request_save_model(1, 100) == 0
        c.release()
    finally:
        svc.shutdown()


def test_master_client_buf_size_prefetch(tmp_path):
    """buf_size > 0 prefetches through a bounded queue; every record
    arrives once a pass; abandoning a pass neither deadlocks nor streams
    the rest; a new dataset retires the old pump."""
    import time

    shards = _shards(tmp_path, "buf",
                     [[i * 10 + j for j in range(4)] for i in range(3)])
    svc = MasterService(chunks_per_task=1, lease_timeout=60)
    addr = svc.serve()
    try:
        c = v2c(addr, buf_size=2)
        c.set_dataset(shards)
        assert c._pump is not None and c._pump.q.maxsize == 2
        pass0 = _drain(c)
        assert sorted(pass0) == sorted(i * 10 + j for i in range(3)
                                       for j in range(4))
        assert c.next_record() is None and c.next_record() is None
        c.paddle_start_get_records(1)
        assert sorted(_drain(c)) == sorted(pass0)
        c.paddle_start_get_records(2)
        assert c.next_record() is not None
        t0 = time.monotonic()
        c.paddle_start_get_records(3)
        assert time.monotonic() - t0 < 2.0, "abandon streamed the pass"
        assert c.next_record() is not None
        assert svc.stats()["dropped"] == 0
        c.set_dataset(_shards(tmp_path, "buf2", [
            [100 + i * 10 + j for j in range(4)] for i in range(2)]))
        assert sorted(_drain(c)) == [100, 101, 102, 103, 110, 111, 112, 113]
        c.release()
    finally:
        svc.shutdown()


def test_master_client_prefetch_error_surfaces(tmp_path):
    """A reader error inside the prefetch pump re-raises from
    next_record() instead of reading as an end of pass."""
    (good,) = _shards(tmp_path, "good", [range(4)])
    corrupt = str(tmp_path / "corrupt.recordio")
    with open(corrupt, "wb") as f:
        f.write(b"\x00not a recordio file\xff" * 16)
    svc = MasterService(chunks_per_task=2, lease_timeout=60, failure_max=1)
    addr = svc.serve()
    try:
        c = v2c(addr, buf_size=4)
        c.set_dataset([corrupt, good])
        with pytest.raises(Exception):
            while c.next_record() is not None:
                pass
        c.release()
    finally:
        svc.shutdown()


def test_master_client_timeout_reaches_the_socket():
    import socket

    silent = socket.socket()
    silent.bind(("127.0.0.1", 0))
    silent.listen(8)
    try:
        fc = v2c(silent.getsockname(), timeout_sec=3)
        assert fc._client._timeout == 3.0
    finally:
        silent.close()
