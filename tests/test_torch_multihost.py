"""The port's multi-host environment (``paddle_tpu_torch/distributed/
env.py``) and the ParallelExecutor's multi-host form, against the JAX
package on the CPU; and ``reader.creator.cloud_reader`` against the JAX
package's.

A gloo world of 2 spawned CPU ranks, started by
``init_distributed(device="cpu")``, trains fc(4 -> 1) + SGD through a
ParallelExecutor over ``global_mesh({"dp": 2})``, each rank feeding its
local shard; the same ranks then start a world the way a launcher does
and feed the global batch. Both start from the JAX startup's state
(``.npz``). Tolerances: the local-shard losses within MULTIHOST_TOL of
the JAX package's single-process run on the concatenated global batch
(the JAX multi-host test's own contract), and within FORMS_TOL of the
port's global-batch form (the same sums in another order). This file
imports only numpy, torch and pytest at the top, so the ranks never
import jax."""
import os
import socket

import numpy as np
import pytest
import torch

MULTIHOST_TOL = 1e-4
FORMS_TOL = 1e-6
STEPS = 4


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _batches():
    rng = np.random.RandomState(11)
    x = rng.rand(16, 4).astype(np.float32)
    y = (x @ np.array([[1.0], [2.0], [-1.0], [0.5]], np.float32))
    return x, y.astype(np.float32)


def _build(fluid, layers, unique_name):
    with unique_name.guard():
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 11
        with fluid.program_guard(main, startup):
            x = layers.data(name="x", shape=[4], dtype="float32")
            y = layers.data(name="y", shape=[1], dtype="float32")
            pred = layers.fc(input=x, size=1,
                             param_attr=fluid.ParamAttr(name="mh.w"),
                             bias_attr=fluid.ParamAttr(name="mh.b"))
            cost = layers.mean(layers.square_error_cost(input=pred, label=y))
            fluid.optimizer.SGD(learning_rate=0.1).minimize(cost)
    return main, startup, cost


def _train(rank, init, feed_fn):
    """STEPS ParallelExecutor steps over dp=2 from `init`; the losses."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.distributed import global_mesh
    from paddle_tpu_torch.fluid import layers, unique_name

    main, startup, cost = _build(fluid, layers, unique_name)
    scope = fluid.Scope()
    fluid.Executor("cpu").run(startup, scope=scope)
    for n, v in init.items():
        scope.set_var(n, torch.tensor(v))
    with fluid.scope_guard(scope):
        pe = fluid.ParallelExecutor(main_program=main, loss_name=cost.name,
                                    mesh=global_mesh({"dp": 2}, "cpu"),
                                    device="cpu")
        out = []
        for step in range(STEPS):
            (loss,) = pe.run(fetch_list=[cost], feed=feed_fn(step))
            out.append(float(np.ravel(loss)[0]))
    return out, pe


def _rank(rank, addrs, init_path, out_dir):
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.fluid.enforce import EnforceNotMet

    init = dict(np.load(init_path))
    x, y = _batches()
    lo, hi = 8 * rank, 8 * (rank + 1)
    result = {}
    info = env.init_distributed(coordinator_address=addrs[0],
                                num_processes=2, process_id=rank,
                                device="cpu")
    assert info == {"process_id": rank, "num_processes": 2,
                    "local_device_count": 1, "global_device_count": 2}
    assert env.feeds_local_shards()
    local, pe = _train(rank, init,
                       lambda s: {"x": x[lo:hi], "y": y[lo:hi]})
    result["local"] = local
    # the ranks feed local batches of 3 and 4 rows: refused on both
    n = 3 + rank
    try:
        pe.run(fetch_list=[pe._loss_name],
               feed={"x": x[lo:lo + n], "y": y[lo:lo + n]})
        result["uneven"] = "ran"
    except EnforceNotMet as e:
        result["uneven"] = str(e)
    dist.destroy_process_group()
    # a world from a launcher: every rank feeds the same global batch
    dist.init_process_group("gloo", init_method=f"tcp://{addrs[1]}",
                            world_size=2, rank=rank)
    assert not env.feeds_local_shards()
    result["global"], _ = _train(rank, init, lambda s: {"x": x, "y": y})
    dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             local=result["local"], glob=result["global"],
             uneven=np.array(result["uneven"]))


def test_local_shards_match_the_jax_global_batch(tmp_path):
    import torch.multiprocessing as mp

    import paddle_tpu.fluid as jfluid
    from paddle_tpu.fluid import layers as jlayers
    from paddle_tpu.fluid import unique_name as juname

    from paddle_tpu_torch.mesh.selftest import join_world

    main, startup, cost = _build(jfluid, jlayers, juname)
    scope = jfluid.Scope()
    exe = jfluid.Executor()
    exe.run(startup, scope=scope)
    init = {n: np.asarray(scope.find_var(n)) for n in ("mh.w", "mh.b")}
    init_path = str(tmp_path / "init.npz")
    np.savez(init_path, **init)
    x, y = _batches()
    ref = [float(np.ravel(exe.run(main, feed={"x": x, "y": y},
                                  fetch_list=[cost], scope=scope)[0])[0])
           for _ in range(STEPS)]
    addrs = [f"127.0.0.1:{_free_port()}", f"127.0.0.1:{_free_port()}"]
    ctx = mp.spawn(_rank, args=(addrs, init_path, str(tmp_path)),
                   nprocs=2, join=False)
    join_world(ctx, 240)
    got = [np.load(str(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for r in range(2):
        np.testing.assert_allclose(got[r]["local"], ref,
                                   rtol=MULTIHOST_TOL, atol=MULTIHOST_TOL)
        np.testing.assert_allclose(got[r]["local"], got[r]["glob"],
                                   rtol=FORMS_TOL, atol=FORMS_TOL)
        msg = str(got[r]["uneven"])
        assert "local batches of 3 to 4 rows" in msg, msg
        assert "pad the local batch or use drop_last" in msg
    assert list(got[0]["local"]) == list(got[1]["local"])
    assert ref[-1] < ref[0]


def test_single_process_init_is_a_no_op(monkeypatch):
    import torch.distributed as dist

    from paddle_tpu_torch.distributed import env

    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    monkeypatch.setenv("NUM_PROCESSES", "1")
    was = dist.is_initialized()
    info = env.init_distributed(device="cpu")
    assert info == {"process_id": 0, "num_processes": 1,
                    "local_device_count": 1, "global_device_count": 1}
    assert dist.is_initialized() == was and not env.feeds_local_shards()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        env.init_distributed()


@pytest.mark.parametrize("server", ["jax", "port"])
def test_cloud_reader_delivers_the_same_records_as_jax(tmp_path, server):
    import paddle_tpu.distributed.master as jmaster
    from paddle_tpu.reader import creator as jcreator

    import paddle_tpu_torch.distributed.master as tmaster
    from paddle_tpu_torch.fluid.recordio_writer import (
        convert_reader_to_recordio_file)
    from paddle_tpu_torch.reader import creator as tcreator

    shards = []
    for i in range(4):
        p = str(tmp_path / f"cloud_{i}.recordio")
        convert_reader_to_recordio_file(
            p, lambda i=i: iter([(i, j) for j in range(5)]))
        shards.append(p)
    master = {"jax": jmaster, "port": tmaster}[server]
    svc = master.MasterService(chunks_per_task=1, lease_timeout=60)
    addr = svc.serve()
    try:
        ep = f"{addr[0]}:{addr[1]}"
        passes = {}
        for name, creator in (("port", tcreator), ("jax", jcreator)):
            # each reader() call is a pass: the first registers the
            # dataset, later ones start a new pass on the exhausted one
            passes[name] = [sorted(creator.cloud_reader(shards, ep)())
                            for _ in range(2)]
        want = sorted((i, j) for i in range(4) for j in range(5))
        assert passes["port"] == passes["jax"] == [want, want]
        assert svc.stats()["pass"] == 3
        raw = sorted(tcreator.cloud_reader(",".join(shards), addr,
                                           unpickle=False)())
        assert len(raw) == 20 and isinstance(raw[0], bytes)
    finally:
        svc.shutdown()
