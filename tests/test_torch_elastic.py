"""The port's ElasticTrainer (``paddle_tpu_torch/distributed/elastic.py``)
over its master and Fluid checkpoints, against the JAX package's on the
CPU: per-task losses on the same shards with parameters copied across,
resume from a checkpoint (either package's), deferred finishes, failed
tasks, an unreachable master, spans and counters; then one run of
trainer processes in which a trainer is SIGKILLed holding a lease, its
task is requeued, and a late replacement resumes from its checkpoint.
Tolerance: per-task losses and parameters within LOSS_TOL (the same SGD
arithmetic on the same float32 values)."""
import os
import pickle
import signal
import subprocess
import sys
import textwrap
import time
import types

import numpy as np
import pytest

LOSS_TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pkg(name):
    if name == "jax":
        import paddle_tpu.fluid as fluid
        from paddle_tpu.distributed import elastic, master
        from paddle_tpu.fluid import layers, unique_name
        from paddle_tpu.observability import metrics, tracing
        dev = {}
    else:
        import paddle_tpu_torch.fluid as fluid
        from paddle_tpu_torch.distributed import elastic, master
        from paddle_tpu_torch.fluid import layers, unique_name
        from paddle_tpu_torch.observability import metrics, tracing
        dev = {"device": "cpu"}
    return types.SimpleNamespace(
        name=name, fluid=fluid, layers=layers, unique_name=unique_name,
        master=master, elastic=elastic, metrics=metrics, tracing=tracing,
        dev=dev, exe=lambda: (fluid.Executor() if name == "jax"
                              else fluid.Executor("cpu")))


def _shards(tmp_path, n=5, per=3, seed=3):
    """n recordio shards of `per` (record id, x[4], y[1]) samples."""
    from paddle_tpu_torch.fluid.recordio_writer import (
        convert_reader_to_recordio_file)

    rng = np.random.RandomState(seed)
    w_true = np.array([[1.0], [-2.0], [0.5], [1.5]], np.float32)
    paths = []
    for i in range(n):
        p = str(tmp_path / f"shard-{i}.recordio")
        xs = rng.rand(per, 4).astype(np.float32)
        ys = xs @ w_true

        def reader(i=i, xs=xs, ys=ys):
            for j in range(per):
                yield (i * per + j, xs[j], ys[j])

        convert_reader_to_recordio_file(p, reader)
        paths.append(p)
    return paths


def _model(pkg):
    fluid, layers = pkg.fluid, pkg.layers
    with pkg.unique_name.guard():
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 7
        with fluid.program_guard(main, startup):
            x = layers.data(name="x", shape=[4], dtype="float32")
            y = layers.data(name="y", shape=[1], dtype="float32")
            pred = layers.fc(input=x, size=1,
                             param_attr=fluid.ParamAttr(name="el.w"),
                             bias_attr=fluid.ParamAttr(name="el.b"))
            cost = layers.mean(layers.square_error_cost(input=pred, label=y))
            fluid.optimizer.SGD(learning_rate=0.05).minimize(cost)
    return main, startup, cost


def _np(v):
    return np.array(v.detach().cpu() if hasattr(v, "detach") else v)


def _batch(paths):
    from paddle_tpu_torch.native.recordio import read_all

    samples = [pickle.loads(r) for p in paths for r in read_all(p)]
    return (np.stack([s[1] for s in samples]),
            np.stack([s[2] for s in samples]))


def _trainer(pkg, client, ckpt, main, startup, cost, init, losses):
    """A fresh scope from `init`, and an ElasticTrainer over it whose
    callback runs two steps a task and records their losses."""
    import torch

    fluid = pkg.fluid
    scope, exe = fluid.Scope(), pkg.exe()
    exe.run(startup, scope=scope)
    for n, v in init.items():
        scope.set_var(n, v if pkg.name == "jax" else torch.tensor(v))

    def train(task):
        xb, yb = _batch(task.paths)
        got = []
        for _ in range(2):
            (loss,) = exe.run(main, feed={"x": xb, "y": yb},
                              fetch_list=[cost], scope=scope)
            got.append(float(np.ravel(_np(loss))[0]))
        losses.append((task.id, got))

    t = pkg.elastic.ElasticTrainer(client, ckpt, main_program=main,
                                   scope=scope, idle_timeout=10.0,
                                   **pkg.dev)
    return t, train, scope


def _elastic_run(pkg, paths, ckpt, init):
    """Trainer 1 drains two tasks and stops; a fresh trainer resumes from
    its checkpoint and drains the pass. Per-task losses, the resumed
    step, the final parameters and the resume counter's delta."""
    svc = pkg.master.MasterService(chunks_per_task=1, lease_timeout=60)
    client = pkg.master.MasterClient(service=svc)
    client.set_dataset(paths)
    main, startup, cost = _model(pkg)
    losses = []
    t1, train1, s1 = _trainer(pkg, client, ckpt, main, startup, cost,
                              init, losses)
    stats1 = t1.run_pass(train1, should_stop=lambda: len(losses) >= 2)
    assert stats1 == {"trained": 2, "step": 2, "resumed_from": None,
                      "aborted": 0}
    w_ckpt = _np(s1.find_var("el.w"))
    r0 = pkg.metrics.counter("elastic.resumes").value()
    # "restart": a fresh scope from the initial values, the same ckpt dir
    t2, train2, s2 = _trainer(pkg, client, ckpt, main, startup, cost,
                              init, losses)
    assert t2.maybe_resume() == 2
    np.testing.assert_array_equal(_np(s2.find_var("el.w")), w_ckpt)
    stats2 = t2.run_pass(train2)
    assert stats2 == {"trained": len(paths) - 2, "step": len(paths),
                      "resumed_from": 2, "aborted": 0}
    assert svc.stats() == {"todo": 0, "pending": 0, "done": len(paths),
                           "dropped": 0, "pass": 0}
    return {"losses": losses,
            "params": {n: _np(s2.find_var(n)) for n in ("el.w", "el.b")},
            "resumes": pkg.metrics.counter("elastic.resumes").value() - r0}


def test_per_task_losses_and_resume_match_jax(tmp_path):
    paths = _shards(tmp_path)
    jax = _pkg("jax")
    main, startup, _ = _model(jax)
    scope = jax.fluid.Scope()
    jax.exe().run(startup, scope=scope)
    init = {n: _np(scope.find_var(n)) for n in ("el.w", "el.b")}
    ref = _elastic_run(jax, paths, str(tmp_path / "ckpt_jax"), init)
    got = _elastic_run(_pkg("port"), paths, str(tmp_path / "ckpt_port"),
                       init)
    assert [t for t, _ in got["losses"]] == [t for t, _ in ref["losses"]]
    np.testing.assert_allclose([l for _, l in got["losses"]],
                               [l for _, l in ref["losses"]],
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    for n in ref["params"]:
        np.testing.assert_allclose(got["params"][n], ref["params"][n],
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
    assert got["resumes"] == ref["resumes"] == 1
    # either package's trainer resumes from the other's checkpoint
    port = _pkg("port")
    main, startup, cost = _model(port)
    svc = port.master.MasterService(chunks_per_task=1)
    t, _, scope = _trainer(port, port.master.MasterClient(service=svc),
                           str(tmp_path / "ckpt_jax"), main, startup, cost,
                           init, [])
    assert t.maybe_resume() == len(paths)
    np.testing.assert_array_equal(_np(scope.find_var("el.w")),
                                  ref["params"]["el.w"])


def test_checkpoint_every_defers_finish(tmp_path):
    port = _pkg("port")
    svc = port.master.MasterService(chunks_per_task=1, lease_timeout=30.0)
    client = port.master.MasterClient(service=svc)
    client.set_dataset(_shards(tmp_path, n=4))
    t = port.elastic.ElasticTrainer(client, str(tmp_path / "c"),
                                    checkpoint_every=3, idle_timeout=1.0,
                                    device="cpu")
    seen = []

    def train(task):
        seen.append(task.id)
        # trained-but-uncovered tasks stay leased until a checkpoint
        if len(seen) == 3:
            assert svc.stats()["done"] == 0, svc.stats()
        elif len(seen) == 4:
            assert svc.stats()["done"] == 3, svc.stats()

    assert t.run_pass(train)["trained"] == 4
    assert svc.stats()["done"] == 4 and os.path.exists(
        str(tmp_path / "c" / "META"))


def test_failed_task_requeued_and_corrupt_checkpoint_starts_fresh(tmp_path):
    port = _pkg("port")
    svc = port.master.MasterService(chunks_per_task=1, lease_timeout=5.0,
                                    failure_max=3)
    client = port.master.MasterClient(service=svc)
    client.set_dataset(_shards(tmp_path, n=2))
    t = port.elastic.ElasticTrainer(client, str(tmp_path / "c"),
                                    idle_timeout=5.0, device="cpu")

    def bad(task):
        raise ValueError("poisoned shard")

    with pytest.raises(ValueError, match="poisoned"):
        t.run_pass(bad)
    assert svc.stats()["pending"] == 0 and svc.stats()["todo"] == 2
    main, startup, _ = _model(port)
    scope = port.fluid.Scope()
    port.exe().run(startup, scope=scope)
    ckpt = str(tmp_path / "ckpt")
    payload = port.fluid.io.save_checkpoint(ckpt, main, step=3, scope=scope)
    with open(payload, "r+b") as f:  # tear the payload, keep META intact
        f.seek(10)
        f.write(b"\xff\xff\xff\xff")
    t = port.elastic.ElasticTrainer(client, ckpt, main_program=main,
                                    scope=scope, device="cpu")
    assert t.maybe_resume() is None and t.resumed_from is None


def test_unreachable_master_aborts_the_pass(tmp_path):
    import socket

    port = _pkg("port")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    addr = s.getsockname()
    s.close()  # nothing listens there
    client = port.master.MasterClient(addr=addr, reconnect_retries=1,
                                      reconnect_backoff=0.01, timeout=5)
    t = port.elastic.ElasticTrainer(client, str(tmp_path / "c"),
                                    device="cpu")
    assert t.run_pass(lambda task: None) == {
        "trained": 0, "step": 0, "resumed_from": None, "aborted": 1}


def test_spans_counters_and_the_card_default(tmp_path, monkeypatch):
    import torch

    port = _pkg("port")
    svc = port.master.MasterService(chunks_per_task=1)
    client = port.master.MasterClient(service=svc)
    client.set_dataset(_shards(tmp_path, n=2))
    main, startup, cost = _model(port)
    n0 = port.metrics.counter("elastic.tasks_trained").value()
    port.tracing.trace_enable(buffer_size=4096)
    port.tracing.trace_reset()
    try:
        t, train, _ = _trainer(port, client, str(tmp_path / "c"), main,
                               startup, cost, {}, [])
        assert t.run_pass(train)["trained"] == 2
        names = [e["name"] for e in port.tracing.trace_events()
                 if e.get("ph") == "X"]
    finally:
        port.tracing.trace_disable()
        port.tracing.trace_reset()
    assert names.count("elastic.task") == 2
    assert names.count("elastic.checkpoint") == 2
    assert port.metrics.counter("elastic.tasks_trained").value() - n0 == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.elastic.ElasticTrainer(client, str(tmp_path / "d"))


_TRAINER = textwrap.dedent("""
    import os, pickle, sys, time
    sys.path.insert(0, os.environ["REPO_ROOT"])
    import numpy as np
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import layers, unique_name
    from paddle_tpu_torch.distributed import (ElasticTrainer, MasterClient,
                                              WorkerRegistry)
    from paddle_tpu_torch.native.recordio import read_all

    wid = os.environ["WORKER_ID"]
    work = os.environ["WORK_DIR"]
    hold_at = int(os.environ.get("HOLD_AT", "0"))
    max_tasks = int(os.environ.get("MAX_TASKS", "0"))
    log = open(os.path.join(work, f"trainer-{wid}.log"), "a", buffering=1)

    class Client(MasterClient):
        # a finish the master accepted is logged with the task's records
        def task_finished(self, task_id, epoch=None):
            ok = super().task_finished(task_id, epoch)
            if ok:
                log.write("FINISHED %d %s\\n" % (task_id, rids[task_id]))
            return ok

    client = Client(("127.0.0.1", int(os.environ["MASTER_PORT"])),
                    timeout=60)
    reg = WorkerRegistry(os.path.join(work, "members"), wid, ttl=60)
    with unique_name.guard():
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 5
        with fluid.program_guard(main, startup):
            x = layers.data(name="x", shape=[4], dtype="float32")
            y = layers.data(name="y", shape=[1], dtype="float32")
            pred = layers.fc(input=x, size=1)
            cost = layers.mean(layers.square_error_cost(input=pred, label=y))
            fluid.optimizer.SGD(learning_rate=0.05).minimize(cost)
    exe, scope = fluid.Executor("cpu"), fluid.Scope()
    exe.run(startup, scope=scope)
    trainer = ElasticTrainer(client, os.environ["CKPT_DIR"],
                             main_program=main, scope=scope, registry=reg,
                             device="cpu", idle_timeout=120)
    rids, trained = {}, []

    def train(task):
        samples = [pickle.loads(r) for r in read_all(task.paths[0])]
        rids[task.id] = ",".join(str(s[0]) for s in samples)
        if hold_at and len(trained) + 1 == hold_at:
            # die holding the lease: the test SIGKILLs us here
            log.write("HOLDING %d %s\\n" % (task.id, rids[task.id]))
            time.sleep(600)
        xb = np.stack([s[1] for s in samples])
        yb = np.stack([s[2] for s in samples])
        for _ in range(2):
            (l,) = exe.run(main, feed={"x": xb, "y": yb},
                           fetch_list=[cost], scope=scope)
            log.write("LOSS %.6f\\n" % float(np.ravel(l)[0]))
        trained.append(task.id)

    log.write("RESUMED %s\\n" % trainer.maybe_resume())
    stats = trainer.run_pass(
        train, should_stop=lambda: bool(max_tasks) and
        len(trained) >= max_tasks)
    log.write("EXIT %s\\n" % stats)
    print("TRAINER_%s_OK" % wid, flush=True)
""")


def _lines(path, tag):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [ln.split() for ln in f.read().splitlines()
                if ln.startswith(tag)]


def _wait_for(path, tag, deadline_s=180):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        got = _lines(path, tag)
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"{path}: no {tag} line in {deadline_s} s")


def test_sigkilled_trainer_requeued_and_replacement_resumes(tmp_path):
    """Trainer processes over a served master: t0 trains its share of
    three tasks and leaves; the victim trains one task (checkpointed),
    takes a second and is SIGKILLed holding its lease; its task is
    requeued when the lease expires, and a late replacement pointed at
    the victim's checkpoint directory resumes from it and drains the
    rest. Every record is finished exactly once."""
    from paddle_tpu_torch.distributed import MasterClient, MasterService
    from paddle_tpu_torch.distributed import WorkerRegistry

    n_shards, per = 8, 4
    paths = _shards(tmp_path, n=n_shards, per=per)
    svc = MasterService(chunks_per_task=1, lease_timeout=6.0, failure_max=5)
    host, port = svc.serve()
    procs = {}
    try:
        MasterClient((host, port)).set_dataset(paths)
        env_base = {k: v for k, v in os.environ.items()
                    if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}

        def launch(wid, ckpt, **extra):
            env = dict(env_base, WORKER_ID=wid, WORK_DIR=str(tmp_path),
                       MASTER_PORT=str(port), REPO_ROOT=REPO,
                       CKPT_DIR=str(tmp_path / ckpt),
                       **{k: str(v) for k, v in extra.items()})
            return subprocess.Popen(
                [sys.executable, "-c", _TRAINER], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

        procs["t0"] = launch("t0", "ckpt-t0", MAX_TASKS=3)
        procs["victim"] = launch("victim", "ckpt-victim", HOLD_AT=2)
        vlog = str(tmp_path / "trainer-victim.log")
        (held,) = _wait_for(vlog, "HOLDING")
        held_task, held_rids = int(held[1]), set(held[2].split(","))
        procs["victim"].send_signal(signal.SIGKILL)
        procs["victim"].wait(60)
        procs["t2"] = launch("t2", "ckpt-victim")  # the victim's ckpt dir
        for w in ("t0", "t2"):
            out, err = procs[w].communicate(timeout=240)
            assert procs[w].returncode == 0, (w, out, err[-4000:])
            assert f"TRAINER_{w}_OK" in out
        assert svc.stats() == {"todo": 0, "pending": 0, "done": n_shards,
                               "dropped": 0, "pass": 0}
        finished = {}
        for w in ("t0", "victim", "t2"):
            for _, tid, rids in _lines(str(tmp_path / f"trainer-{w}.log"),
                                       "FINISHED"):
                for r in rids.split(","):
                    finished.setdefault(r, []).append(w)
        assert set(finished) == {str(i) for i in range(n_shards * per)}
        assert all(len(ws) == 1 for ws in finished.values()), finished
        assert [finished[r] for r in sorted(held_rids)] == [["t2"]] * per
        assert len(_lines(vlog, "FINISHED")) == 1
        assert len(_lines(str(tmp_path / "trainer-t0.log"),
                          "FINISHED")) == 3
        assert _lines(str(tmp_path / "trainer-t2.log"),
                      "RESUMED") == [["RESUMED", "1"]]
        members = WorkerRegistry(str(tmp_path / "members"), "probe").members()
        assert "t2" in members.values(), members
        assert held_task in {int(t) for _, t, _ in _lines(
            str(tmp_path / "trainer-t2.log"), "FINISHED")}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(30)
        svc.shutdown()
