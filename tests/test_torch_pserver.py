"""The port's parameter-server training (``paddle_tpu_torch/distributed/
param_server.py``, the SelectedRows branch of ``distributed/rpc.py``, the
executor's ``send``/``recv``/``prefetch`` host ops, ``layers.Send``/
``Recv``/``ListenAndServ`` and ``DistributeTranspiler.start_pserver``)
against the JAX package on the CPU, over loopback.

Each case runs the same flow through both packages on the same seeded
numpy inputs: the counterparts of ``tests/test_param_server.py``'s
in-process, sparse, sync-barrier, LR-decay, sync-executor, layer and
prefetch tests, the wire bytes of dense and SelectedRows messages, a
port client against a JAX server and the reverse, and heartbeat eviction
in sync mode. Servers and trainers run as threads of this process, on
ports of 127.0.0.1. Where a pserver's state starts from a random
initializer, the JAX pserver's initial state is copied into the port's
before the first push. Tolerances: losses within LOSS_RTOL, pserver
parameters within PARAM_RTOL (the same SGD arithmetic on the same
float32 values).
"""
import io
import socket
import threading
import types

import numpy as np
import pytest
import torch

LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-6


def _pkg(name):
    if name == "jax":
        import paddle_tpu.fluid as fluid
        from paddle_tpu.distributed import param_server, rpc
        from paddle_tpu.fluid import layers, unique_name
        from paddle_tpu.fluid.selected_rows import SelectedRows
    else:
        import paddle_tpu_torch.fluid as fluid
        from paddle_tpu_torch.distributed import param_server, rpc
        from paddle_tpu_torch.fluid import layers, unique_name
        from paddle_tpu_torch.fluid.selected_rows import SelectedRows
    return types.SimpleNamespace(
        name=name, fluid=fluid, layers=layers, unique_name=unique_name,
        ps=param_server, rpc=rpc, SelectedRows=SelectedRows,
        Transpiler=fluid.DistributeTranspiler,
        # the port's entry points run on the card unless told otherwise
        dev={} if name == "jax" else {"device": "cpu"},
        exe=lambda: (fluid.Executor() if name == "jax"
                     else fluid.Executor("cpu")))


PKGS = ("jax", "port")


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _arr(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _linear_model(pkg, seed=5, lr=0.05, prefix="psrv"):
    """tests/test_param_server.py's model: fc(4 -> 1) from zero weights,
    square error, SGD(lr)."""
    fluid, layers = pkg.fluid, pkg.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data(name="x", shape=[4], dtype="float32")
        y = layers.data(name="y", shape=[1], dtype="float32")
        pred = layers.fc(
            input=x, size=1,
            param_attr=fluid.ParamAttr(
                name=f"{prefix}.w",
                initializer=fluid.initializer.ConstantInitializer(0.0)),
            bias_attr=fluid.ParamAttr(
                name=f"{prefix}.b",
                initializer=fluid.initializer.ConstantInitializer(0.0)))
        cost = layers.mean(layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.SGD(learning_rate=lr).minimize(cost)
    return main, startup, cost


def _feed(step=0):
    rng = np.random.RandomState(100 + step)
    x = rng.rand(8, 4).astype(np.float32)
    y = (x @ np.array([[1.0], [2.0], [-1.0], [0.5]], dtype=np.float32)
         + 0.3).astype(np.float32)
    return {"x": x, "y": y}


def _transpile(pkg, main, startup, eps, trainers=1, sync=False, tid=0):
    t = pkg.Transpiler()
    t.transpile(trainer_id=tid, program=main, startup_program=startup,
                pservers=eps, trainers=trainers, sync_mode=sync)
    return t


def _serve(pkg, t, **kw):
    return [t.start_pserver(ep, port=int(ep.rsplit(":", 1)[1]), **pkg.dev,
                            **kw) for ep in t.pserver_endpoints]


def _snapshot(ps):
    """Every tensor of a pserver's scope, as numpy."""
    return {n: np.array(ps._scope.find_var(n))
            for n in ps._scope.var_names()
            if hasattr(ps._scope.find_var(n), "shape")}


def _restore(ps, state):
    """Set a port pserver's scope to a JAX pserver's snapshot."""
    for n, v in state.items():
        ps._scope.set_var(n, torch.tensor(v))


def _loss(v):
    return float(np.ravel(np.asarray(v))[0])


# --- the wire ----------------------------------------------------------------

def _messages(pkg):
    rng = np.random.RandomState(3)
    arr = rng.randn(64, 16).astype(np.float32)
    sr = pkg.SelectedRows(np.array([1, 5, 1, 9], np.int64),
                          rng.randn(4, 3).astype(np.float32), 10)
    return {"dense": {"method": "push_grad", "args": ["w", arr, 0]},
            "sparse": {"method": "push_grad", "args": ["t", sr, 1]},
            "both": {"method": "x", "args": [arr, sr, "name", 7]}}


@pytest.mark.parametrize("kind", ["dense", "sparse", "both"])
def test_wire_bytes_equal_jax(kind):
    """write_msg (raw segments) and to_wire without segments (inline
    base64) give the JAX package's bytes; a port SelectedRows holding
    torch tensors gives them too, and decodes back to one."""
    frames, inline = {}, {}
    for name in PKGS:
        pkg = _pkg(name)
        buf = io.BytesIO()
        msg = _messages(pkg)[kind]
        pkg.rpc.write_msg(buf, msg)
        frames[name] = buf.getvalue()
        inline[name] = pkg.rpc.json.dumps(pkg.rpc.to_wire(msg))
    assert frames["port"] == frames["jax"]
    assert inline["port"] == inline["jax"]
    port = _pkg("port")
    msg = _messages(port)[kind]
    as_tensors = {"method": msg["method"], "args": [
        port.SelectedRows(torch.from_numpy(a.rows), torch.from_numpy(a.value),
                          a.height) if isinstance(a, port.SelectedRows)
        else torch.from_numpy(a) if isinstance(a, np.ndarray) else a
        for a in msg["args"]]}
    buf = io.BytesIO()
    port.rpc.write_msg(buf, as_tensors)
    assert buf.getvalue() == frames["jax"]
    buf.seek(0)
    got = port.rpc.from_wire(*port.rpc.read_msg(buf))
    for a, b in zip(got["args"], msg["args"]):
        if isinstance(b, port.SelectedRows):
            assert isinstance(a, port.SelectedRows) and a.height == b.height
            np.testing.assert_array_equal(a.rows, b.rows)
            np.testing.assert_array_equal(a.value, b.value)
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


@pytest.mark.parametrize("server,client", [("jax", "port"), ("port", "jax")])
def test_client_and_server_of_the_two_packages_interoperate(server, client):
    """A ParameterClient of one package against a pserver of the other:
    dense and SelectedRows pushes, get_param, get_rows and stats; then a
    trainer program of the client's package trains against it, with the
    losses of the same flow in the JAX package alone."""
    spkg, cpkg = _pkg(server), _pkg(client)
    ep = f"127.0.0.1:{_free_ports(1)[0]}"
    main, startup, _ = _linear_model(spkg, prefix="io")
    t = _transpile(spkg, main, startup, ep)
    (ps,) = _serve(spkg, t)
    try:
        c = cpkg.ps.ParameterClient(t.param_assignment)
        before = {p: np.array(c.get_param(p)) for p in ps.owned_params()}
        c.send_grad("io.w", np.ones((4, 1), np.float32))
        c.send_grad("io.w", cpkg.SelectedRows(
            np.array([2, 2], np.int64), np.ones((2, 1), np.float32), 4))
        want = before["io.w"] - 0.05
        want[2] -= 0.1
        np.testing.assert_allclose(c.get_param("io.w"), want, rtol=1e-6)
        np.testing.assert_allclose(c.get_rows("io.w", [2, 0]),
                                   want[[2, 0]], rtol=1e-6)
        assert cpkg.ps.get_client(ep).call("stats")["steps"] == 2
    finally:
        ps.shutdown()
    losses = {}
    for side, (s_name, c_name) in {"mixed": (server, client),
                                   "jax": ("jax", "jax")}.items():
        sp, cp = _pkg(s_name), _pkg(c_name)
        ep = f"127.0.0.1:{_free_ports(1)[0]}"
        smain, sstart, _ = _linear_model(sp, prefix="mix")
        (ps,) = _serve(sp, _transpile(sp, smain, sstart, ep))
        try:
            main, startup, cost = _linear_model(cp, prefix="mix")
            prog = _transpile(cp, main, startup, ep).get_trainer_program(
                send_recv=True)
            scope, exe = cp.fluid.Scope(), cp.exe()
            exe.run(startup, scope=scope)
            losses[side] = [_loss(exe.run(prog, feed=_feed(i),
                                          fetch_list=[cost], scope=scope)[0])
                            for i in range(6)]
        finally:
            ps.shutdown()
    np.testing.assert_allclose(losses["mixed"], losses["jax"],
                               rtol=LOSS_RTOL)


# --- tests/test_param_server.py's counterparts --------------------------------

def _in_process(pkg, steps=12):
    ports = _free_ports(2)
    eps = ",".join(f"127.0.0.1:{p}" for p in ports)
    main, startup, cost = _linear_model(pkg)
    t = _transpile(pkg, main, startup, eps)
    servers = _serve(pkg, t)
    try:
        assert all(s.owned_params() for s in servers)
        prog = t.get_trainer_program(send_recv=True)
        types_ = [op.type for op in prog.global_block().ops]
        assert types_[0] == "recv" and types_[-1] == "send"
        assert "sgd" not in types_
        scope, exe = pkg.fluid.Scope(), pkg.exe()
        exe.run(startup, scope=scope)
        losses = [_loss(exe.run(prog, feed=_feed(i), fetch_list=[cost],
                                scope=scope)[0]) for i in range(steps)]
        pkg.ps.ParameterClient(t.param_assignment).pull_all(scope)
        params, steps_done = {}, 0
        for ep, s in zip(t.pserver_endpoints, servers):
            steps_done += pkg.ps.get_client(ep).call("stats")["steps"]
            for p in s.owned_params():
                params[p] = s.get_param(p)
                np.testing.assert_allclose(_arr(scope.find_var(p)),
                                           params[p], rtol=1e-6)
        assert steps_done == steps * 2
        return losses, params
    finally:
        for s in servers:
            s.shutdown()


def test_pserver_program_executes_in_process_like_jax():
    """test_param_server.py:69: two pservers split the params; the
    trainer's recv/send ops move params and grads; every optimize step
    runs in the pserver scopes."""
    (jl, jp), (tl, tp) = _in_process(_pkg("jax")), _in_process(_pkg("port"))
    assert tl[-1] < tl[0] * 0.5
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert set(tp) == set(jp)
    for p in jp:
        np.testing.assert_allclose(tp[p], jp[p], rtol=PARAM_RTOL)


def test_pserver_sparse_selected_rows_grad_like_jax():
    """test_param_server.py:123: a SelectedRows grad with a duplicate row
    rides the wire and applies row-wise on the pserver."""
    vocab, dim, got = 40, 4, {}
    servers = {}
    try:
        for name in PKGS:
            pkg = _pkg(name)
            fluid, layers = pkg.fluid, pkg.layers
            main, startup = fluid.Program(), fluid.Program()
            main.random_seed = startup.random_seed = 3
            with pkg.unique_name.guard(), fluid.program_guard(main, startup):
                ids = layers.data(name="ids", shape=[1], dtype="int64")
                emb = layers.embedding(input=ids, size=[vocab, dim],
                                       is_sparse=True)
                cost = layers.mean(emb)
                fluid.optimizer.SGD(learning_rate=1.0).minimize(cost)
            ep = f"127.0.0.1:{_free_ports(1)[0]}"
            t = _transpile(pkg, main, startup, ep)
            (servers[name],) = _serve(pkg, t)
            if name == "jax":
                init = _snapshot(servers[name])
            else:
                _restore(servers[name], init)
            (w_name,) = servers[name].owned_params()
            before = np.array(servers[name].get_param(w_name))
            client = pkg.ps.ParameterClient(t.param_assignment)
            client.send_grad(w_name, pkg.SelectedRows(
                np.array([3, 7, 3], np.int32), np.ones((3, dim), np.float32),
                vocab))
            after = np.array(client.get_param(w_name))
            np.testing.assert_allclose(after[3], before[3] - 2.0, rtol=1e-5)
            np.testing.assert_allclose(after[7], before[7] - 1.0, rtol=1e-5)
            rest = [i for i in range(vocab) if i not in (3, 7)]
            np.testing.assert_array_equal(after[rest], before[rest])
            got[name] = after
    finally:
        for s in servers.values():
            s.shutdown()
    np.testing.assert_allclose(got["port"], got["jax"], rtol=PARAM_RTOL)


def test_pserver_sync_mode_barrier_like_jax():
    """test_param_server.py:162: sync mode sums the trainers' grads and
    applies once a round."""
    got = {}
    for name in PKGS:
        pkg = _pkg(name)
        main, startup, _ = _linear_model(pkg)
        ep = f"127.0.0.1:{_free_ports(1)[0]}"
        t = _transpile(pkg, main, startup, ep, trainers=2, sync=True)
        (ps,) = _serve(pkg, t)
        try:
            owned = ps.owned_params()
            before = {p: np.array(ps.get_param(p)) for p in owned}

            def trainer(tid):
                client = pkg.ps.ParameterClient(t.param_assignment,
                                                trainer_id=tid)
                for p in owned:
                    client.send_grad(p, np.ones_like(before[p]))

            threads = [threading.Thread(target=trainer, args=(i,))
                       for i in range(2)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=30)
            pkg.ps.ParameterClient(t.param_assignment).barrier()
            stats = ps.stats()
            assert stats["round"] == 1 and stats["steps"] == len(owned)
            got[name] = {p: np.array(ps.get_param(p)) for p in owned}
            for p in owned:
                np.testing.assert_allclose(got[name][p],
                                           before[p] - 0.05 * 2.0, rtol=1e-5)
        finally:
            ps.shutdown()
    for p in got["jax"]:
        np.testing.assert_allclose(got["port"][p], got["jax"][p],
                                   rtol=PARAM_RTOL)


def test_pserver_lr_decay_advances_once_per_round_like_jax():
    """test_param_server.py:288: the shared LR-decay counter advances
    once per distinct-param cycle on a 2-param pserver, not per push."""
    got = {}
    servers = {}
    try:
        for name in PKGS:
            pkg = _pkg(name)
            fluid, layers = pkg.fluid, pkg.layers
            main, startup = fluid.Program(), fluid.Program()
            main.random_seed = startup.random_seed = 9
            with pkg.unique_name.guard(), fluid.program_guard(main, startup):
                x = layers.data(name="x", shape=[4], dtype="float32")
                y = layers.data(name="y", shape=[1], dtype="float32")
                pred = layers.fc(input=x, size=1,
                                 param_attr=fluid.ParamAttr(name="lrd.w"),
                                 bias_attr=fluid.ParamAttr(name="lrd.b"))
                cost = layers.mean(layers.square_error_cost(input=pred,
                                                            label=y))
                lr = layers.exponential_decay(learning_rate=0.1,
                                              decay_steps=1, decay_rate=0.5,
                                              staircase=True)
                fluid.optimizer.SGD(learning_rate=lr).minimize(cost)
            ep = f"127.0.0.1:{_free_ports(1)[0]}"
            t = _transpile(pkg, main, startup, ep)
            (ps,) = servers[name] = _serve(pkg, t)
            if name == "jax":
                init = _snapshot(ps)
            else:
                _restore(ps, init)
            assert ps._shared_prog is not None
            owned = ps.owned_params()
            assert len(owned) == 2
            client = pkg.ps.ParameterClient(t.param_assignment)
            before = {p: np.array(client.get_param(p)) for p in owned}
            step_var = next(n for n in ps._shared_prog.global_block().vars
                            if "step" in n.lower() or "counter" in n.lower())
            counts = []
            for _ in range(2):
                for p in owned:
                    client.send_grad(p, np.ones_like(before[p]))
                counts.append(float(_arr(ps._scope.find_var(
                    step_var)).ravel()[0]))
            assert counts[1] - counts[0] == 1.0, counts
            got[name] = (counts, {p: np.array(client.get_param(p))
                                  for p in owned})
            for p in owned:
                assert np.abs(got[name][1][p] - before[p]).max() > 1e-6
    finally:
        for s in servers.values():
            s[0].shutdown()
    assert got["port"][0] == got["jax"][0]
    for p in got["jax"][1]:
        np.testing.assert_allclose(got["port"][1][p], got["jax"][1][p],
                                   rtol=PARAM_RTOL)


def _sync_trainers(pkg, steps=6):
    ep = f"127.0.0.1:{_free_ports(1)[0]}"
    main, startup, cost = _linear_model(pkg, seed=21)
    t0 = _transpile(pkg, main, startup, ep, trainers=2, sync=True)
    (ps,) = _serve(pkg, t0)
    try:
        progs = [_transpile(pkg, main, startup, ep, trainers=2, sync=True,
                            tid=tid).get_trainer_program(send_recv=True)
                 for tid in range(2)]
        types_ = [op.type for op in progs[0].global_block().ops]
        assert types_[-1] == "send_barrier" and types_[-2] == "send"
        results = {}

        def trainer(tid):
            scope, exe = pkg.fluid.Scope(), pkg.exe()
            exe.run(startup, scope=scope)
            losses = [_loss(exe.run(progs[tid], feed=_feed(2 * i + tid),
                                    fetch_list=[cost], scope=scope)[0])
                      for i in range(steps)]
            results[tid] = (losses, {p: _arr(scope.find_var(p)).copy()
                                     for p in t0.param_assignment})

        threads = [threading.Thread(target=trainer, args=(i,))
                   for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert set(results) == {0, 1}, "a trainer thread died or hung"
        stats = ps.stats()
        assert stats["round"] == steps, stats
        assert stats["steps"] == steps * len(t0.param_assignment), stats
        for p in t0.param_assignment:
            np.testing.assert_allclose(results[0][1][p], results[1][1][p],
                                       rtol=1e-6)
        return results, {p: np.array(ps.get_param(p))
                         for p in t0.param_assignment}
    finally:
        ps.shutdown()


def test_sync_two_trainers_through_executor_ops_like_jax():
    """test_param_server.py:336: two trainer threads run sync-mode
    recv/send/send_barrier programs against one pserver; rounds complete,
    barriers release, both trainers see the same parameters — and each
    trainer's losses are the JAX package's."""
    (jr, jp), (tr, tp) = _sync_trainers(_pkg("jax")), _sync_trainers(
        _pkg("port"))
    for tid in (0, 1):
        np.testing.assert_allclose(tr[tid][0], jr[tid][0], rtol=LOSS_RTOL)
    assert tr[0][0][-1] < tr[0][0][0]
    for p in jp:
        np.testing.assert_allclose(tp[p], jp[p], rtol=PARAM_RTOL)


def _listen_and_serv(pkg):
    fluid, layers = pkg.fluid, pkg.layers
    ep = f"127.0.0.1:{_free_ports(1)[0]}"
    server_prog, server_startup = fluid.Program(), fluid.Program()
    with pkg.unique_name.guard(), fluid.program_guard(server_prog,
                                                      server_startup):
        layers.create_parameter(shape=[4], dtype="float32", name="ls.w")
        g = server_prog.global_block().create_var(
            name="ls.w@GRAD", shape=[4], dtype="float32")
        serv = layers.ListenAndServ(ep, inputs=[g], fan_in=1)
        with serv.do():
            server_prog.current_block().append_op(
                "sgd", inputs={"Param": ["ls.w"], "Grad": ["ls.w@GRAD"],
                               "LearningRate": ["ls.lr"]},
                outputs={"ParamOut": ["ls.w"]})
        assert serv.get_params_and_grads() == (["ls.w"], ["ls.w@GRAD"])
    scope = fluid.Scope()
    if pkg.name == "jax":
        import jax.numpy as jnp

        scope.set_var("ls.w", jnp.asarray(np.ones(4, np.float32)))
        scope.set_var("ls.lr", jnp.asarray(np.float32(0.5)))
    else:
        scope.set_var("ls.w", torch.ones(4))
        scope.set_var("ls.lr", torch.tensor(0.5))
    ps = serv.run(scope=scope, port=int(ep.rsplit(":", 1)[1]), **pkg.dev)
    try:
        client_prog = fluid.Program()
        with pkg.unique_name.guard(), fluid.program_guard(client_prog,
                                                          fluid.Program()):
            gvar = client_prog.global_block().create_var(
                name="ls.w@GRAD", shape=[4], dtype="float32")
            wvar = client_prog.global_block().create_var(
                name="ls.w", shape=[4], dtype="float32", persistable=True)
            layers.Send(ep, [gvar], get_vars=[wvar])
            layers.Recv(ep, [wvar])
        cscope = fluid.Scope()
        pkg.exe().run(client_prog, scope=cscope,
                      feed={"ls.w@GRAD": np.full((4,), 2.0, np.float32)})
        return (ep, client_prog, _arr(cscope.find_var("ls.w")),
                _arr(scope.find_var("ls.w")))
    finally:
        ps.shutdown()


def test_listen_and_serv_send_recv_layers_like_jax():
    """test_param_server.py:395: a server block captured with do() serves
    behind RPC; the client program's Send pushes a grad and pulls the
    updated param back (a program of transport ops alone). The client
    program is the JAX package's, op types and attrs, up to the port."""
    jep, jprog, jc, js = _listen_and_serv(_pkg("jax"))
    tep, tprog, tc, ts = _listen_and_serv(_pkg("port"))
    assert tprog.to_bytes() == jprog.to_bytes().replace(
        jep.encode(), tep.encode())
    for got in (tc, ts, jc, js):
        np.testing.assert_allclose(got, np.zeros(4), atol=1e-6)


def _emb_model(pkg, vocab, dim=16, seed=7):
    fluid, layers = pkg.fluid, pkg.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.unique_name.guard(), fluid.program_guard(main, startup):
        ids = layers.data(name="ids", shape=[1], dtype="int64")
        y = layers.data(name="y", shape=[1], dtype="float32")
        emb = layers.embedding(input=ids, size=[vocab, dim], is_sparse=True,
                               is_distributed=True,
                               param_attr=fluid.ParamAttr(name="demb.w"))
        pred = layers.fc(input=emb, size=1,
                         param_attr=fluid.ParamAttr(name="demb.fc.w"),
                         bias_attr=fluid.ParamAttr(name="demb.fc.b"))
        cost = layers.mean(layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(cost)
    return main, startup, cost


def test_distributed_embedding_prefetch_like_jax():
    """test_param_server.py:596 with the pserver as a thread: a pserver
    owns a 100,000-row table; the trainer pulls only the batch's rows
    (prefetch op) and pushes SelectedRows grads back; traffic is
    proportional to the batch's ids; the losses and the final table are
    the JAX package's."""
    vocab, steps, batch = 100_000, 12, 8
    rng = np.random.RandomState(0)
    target = rng.rand(vocab).astype(np.float32)
    batches = [rng.randint(0, 200, size=(batch, 1)).astype(np.int64)
               for _ in range(steps)]
    out, servers = {}, {}
    try:
        for name in PKGS:
            pkg = _pkg(name)
            ep = f"127.0.0.1:{_free_ports(1)[0]}"
            main, startup, cost = _emb_model(pkg, vocab)
            t = _transpile(pkg, main, startup, ep)
            (ps,) = servers[name] = _serve(pkg, t)
            if name == "jax":
                init = _snapshot(ps)
            else:
                _restore(ps, init)
            prog = t.get_trainer_program(send_recv=True)
            types_ = [op.type for op in prog.global_block().ops]
            assert types_[0] == "prefetch" and types_[-1] == "send"
            recv = next(op for op in prog.global_block().ops
                        if op.type == "recv")
            assert "demb.w" not in recv.desc.outputs["Out"]
            scope, exe = pkg.fluid.Scope(), pkg.exe()
            exe.run(t.get_trainer_startup_program(), scope=scope)
            assert scope.find_var("demb.w") is None
            losses = [_loss(exe.run(prog, feed={
                "ids": b, "y": target[b[:, 0]][:, None]}, fetch_list=[cost],
                scope=scope)[0]) for b in batches]
            st = ps.stats()
            assert st["prefetch_rows"] == steps * batch, st
            assert st["full_pull_rows"] < vocab // 50, st
            out[name] = (losses, {p: np.array(ps.get_param(p))
                                  for p in ps.owned_params()})
    finally:
        for s in servers.values():
            s[0].shutdown()
    assert out["port"][0][-1] < out["port"][0][0]
    np.testing.assert_allclose(out["port"][0], out["jax"][0], rtol=LOSS_RTOL)
    for p, want in out["jax"][1].items():
        np.testing.assert_allclose(out["port"][1][p], want, rtol=PARAM_RTOL,
                                   atol=1e-7)


def _evicting_round(pkg):
    main, startup, _ = _linear_model(pkg, prefix="ft", lr=0.05)
    ep = f"127.0.0.1:{_free_ports(1)[0]}"
    t = _transpile(pkg, main, startup, ep, trainers=2, sync=True)
    (ps,) = _serve(pkg, t, heartbeat_timeout=0.6, barrier_timeout=30.0)
    try:
        owned = ps.owned_params()
        before = {p: np.array(ps.get_param(p)) for p in owned}
        c0 = pkg.ps.ParameterClient(t.param_assignment, trainer_id=0)
        c1 = pkg.ps.ParameterClient(t.param_assignment, trainer_id=1)
        for p in owned:
            c0.send_grad(p, np.ones_like(before[p]))
            c1.send_grad(p, 2.0 * np.ones_like(before[p]))
        c0.barrier()
        c1.barrier()
        # trainer 1 goes silent: round 1 completes over trainer 0 alone
        for p in owned:
            c0.send_grad(p, np.ones_like(before[p]))
        c0.barrier()
        assert ps.stats()["evicted"] == [1]
        assert ps.heartbeat(1)["evicted"] is True
        for p in owned:
            np.testing.assert_allclose(
                ps.get_param(p), before[p] - 0.05 * 3.0 - 0.05 * 1.0,
                rtol=1e-5)
        # a fresh push rejoins it; the next round needs both again
        for p in owned:
            c1.send_grad(p, np.ones_like(before[p]))
        assert ps.stats()["evicted"] == []
        for p in owned:
            c0.send_grad(p, np.ones_like(before[p]))
        c0.barrier()
        assert ps.stats()["round"] == 3
        return {p: np.array(ps.get_param(p)) for p in owned}
    finally:
        ps.shutdown()


def test_sync_heartbeat_eviction_like_jax():
    """A sync pserver with a heartbeat lease evicts a silent trainer and
    completes the round over the survivor instead of deadlocking; a
    heartbeat does not rejoin the evicted trainer, a push does
    (tests/test_fault_tolerance.py:241, :281)."""
    want, got = _evicting_round(_pkg("jax")), _evicting_round(_pkg("port"))
    for p in want:
        np.testing.assert_allclose(got[p], want[p], rtol=PARAM_RTOL)


def _frozen_param_round(pkg):
    fluid, layers = pkg.fluid, pkg.layers
    main, startup = fluid.Program(), fluid.Program()
    with pkg.unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data(name="x", shape=[4], dtype="float32")
        y = layers.data(name="y", shape=[1], dtype="float32")
        h = layers.fc(input=x, size=4, bias_attr=False,
                      param_attr=fluid.ParamAttr(name="frozen.w",
                                                 trainable=False))
        p = layers.fc(input=h, size=1, bias_attr=False,
                      param_attr=fluid.ParamAttr(name="fz.w"))
        cost = layers.mean(layers.square_error_cost(input=p, label=y))
        fluid.optimizer.SGD(0.1).minimize(cost)
    ep = f"127.0.0.1:{_free_ports(1)[0]}"
    t = _transpile(pkg, main, startup, ep, trainers=2, sync=True)
    (ps,) = _serve(pkg, t, barrier_timeout=1.0)
    results = {}

    def trainer(tid):
        c = pkg.ps.ParameterClient(t.param_assignment, trainer_id=tid)
        c.send_grad("fz.w", np.ones((4, 1), np.float32))
        try:
            results[tid] = c.barrier()
        except RuntimeError as e:
            results[tid] = e

    try:
        assert ps.owned_params() == ["frozen.w", "fz.w"]
        threads = [threading.Thread(target=trainer, args=(i,))
                   for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        return results, ps.stats()
    finally:
        ps.shutdown()


def test_sync_round_completes_with_a_frozen_param():
    """A decided difference: a sync pserver owning a parameter that no op
    updates (trainable=False) completes its rounds over the updated ones
    in the port; the JAX server waits for every owned param, so each of
    its barriers times out (paddle_tpu/distributed/param_server.py,
    ParameterServer._try_complete_locked)."""
    got, stats = _frozen_param_round(_pkg("port"))
    assert stats["round"] == 1 and stats["steps"] == 1
    assert all(isinstance(r, dict) for r in got.values()), got
    got, stats = _frozen_param_round(_pkg("jax"))
    assert stats["round"] == 0
    assert all(isinstance(r, RuntimeError) and "TimeoutError" in str(r)
               for r in got.values()), got


# --- the port alone -----------------------------------------------------------

def test_parallel_executor_refuses_transport_ops():
    port = _pkg("port")
    main, startup, cost = _linear_model(port, prefix="pe")
    prog = _transpile(port, main, startup, "127.0.0.1:1").get_trainer_program(
        send_recv=True)
    with pytest.raises(NotImplementedError, match="parameter-server"):
        port.fluid.ParallelExecutor(use_cuda=False, main_program=prog)


def test_pserver_device_none_is_the_card(monkeypatch):
    """ParameterServer(device=None) and start_pserver() without a device
    mean the card: without one they raise, never drifting to the CPU."""
    port = _pkg("port")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main, startup, _ = _linear_model(port, prefix="nd")
    t = _transpile(port, main, startup, "127.0.0.1:1")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t.start_pserver("127.0.0.1:1")


def test_new_modules_import_neither_jax_nor_paddle_tpu():
    import subprocess
    import sys

    code = ("import sys, paddle_tpu_torch.distributed.param_server, "
            "paddle_tpu_torch.fluid.profiler, "
            "paddle_tpu_torch.fluid.memory_optimization_transpiler, "
            "paddle_tpu_torch.fluid.debugger, "
            "paddle_tpu_torch.fluid.net_drawer, "
            "paddle_tpu_torch.dataset.flowers, "
            "paddle_tpu_torch.dataset.wmt16; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'paddle_tpu.')) "
            "or m == 'paddle_tpu'); print(bad)")
    repo = __import__("os").path.dirname(__import__("os").path.dirname(
        __import__("os").path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
