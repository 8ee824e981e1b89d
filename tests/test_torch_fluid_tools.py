"""The port's Fluid tool modules against the JAX package on the CPU:
``memory_optimization_transpiler`` (``ControlFlowGraph``,
``memory_optimize``, ``release_memory``, ``estimate_peak_bytes``),
``profiler``, ``debugger``, ``graphviz`` and ``net_drawer``.

  - the rewritten programs' ``to_bytes()``, the liveness sets, the merge
    and insert counts and ``estimate_peak_bytes`` equal the JAX
    package's, on an MLP with a static batch and on tests/
    test_memory_optimize.py's programs;
  - the rewrite leaves results unchanged: a rewritten program's losses
    equal the plain program's (the port's eager loop runs the renamed
    and deleted vars as written) and the JAX package's (LOSS_RTOL);
  - ``to_code``, ``draw_block_graphviz``, ``net_drawer.draw_program`` and
    the ``graphviz`` API give the JAX package's text;
  - the profiler's table has the JAX package's rows (names and calls;
    the times are each run's own) and exports a chrome trace naming the
    RecordEvents.
"""
import json
import types

import numpy as np
import pytest

LOSS_RTOL = 1e-5


def _pkg(name):
    if name == "jax":
        import paddle_tpu.fluid as fluid
        from paddle_tpu.fluid import (debugger, graphviz, layers,
                                      memory_optimization_transpiler,
                                      net_drawer, profiler, unique_name)
    else:
        import paddle_tpu_torch.fluid as fluid
        from paddle_tpu_torch.fluid import (debugger, graphviz, layers,
                                            memory_optimization_transpiler,
                                            net_drawer, profiler,
                                            unique_name)
    return types.SimpleNamespace(
        name=name, fluid=fluid, layers=layers, unique_name=unique_name,
        mot=memory_optimization_transpiler, profiler=profiler,
        debugger=debugger, graphviz=graphviz, net_drawer=net_drawer,
        exe=lambda: (fluid.Executor() if name == "jax"
                     else fluid.Executor("cpu")))


PKGS = ("jax", "port")
BATCH = 8


def _mlp(pkg, static=True, seed=11):
    """tests/test_memory_optimize.py's MLP (4 x fc(32, relu), fc(1),
    square error, SGD); ``static`` gives the feeds a fixed batch, so
    every activation has a static shape and takes part in reuse."""
    fluid, layers = pkg.fluid, pkg.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    kw = dict(append_batch_size=False) if static else {}
    with pkg.unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data(name="x", shape=[BATCH, 32] if static else [32],
                        dtype="float32", **kw)
        y = layers.data(name="y", shape=[BATCH, 1] if static else [1],
                        dtype="float32", **kw)
        h = x
        for i in range(4):
            h = layers.fc(input=h, size=32, act="relu",
                          param_attr=fluid.ParamAttr(name=f"w{i}"),
                          bias_attr=fluid.ParamAttr(name=f"b{i}"))
        p = layers.fc(input=h, size=1, param_attr=fluid.ParamAttr(name="wo"),
                      bias_attr=fluid.ParamAttr(name="bo"))
        cost = layers.mean(layers.square_error_cost(input=p, label=y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(cost)
    return main, startup, cost


def _lenet(pkg, seed=5):
    """tests/test_memory_optimize.py:83's book chapter: LeNet + Adam."""
    fluid, layers = pkg.fluid, pkg.layers
    lenet = __import__(("paddle_tpu" if pkg.name == "jax"
                        else "paddle_tpu_torch") + ".models.lenet",
                       fromlist=["build"])
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.unique_name.guard(), fluid.program_guard(main, startup):
        img = layers.data(name="img", shape=[BATCH, 1, 28, 28],
                          dtype="float32", append_batch_size=False)
        label = layers.data(name="label", shape=[BATCH, 1], dtype="int64",
                            append_batch_size=False)
        cost, _, _ = lenet.build(img, label)
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(cost)
    return main, startup, cost


BUILDS = {"mlp_static": _mlp, "mlp_dynamic": lambda p: _mlp(p, False),
          "lenet_static": _lenet}


def _feeds(build, steps=3):
    rng = np.random.RandomState(0)
    if build == "lenet_static":
        return [{"img": rng.rand(BATCH, 1, 28, 28).astype(np.float32),
                 "label": rng.randint(0, 10, (BATCH, 1)).astype(np.int64)}
                for _ in range(steps)]
    return [{"x": rng.rand(BATCH, 32).astype(np.float32),
             "y": rng.rand(BATCH, 1).astype(np.float32)}
            for _ in range(steps)]


def _persistables(program, scope):
    return {n: np.asarray(scope.find_var(n))
            for n, v in program.global_block().vars.items()
            if v.persistable and scope.find_var(n) is not None}


def _same_program(tp, jp):
    """``to_bytes()`` equal, up to the int32 the JAX package records for
    a var the port keeps int64 (the JAX package runs without x64)."""
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


@pytest.mark.parametrize("build", sorted(BUILDS))
@pytest.mark.parametrize("rewrite", ["memory_optimize", "release_memory",
                                     "both"])
def test_rewrite_matches_jax_and_keeps_results(build, rewrite):
    """The rewrite's program, liveness, count and peak estimate are the
    JAX package's; the rewritten program trains as the plain one does, in
    the port and against the JAX package (from the JAX startup state)."""
    out = {}
    for name in PKGS:
        pkg = _pkg(name)
        plain, startup, cost = BUILDS[build](pkg)
        main, _, cost2 = BUILDS[build](pkg)
        cfg = pkg.mot.ControlFlowGraph(main.global_block())
        peak_before = pkg.mot.estimate_peak_bytes(main)
        counts = []
        if rewrite in ("memory_optimize", "both"):
            counts.append(pkg.mot.memory_optimize(
                main, skip_opt_set={cost2.name}))
        if rewrite in ("release_memory", "both"):
            counts.append(pkg.mot.release_memory(
                main, skip_opt_set={cost2.name}))
        out[name] = dict(
            plain=plain, main=main, startup=startup, cost=cost, cost2=cost2,
            counts=counts, peak=(peak_before,
                                 pkg.mot.estimate_peak_bytes(main)),
            live=(cfg.live_in, cfg.live_out, cfg.last_use_index()),
            live_after=pkg.mot.ControlFlowGraph(main.global_block()).live_in)
    j, t = out["jax"], out["port"]
    _same_program(t["main"], j["main"])
    assert t["counts"] == j["counts"]
    assert t["peak"] == j["peak"] and t["peak"][1] <= t["peak"][0]
    assert t["live"] == j["live"] and t["live_after"] == j["live_after"]
    if build != "mlp_dynamic" and rewrite != "release_memory":
        assert t["counts"][0] > 0
    # results: plain port, rewritten port and rewritten JAX, one state
    jpkg, tpkg = _pkg("jax"), _pkg("port")
    jscope, jexe = jpkg.fluid.Scope(), jpkg.exe()
    jexe.run(j["startup"], scope=jscope)
    state = _persistables(j["plain"], jscope)
    losses = {}
    for key, pkg, prog, cost in (
            ("port_plain", tpkg, t["plain"], t["cost"]),
            ("port_rewritten", tpkg, t["main"], t["cost2"]),
            ("jax_rewritten", jpkg, j["main"], j["cost2"])):
        if pkg is tpkg:
            scope, exe = pkg.fluid.Scope(), pkg.exe()
            pkg.fluid.params_from_jax(state, scope, device="cpu")
        else:
            scope, exe = jscope, jexe
        losses[key] = [float(np.ravel(np.asarray(exe.run(
            prog, feed=f, fetch_list=[cost], scope=scope)[0]))[0])
            for f in _feeds(build)]
    np.testing.assert_allclose(losses["port_rewritten"],
                               losses["port_plain"], rtol=1e-6)
    np.testing.assert_allclose(losses["port_rewritten"],
                               losses["jax_rewritten"], rtol=LOSS_RTOL)


def test_memory_optimize_gate_rolls_back_an_aliasing_rewrite(monkeypatch):
    """A rewrite whose merge log fails the aliasing proof (V010) is
    refused and the program comes back intact, as in the JAX package;
    the proof itself flags a merge into storage that is still live."""
    pkg = _pkg("port")
    main, _, cost = _mlp(pkg)
    cfg = pkg.mot.ControlFlowGraph(main.global_block())
    last = cfg.last_use_index()
    live = max(last, key=last.get)  # used by the last op
    assert [d[0] for d in pkg.mot._check_reuse_events(
        cfg, [(1, "a", live)])] == ["V010"]
    before = main.to_bytes()
    monkeypatch.setattr(pkg.mot, "_check_reuse_events", lambda cfg, ev: [
        ("V010", "op 1", "forced")] if ev else [])
    with pytest.raises(pkg.mot.RewriteError, match="V010"):
        pkg.mot.memory_optimize(main, skip_opt_set={cost.name})
    assert main.to_bytes() == before
    monkeypatch.undo()
    assert pkg.mot.memory_optimize(main, skip_opt_set={cost.name}) > 0


@pytest.mark.parametrize("build", sorted(BUILDS))
def test_debugger_graphviz_and_net_drawer_text_equal_jax(build, tmp_path):
    texts = {}
    for name in PKGS:
        pkg = _pkg(name)
        main, _, cost = BUILDS[build](pkg)
        pkg.graphviz.Node.counter = 0
        g = pkg.net_drawer.draw_program(main, title="t")
        pkg.graphviz.Node.counter = 0
        dot_path = tmp_path / f"{name}.dot"
        pkg.net_drawer.draw_graph(None, main, dot_path=str(dot_path))
        pkg.graphviz.Node.counter = 0
        gen = pkg.graphviz.GraphPreviewGenerator("api")
        a = gen.add_param("w", "float32", (2, 3))
        b = gen.add_op("mul")
        c = gen.add_var("out", "float32", (4, 3))
        gen.add_edge(a, b)
        gen.add_edge(b, c, color="red")
        gen.graph.rank_group("same", a)
        texts[name] = (pkg.debugger.to_code(main),
                       pkg.debugger.draw_block_graphviz(
                           main.global_block(), highlights=[cost.name]),
                       g.graph.code(), dot_path.read_text(),
                       gen.graph.code())
    for got, want in zip(texts["port"], texts["jax"]):
        if got != want:  # the int64 the port keeps where JAX has int32
            got = got.replace("int64", "int32")
            want = want.replace("int64", "int32")
        assert got == want
    assert "digraph" in texts["port"][1] and "mul" in texts["port"][0]


def _profile_rows(pkg, path, capsys):
    main, startup, cost = _mlp(pkg)
    scope, exe = pkg.fluid.Scope(), pkg.exe()
    exe.run(startup, scope=scope)
    feeds = _feeds("mlp_static", 2)
    capsys.readouterr()
    with pkg.profiler.profiler("All", "calls", profile_path=str(path)):
        for f in feeds:
            with pkg.profiler.RecordEvent("step"):
                exe.run(main, feed=f, fetch_list=[cost], scope=scope)
        with pkg.profiler.RecordEvent("tail"):
            pass
    first = capsys.readouterr().out.splitlines()
    pkg.profiler.start_profiler("CPU")
    with pkg.profiler.RecordEvent("second"):
        pass
    pkg.profiler.stop_profiler("total")
    second = capsys.readouterr().out.splitlines()
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    return first, second, names


def test_profiler_table_rows_and_trace_equal_jax(tmp_path, capsys):
    """The same RecordEvents give the JAX package's table rows (event
    names and calls, in order by calls; the times are each run's own)
    and header, and the exported trace names them and the executor's
    steps."""
    got = {n: _profile_rows(_pkg(n), tmp_path / f"{n}.json", capsys)
           for n in PKGS}
    (j1, j2, jn), (t1, t2, tn) = got["jax"], got["port"]
    assert t1[0] == j1[0] == t2[0]
    assert [r.split()[:2] for r in t1[1:]] == \
        [r.split()[:2] for r in j1[1:]] == [["step", "2"], ["tail", "1"]]
    assert [r.split()[:2] for r in t2[1:]] == \
        [r.split()[:2] for r in j2[1:]] == [["second", "1"]]
    assert {"step", "tail", "executor.step"} <= tn
    assert {"step", "tail"} <= jn
