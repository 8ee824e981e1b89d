"""The port's ParallelExecutor (``paddle_tpu_torch/fluid/parallel_executor.py``)
on a DTensor mesh, against its plain Executor and the JAX package's
ParallelExecutor, on the CPU.

The JAX side runs in this process on the 8-device virtual mesh of
``tests/conftest.py``. The port's side runs in a gloo world of spawned CPU
ranks (one per device; a ``file://`` store under ``tmp_path``, one thread
each), given the JAX startup's state and the feeds as ``.npz`` files; one
spawn per world size. This file imports only numpy, torch and pytest at
the top, so the ranks never import jax.

Cases (world 8 unless named): the DP MLP of tests/test_parallel_executor.py
(ranks' scopes perturbed by rank: state goes on the mesh from rank 0); the
Transformer on dp=2 x tp=2 x fsdp=2 under ``transformer_rules`` (the
``enc0.self.q.w`` and ``_moment1_0`` placements, at least one all-reduce);
with dropout on dp=2 x tp=2, the single-device masks; ``plan_fsdp`` against
``plan_data_parallel``; ResNet-cifar under DP with its batch-norm
statistics; the train/test ``share_vars_from`` pair; ``FLAGS['mesh_axes']``;
``ParallelDo`` under the executor; ``fluid.io`` from the sharded scope
(the bytes of a single-device scope holding the same values); and
``plan_transformer_tp`` on dp=2 x tp=2 (world 4); a mesh of one device
starting its own group (world 1); ``collect_cost``'s flops on the MLP at
dp=8 and dp=1 (world 1) against XLA's. Tolerances: the sharded
run against the port's single run rtol 1e-5; against the JAX run rtol
2e-5; the flops rtol 0.1 (``COST_RTOL``'s comment says why).
"""
import json
import os
import types

import numpy as np
import pytest
import torch

SELF_RTOL = 1e-5     # the port's sharded run against its single run
JAX_RTOL = 2e-5      # ... against the JAX package's sharded run
JOIN_TIMEOUT_S = 600
# collect_cost's flops against XLA's cost analysis, once the product that
# only the port runs is taken out (test_collect_cost_flops_against_xla):
# the rest differs by the elementwise accounting. XLA counts the optimized
# HLO's element ops (compares, selects, reduction adds); CostProbe counts
# one flop an output element of the arithmetic aten ops. On the MLP that
# is ~6.5% of the total.
COST_RTOL = 0.1


# --- the program builders, one body for either package --------------------

def _port():
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import mesh, parallel
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.fluid import layers, unique_name
    from paddle_tpu_torch.models import resnet, transformer

    return types.SimpleNamespace(fluid=fluid, layers=layers,
                                 unique_name=unique_name, mesh=mesh,
                                 parallel=parallel, transformer=transformer,
                                 resnet=resnet, set_flags=set_flags)


def _jax():
    import paddle_tpu.fluid as fluid
    from paddle_tpu import mesh, parallel
    from paddle_tpu.fluid import layers, unique_name
    from paddle_tpu.fluid.flags import set_flags
    from paddle_tpu.models import resnet, transformer

    return types.SimpleNamespace(fluid=fluid, layers=layers,
                                 unique_name=unique_name, mesh=mesh,
                                 parallel=parallel, transformer=transformer,
                                 resnet=resnet, set_flags=set_flags)


def _programs(pkg, seed):
    main, startup = pkg.fluid.Program(), pkg.fluid.Program()
    main.random_seed = startup.random_seed = seed
    return main, startup


def build_mlp(pkg, seed=7, opt="sgd", lr=0.1, act="relu", prefix=""):
    fluid, layers = pkg.fluid, pkg.layers
    main, startup = _programs(pkg, seed)
    with pkg.unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data(name="x", shape=[16], dtype="float32")
        y = layers.data(name="y", shape=[1], dtype="float32")
        h = layers.fc(input=x, size=32, act=act,
                      param_attr=fluid.ParamAttr(name=prefix + "w1"),
                      bias_attr=fluid.ParamAttr(name=prefix + "b1"))
        p = layers.fc(input=h, size=1,
                      param_attr=fluid.ParamAttr(name=prefix + "w2"),
                      bias_attr=fluid.ParamAttr(name=prefix + "b2"))
        cost = layers.mean(layers.square_error_cost(input=p, label=y))
        test = main.clone(for_test=True)
        if opt == "sgd":
            fluid.optimizer.SGD(learning_rate=lr).minimize(cost)
        else:
            fluid.optimizer.Adam(learning_rate=lr).minimize(cost)
    return main, startup, cost, test


TCFG = dict(src_vocab=40, trg_vocab=40, max_len=8, d_model=32, n_heads=4,
            d_ff=64, n_layers=1, seq_parallel=True)


def build_transformer(pkg, dropout=0.0):
    fluid, layers = pkg.fluid, pkg.layers
    cfg = pkg.transformer.TransformerConfig(dropout=dropout, **TCFG)
    main, startup = _programs(pkg, 5)
    with pkg.unique_name.guard(), fluid.program_guard(main, startup):
        src = layers.data(name="src", shape=[cfg.max_len], dtype="int64")
        trg = layers.data(name="trg", shape=[cfg.max_len], dtype="int64")
        lbl = layers.data(name="lbl", shape=[cfg.max_len, 1], dtype="int64")
        cost, _ = pkg.transformer.build_train(cfg, src, trg, lbl)
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(cost)
    return main, startup, cost, None


def build_transformer_dropout(pkg):
    return build_transformer(pkg, dropout=0.1)


def build_resnet(pkg):
    fluid, layers = pkg.fluid, pkg.layers
    main, startup = _programs(pkg, 61)
    with pkg.unique_name.guard(), fluid.program_guard(main, startup):
        img = layers.data(name="img", shape=[3, 16, 16], dtype="float32")
        label = layers.data(name="label", shape=[1], dtype="int64")
        net = pkg.resnet.resnet_cifar10(img, class_dim=10, depth=8)
        logits = layers.fc(input=net, size=10)
        cost = layers.mean(layers.softmax_with_cross_entropy(
            logits=logits, label=label))
        # Momentum, not Adam: Adam's first steps move a parameter by ~lr
        # whatever the size of its gradient, so a near-zero gradient whose
        # sign a reduction reorder flips moves the loss by ~1e-4 (the JAX
        # package's own dp=8 run and single run differ so)
        fluid.optimizer.Momentum(learning_rate=0.05,
                                 momentum=0.9).minimize(cost)
    return main, startup, cost, None


def build_parallel_do(pkg):
    fluid, layers = pkg.fluid, pkg.layers
    main, startup = _programs(pkg, 19)
    with pkg.unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data(name="x", shape=[16], dtype="float32")
        y = layers.data(name="y", shape=[1], dtype="float32")
        pd = layers.ParallelDo(layers.get_places())
        with pd.do():
            x_, y_ = pd.read_input(x), pd.read_input(y)
            h = layers.fc(input=x_, size=32, act="tanh")
            p = layers.fc(input=h, size=1)
            pd.write_output(layers.square_error_cost(input=p, label=y_))
        cost = layers.mean(pd())
        fluid.optimizer.SGD(learning_rate=0.1).minimize(cost)
    return main, startup, cost, None


def _mlp_feeds(n=5, rows=64):
    rng = np.random.RandomState(0)
    w = rng.rand(16, 1).astype(np.float32)
    out = []
    for _ in range(n):
        x = rng.rand(rows, 16).astype(np.float32)
        out.append({"x": x, "y": (x @ w).astype(np.float32)})
    return out


def _transformer_feeds(n=3, batch=8):
    rng = np.random.RandomState(0)
    out = []
    for _ in range(n):
        s = rng.randint(3, TCFG["src_vocab"],
                        size=(batch, TCFG["max_len"])).astype(np.int64)
        t = np.concatenate([np.zeros((batch, 1), np.int64), s[:, :-1]],
                           axis=1)
        out.append({"src": s, "trg": t, "lbl": s[:, :, None]})
    return out


def _resnet_feeds(n=3, batch=16):
    rng = np.random.RandomState(0)
    return [{"img": rng.rand(batch, 3, 16, 16).astype(np.float32),
             "label": rng.randint(0, 10, size=(batch, 1)).astype(np.int64)}
            for _ in range(n)]


# name -> (builder, builder kwargs, feeds, mesh axes or None, plan name,
#          world)
CASES = {
    "dp_mlp": (build_mlp, {}, _mlp_feeds, None, None, 8),
    "transformer_3d": (build_transformer, {}, _transformer_feeds,
                       "dp=2,tp=2,fsdp=2", "transformer_rules", 8),
    "fsdp": (build_mlp, dict(seed=41, opt="adam", lr=0.01, act="tanh",
                             prefix="fsdp."),
             lambda: _mlp_feeds(6, 16), "dp=8", "plan_fsdp", 8),
    "fsdp_dp": (build_mlp, dict(seed=41, opt="adam", lr=0.01, act="tanh",
                                prefix="fsdp."),
                lambda: _mlp_feeds(6, 16), "dp=8", "plan_data_parallel", 8),
    "resnet": (build_resnet, {}, _resnet_feeds, "dp=8",
               "plan_data_parallel", 8),
    "parallel_do": (build_parallel_do, {}, lambda: _mlp_feeds(3, 32),
                    "dp=8", "plan_data_parallel", 8),
    "flags": (build_mlp, dict(seed=3), lambda: _mlp_feeds(2, 8),
              "flags:dp=4,tp=2", None, 8),
    "transformer_tp": (build_transformer, {}, _transformer_feeds,
                       "dp=2,tp=2", "plan_transformer_tp", 4),
    "transformer_dropout": (build_transformer_dropout, {},
                            _transformer_feeds, "dp=2,tp=2",
                            "plan_transformer_tp", 4),
    # collect_cost=True on both sides (the cases named cost_*)
    "cost_mlp": (build_mlp, dict(seed=13), lambda: _mlp_feeds(2, 64),
                 "dp=8", None, 8),
    "cost_mlp_one": (build_mlp, dict(seed=13), lambda: _mlp_feeds(2, 64),
                     "dp=1", None, 1),
}


def _plan(pkg, name):
    if name is None:
        return None
    if name == "transformer_rules":
        return pkg.mesh.transformer_rules()
    return getattr(pkg.parallel, name)()


def _state(scope):
    return {n: np.asarray(scope.find_var(n)) for n in scope.var_names()
            if hasattr(scope.find_var(n), "shape")}


def _loss(v):
    return float(np.ravel(np.asarray(v))[0])


def _bn_names(main):
    return sorted(n for n, v in main.global_block().vars.items()
                  if v.persistable and ("batch_norm" in n)
                  and (".w_1" in n or ".w_2" in n))


# --- the JAX package's side (this process) --------------------------------

def _jax_run(name, job):
    """The JAX ParallelExecutor's losses of a case, after saving its
    startup state and feeds for the port's ranks."""
    pkg = _jax()
    build, kw, feeds_fn, axes, plan, _ = CASES[name]
    feeds = feeds_fn()
    main, startup, cost, _ = build(pkg, **kw)
    scope = pkg.fluid.Scope()
    with pkg.fluid.scope_guard(scope):
        pkg.fluid.Executor().run(startup)
        state = _state(scope)
        np.savez(os.path.join(job, f"{name}.state.npz"), **state)
        np.savez(os.path.join(job, f"{name}.feeds.npz"),
                 **{f"{i}/{k}": v for i, f in enumerate(feeds)
                    for k, v in f.items()})
        mesh = None
        if axes is not None and axes.startswith("flags:"):
            pkg.set_flags({"mesh_axes": axes[len("flags:"):]})
        elif axes is not None:
            mesh = pkg.mesh.MeshSpec.parse(axes)
        try:
            pe = pkg.fluid.ParallelExecutor(
                use_cuda=False, loss_name=cost.name, main_program=main,
                mesh=mesh, sharding_plan=_plan(pkg, plan),
                collect_cost=name.startswith("cost_"))
        finally:
            pkg.set_flags({"mesh_axes": ""})
        losses = [_loss(pe.run(fetch_list=[cost], feed=f)[0])
                  for f in feeds]
        extra = {"cost": pe.last_cost_analysis}
        if name == "resnet":
            extra = {n: np.asarray(scope.find_var(n))
                     for n in _bn_names(main)}
    return np.asarray(losses), extra


# --- the port's side: single device (this process) and the ranks ---------

def _load_feeds(job, name):
    with np.load(os.path.join(job, f"{name}.feeds.npz")) as z:
        feeds = {}
        for k in z.files:
            i, key = k.split("/", 1)
            feeds.setdefault(int(i), {})[key] = z[k]
    return [feeds[i] for i in sorted(feeds)]


def _load_state(pkg, job, name, scope, bump=0.0):
    with np.load(os.path.join(job, f"{name}.state.npz")) as z:
        for n in z.files:
            v = torch.from_numpy(np.array(z[n]))
            if bump and v.is_floating_point():
                v = v + bump
            scope.set_var(n, v)


def _port_startup(name, job):
    """A port-only case's startup state and feeds, saved as the JAX side
    saves its cases'."""
    pkg = _port()
    build, kw, feeds_fn, _, _, _ = CASES[name]
    main, startup, _, _ = build(pkg, **kw)
    scope = pkg.fluid.Scope()
    pkg.fluid.Executor(pkg.fluid.CPUPlace()).run(startup, scope=scope)
    np.savez(os.path.join(job, f"{name}.state.npz"), **_state(scope))
    np.savez(os.path.join(job, f"{name}.feeds.npz"),
             **{f"{i}/{k}": v for i, f in enumerate(feeds_fn())
                for k, v in f.items()})


def _port_single(name, job, **kw):
    """The port's plain Executor on the CPU from the JAX startup state:
    the losses, and the final scope."""
    pkg = _port()
    build, bkw, _, _, _, _ = CASES[name]
    main, startup, cost, _ = build(pkg, **{**bkw, **kw})
    scope = pkg.fluid.Scope()
    _load_state(pkg, job, name, scope)
    exe = pkg.fluid.Executor(pkg.fluid.CPUPlace())
    losses = [_loss(exe.run(main, feed=f, fetch_list=[cost], scope=scope)[0])
              for f in _load_feeds(job, name)]
    return np.asarray(losses), scope, main


def _rank_case(pkg, name, job, rank):
    """One case on this rank's mesh: (losses, extra record)."""
    build, kw, _, axes, plan, _ = CASES[name]
    main, startup, cost, test = build(pkg, **kw)
    scope = pkg.fluid.Scope()
    # each rank's scope drawn differently: the mesh takes rank 0's
    _load_state(pkg, job, name, scope,
                bump=0.5 * rank if name == "dp_mlp" else 0.0)
    feeds = _load_feeds(job, name)
    extra = {}
    mesh = None
    if axes is not None and axes.startswith("flags:"):
        pkg.set_flags({"mesh_axes": axes[len("flags:"):]})
    elif axes is not None:
        mesh = axes
    with pkg.fluid.scope_guard(scope):
        try:
            pe = pkg.fluid.ParallelExecutor(
                use_cuda=False, loss_name=cost.name, main_program=main,
                mesh=mesh, sharding_plan=_plan(pkg, plan),
                collect_cost=name.startswith("cost_"))
        finally:
            pkg.set_flags({"mesh_axes": ""})
        extra["mesh"] = dict(zip(pe.mesh.mesh_dim_names,
                                 (int(s) for s in pe.mesh.shape)))
        losses = [_loss(pe.run(fetch_list=[cost], feed=f)[0])
                  for f in feeds]
        extra["cost"] = pe.last_cost_analysis
        if name == "dp_mlp":
            # the train/test pair: a for_test clone run through a second
            # executor that shares the first one's scope
            tpe = pkg.fluid.ParallelExecutor(
                use_cuda=False, main_program=test, share_vars_from=pe)
            t1 = _loss(tpe.run(fetch_list=[cost.name], feed=feeds[0])[0])
            t2 = _loss(tpe.run(fetch_list=[cost.name], feed=feeds[0])[0])
            pe.run(fetch_list=[cost], feed=feeds[0])
            t3 = _loss(tpe.run(fetch_list=[cost.name], feed=feeds[0])[0])
            extra["test_losses"] = [t1, t2, t3]
            extra["device_count"] = pe.device_count
    from torch.distributed.tensor import DTensor

    extra["placements"] = {
        n: [repr(p) for p in scope.find_var(n).placements]
        for n in scope.var_names()
        if isinstance(scope.find_var(n), DTensor)}
    if name == "resnet":
        extra["bn"] = {n: pkg.fluid.fetch_var(n, scope).tolist()
                       for n in _bn_names(main)}
    if name == "transformer_3d":
        from paddle_tpu_torch.observability import metrics

        extra["collectives"] = {
            k: v for k, v in metrics.snapshot("mesh.collectives.").items()}
        extra["q_w"] = pkg.fluid.fetch_var("enc0.self.q.w", scope).tolist()
        _save_io(pkg, main, scope, job, rank)
    return losses, extra


def _save_io(pkg, main, scope, job, rank):
    """fluid.io from the sharded scope: every rank calls, rank 0 writes
    (and writes the full values for the single-scope comparison)."""
    fluid = pkg.fluid
    sharded = os.path.join(job, "io_sharded")
    fluid.io.save_persistables(None, os.path.join(sharded, "manifest"),
                               main_program=main, scope=scope)
    fluid.io.save_persistables(None, os.path.join(sharded, "combined"),
                               main_program=main, filename="all.npz",
                               scope=scope)
    fluid.io.save_checkpoint(os.path.join(sharded, "ckpt"),
                             main_program=main, step=3, scope=scope)
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(
            os.path.join(sharded, "infer"), ["src", "trg"],
            [main.global_block().var("mean_0.tmp_0")], None,
            main_program=main)
    full = {n: fluid.fetch_var(n, scope) for n in scope.var_names()
            if hasattr(scope.find_var(n), "shape")}
    if rank == 0:
        np.savez(os.path.join(job, "io_values.npz"), **full)


def _rank_main(rank, world, store, job):
    import logging

    torch.set_num_threads(1)
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        pkg = _port()
        out = {}
        for name, case in CASES.items():
            if case[5] != world:
                continue
            losses, extra = _rank_case(pkg, name, job, rank)
            out[name] = {"losses": losses, **extra}
        if rank == 0:
            with open(os.path.join(job, f"world{world}.json"), "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _join(ctx, timeout_s):
    import time

    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.01)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            pytest.fail(f"the spawned ranks did not finish in {timeout_s} s")


def _spawn(world, job):
    import torch.multiprocessing as mp

    ctx = mp.spawn(_rank_main, args=(world, os.path.join(job, f"store{world}"),
                                     job),
                   nprocs=world, join=False)
    _join(ctx, JOIN_TIMEOUT_S)
    with open(os.path.join(job, f"world{world}.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case: the JAX run (this process), the port's ranks (one
    spawn per world size)."""
    job = str(tmp_path_factory.mktemp("pe_job"))
    jax_out = {name: _jax_run(name, job) for name in CASES
               if CASES[name][0] is not build_transformer_dropout}
    _port_startup("transformer_dropout", job)
    port = {}
    for world in sorted({c[5] for c in CASES.values()}):
        port.update(_spawn(world, job))
    return types.SimpleNamespace(job=job, jax=jax_out, port=port)


def _close(got, want, rtol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=1e-7, err_msg=what)


# --- the cases -------------------------------------------------------------

def test_dp_mlp_matches_single_and_jax_from_rank0_state(runs):
    """tests/test_parallel_executor.py:12 on the port: data parallel over a
    world of 8, the default mesh (no mesh=: one dp axis over the world).
    Every rank's scope held different values; the mesh took rank 0's."""
    got = runs.port["dp_mlp"]
    assert got["mesh"] == {"dp": 8} and got["device_count"] == 8
    single, _, _ = _port_single("dp_mlp", runs.job)
    _close(got["losses"], single, SELF_RTOL, "vs the port's single run")
    _close(got["losses"], runs.jax["dp_mlp"][0], JAX_RTOL, "vs JAX")
    assert got["losses"][-1] < got["losses"][0]


def test_train_then_test_executor_shares_vars(runs):
    """tests/test_parallel_executor.py's share_vars_from pair: the test
    executor does not update state and sees the trained values."""
    t1, t2, t3 = runs.port["dp_mlp"]["test_losses"]
    assert t1 == t2
    assert t3 < t1


def test_transformer_dp_tp_fsdp_matches_single_and_jax(runs):
    """tests/test_mesh.py:111 on the port: one Adam step a feed on dp=2 x
    tp=2 x fsdp=2 (world 8) under transformer_rules(): losses against the
    single-device run and the JAX sharded run; the weight and its first
    moment held as ("fsdp", "tp"); collectives counted."""
    got = runs.port["transformer_3d"]
    single, scope, _ = _port_single("transformer_3d", runs.job)
    _close(got["losses"], single, SELF_RTOL, "vs the port's single run")
    _close(got["losses"], runs.jax["transformer_3d"][0], JAX_RTOL, "vs JAX")
    want = ["Replicate()", "Shard(dim=1)", "Shard(dim=0)"]  # dp, tp, fsdp
    assert got["placements"]["enc0.self.q.w"] == want
    assert got["placements"]["enc0.self.q.w_moment1_0"] == want
    q_w = np.asarray(scope.find_var("enc0.self.q.w"))
    np.testing.assert_allclose(got["q_w"], q_w, rtol=1e-4, atol=1e-6)
    assert got["collectives"]["mesh.collectives.all_reduce"] >= 1


def test_transformer_tp_plan_on_dp2_tp2(runs):
    """plan_transformer_tp() on dp=2 x tp=2 (world 4): q/k/v column
    parallel, (None, "tp") on the weight and its moments."""
    got = runs.port["transformer_tp"]
    assert got["mesh"] == {"dp": 2, "tp": 2}
    single, _, _ = _port_single("transformer_tp", runs.job)
    _close(got["losses"], single, SELF_RTOL, "vs the port's single run")
    _close(got["losses"], runs.jax["transformer_tp"][0], JAX_RTOL, "vs JAX")
    want = ["Replicate()", "Shard(dim=1)"]
    assert got["placements"]["enc0.self.q.w"] == want
    assert got["placements"]["enc0.self.q.w_moment1_0"] == want
    assert got["placements"]["enc0.self.out.w"] == ["Replicate()",
                                                    "Shard(dim=0)"]


def test_fsdp_plan_shards_state_and_matches_dp(runs):
    """plan_fsdp(): parameters and Adam moments shard dim 0 over dp while
    the losses stay those of plan_data_parallel() (and of the JAX run);
    the [1]-wide bias and scalars replicate."""
    fsdp, dp = runs.port["fsdp"], runs.port["fsdp_dp"]
    _close(fsdp["losses"], dp["losses"], SELF_RTOL, "fsdp vs dp")
    _close(fsdp["losses"], runs.jax["fsdp"][0], JAX_RTOL, "vs JAX fsdp")
    _close(dp["losses"], runs.jax["fsdp_dp"][0], JAX_RTOL, "vs JAX dp")
    moment = next(n for n in fsdp["placements"]
                  if n.startswith("fsdp.w1_moment1"))
    for n in ("fsdp.w1", moment):
        assert fsdp["placements"][n] == ["Shard(dim=0)"], n
    assert fsdp["placements"]["fsdp.b2"] == ["Replicate()"]
    assert dp["placements"]["fsdp.w1"] == ["Replicate()"]


def test_resnet_cifar_dp_batch_norm_statistics(runs):
    """ResNet-cifar (depth 8) under DP over 8 ranks: losses and every
    batch norm's running mean and variance equal the single run's (global
    batch statistics) and the JAX run's."""
    got = runs.port["resnet"]
    single, scope, main = _port_single("resnet", runs.job)
    _close(got["losses"], single, SELF_RTOL, "vs the port's single run")
    jax_losses, jax_bn = runs.jax["resnet"]
    _close(got["losses"], jax_losses, JAX_RTOL, "vs JAX")
    names = _bn_names(main)
    assert names and set(got["bn"]) == set(names)
    for n in names:
        np.testing.assert_allclose(got["bn"][n], np.asarray(scope.find_var(n)),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
        np.testing.assert_allclose(got["bn"][n], jax_bn[n], rtol=2e-5,
                                   atol=1e-6, err_msg=n)


def test_parallel_do_under_the_executor(runs):
    """A ParallelDo region under the ParallelExecutor (dp=8): the sub-block
    runs once over the sharded batch; losses as the single run's and the
    JAX run's."""
    got = runs.port["parallel_do"]
    single, _, _ = _port_single("parallel_do", runs.job)
    _close(got["losses"], single, SELF_RTOL, "vs the port's single run")
    _close(got["losses"], runs.jax["parallel_do"][0], JAX_RTOL, "vs JAX")


def test_mesh_axes_flag_is_the_default_mesh(runs):
    """FLAGS['mesh_axes'] = 'dp=4,tp=2': an executor built with no mesh=
    trains on the flag's mesh."""
    got = runs.port["flags"]
    assert got["mesh"] == {"dp": 4, "tp": 2}
    single, _, _ = _port_single("flags", runs.job)
    _close(got["losses"], single, SELF_RTOL, "vs the port's single run")
    _close(got["losses"], runs.jax["flags"][0], JAX_RTOL, "vs JAX")


def _files(d):
    """Every file's bytes by relative path; a manifest's payload carries a
    fresh nonce in its name (``segments-<nonce>.bin``), which is read as
    ``segments-N.bin`` in names and contents."""
    import re

    out, nonces = {}, set()
    for root, _, names in os.walk(d):
        for n in names:
            p = os.path.join(root, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
            nonces.update(re.findall(r"segments-([0-9a-f]+)\.bin", n))
    for nonce in nonces:
        out = {k.replace(nonce, "N"): v.replace(nonce.encode(), b"N")
               for k, v in out.items()}
    return out


@pytest.mark.parametrize("form", ["manifest", "combined", "ckpt", "infer"])
def test_io_from_a_sharded_scope_writes_single_scope_bytes(runs, form):
    """fluid.io from the dp x tp x fsdp scope: the full tensors, in the
    bytes a single-device scope holding the same values writes."""
    pkg = _port()
    fluid = pkg.fluid
    main, _, _, _ = build_transformer(pkg)
    scope = fluid.Scope()
    with np.load(os.path.join(runs.job, "io_values.npz")) as z:
        for n in z.files:
            scope.set_var(n, torch.from_numpy(np.array(z[n])))
    plain = os.path.join(runs.job, "io_plain")
    if form == "manifest":
        fluid.io.save_persistables(None, os.path.join(plain, form),
                                   main_program=main, scope=scope)
    elif form == "combined":
        fluid.io.save_persistables(None, os.path.join(plain, form),
                                   main_program=main, filename="all.npz",
                                   scope=scope)
    elif form == "ckpt":
        fluid.io.save_checkpoint(os.path.join(plain, form),
                                 main_program=main, step=3, scope=scope)
    else:
        with fluid.scope_guard(scope):
            fluid.io.save_inference_model(
                os.path.join(plain, form), ["src", "trg"],
                [main.global_block().var("mean_0.tmp_0")], None,
                main_program=main)
    got = _files(os.path.join(runs.job, "io_sharded", form))
    want = _files(os.path.join(plain, form))
    assert got and set(got) == set(want)
    for name in want:
        assert got[name] == want[name], name


def test_dropout_masks_match_the_single_step(runs):
    """The Transformer with dropout 0.1 on dp=2 x tp=2: the emitters'
    dropout masks are plain tensors of the global shape drawn from the
    step's seeded generator, the single-device step's masks, so the
    losses are the plain Executor's."""
    got = runs.port["transformer_dropout"]
    single, _, _ = _port_single("transformer_dropout", runs.job)
    _close(got["losses"], single, SELF_RTOL, "vs the port's single run")


def test_collect_cost_flops_against_xla(runs):
    """``collect_cost=True``: ``last_cost_analysis['flops']`` is
    ``autotune.CostProbe``'s count of the first step's dispatched ops:
    FlopCounterMode's matmul flops plus one an output element of each
    elementwise arithmetic op (the JAX figure is XLA's, elementwise
    included); ``bytes_accessed`` is -1 (not counted). Two differences
    are decided, not tolerated:
      - the port's generic grad path differentiates every floating
        input of a recorded op, the fed ``x`` included, so its step runs
        the first fc's input-gradient product (2 x rows x 16 x 32), which
        XLA drops as dead;
      - the port counts the step at the DTensor level: the global step,
        the same figure at dp=8 as at dp=1; XLA's is per device.
    Beyond the dead product, the flops agree within ``COST_RTOL``."""
    one, eight = runs.port["cost_mlp_one"], runs.port["cost_mlp"]
    jax_losses_one, jax_one = runs.jax["cost_mlp_one"]
    _jax_losses_eight, jax_eight = runs.jax["cost_mlp"]
    _close(one["losses"], jax_losses_one, JAX_RTOL, "dp=1 vs JAX")
    _close(eight["losses"], one["losses"], SELF_RTOL, "dp=8 vs dp=1")
    assert one["mesh"] == {"dp": 1} and eight["mesh"] == {"dp": 8}
    assert one["cost"]["bytes_accessed"] == -1.0
    assert eight["cost"] == one["cost"]
    rows = len(_mlp_feeds(1, 64)[0]["x"])
    dead = 2 * rows * 16 * 32
    np.testing.assert_allclose(one["cost"]["flops"] - dead,
                               jax_one["cost"]["flops"], rtol=COST_RTOL)
    # XLA's figure is the per-device executable's: an eighth of the
    # products at dp=8, the replicated update whole
    assert jax_eight["cost"]["flops"] < jax_one["cost"]["flops"] / 4


def test_a_mesh_of_one_device_starts_its_own_group(tmp_path):
    """With no process group, a mesh of one device: the executor starts a
    one-rank gloo group on a FileStore (in a spawned process, so this
    one keeps none) and runs the whole DTensor path; the losses are
    bitwise the plain Executor's, no collective runs."""
    import torch.multiprocessing as mp

    out = str(tmp_path / "one.json")
    ctx = mp.spawn(_one_device_rank, args=(out,), nprocs=1, join=False)
    _join(ctx, JOIN_TIMEOUT_S)
    with open(out) as f:
        r = json.load(f)
    assert r["pe"] == r["plain"]
    assert r["world"] == 1 and r["backend"] == "gloo"
    assert r["collectives"] == 0 and r["mesh"] == {"dp": 1}


def _one_device_rank(rank, out):
    import torch.distributed as dist

    torch.set_num_threads(1)
    pkg = _port()
    feeds = _mlp_feeds(3, 16)
    res = {}
    for way in ("plain", "pe"):
        main, startup, cost, _ = build_mlp(pkg, opt="adam", lr=0.01)
        scope = pkg.fluid.Scope()
        exe = pkg.fluid.Executor(pkg.fluid.CPUPlace())
        exe.run(startup, scope=scope)
        if way == "plain":
            res[way] = [_loss(exe.run(main, feed=f, fetch_list=[cost],
                                      scope=scope)[0]) for f in feeds]
            continue
        assert not dist.is_initialized()
        with pkg.fluid.scope_guard(scope):
            pe = pkg.fluid.ParallelExecutor(
                use_cuda=False, loss_name=cost.name, main_program=main)
        res[way] = [_loss(pe.run(fetch_list=[cost], feed=f)[0])
                    for f in feeds]
        res["mesh"] = dict(zip(pe.mesh.mesh_dim_names,
                               (int(s) for s in pe.mesh.shape)))
    from paddle_tpu_torch.observability import metrics

    res["world"] = dist.get_world_size()
    res["backend"] = str(dist.get_backend())
    res["collectives"] = sum(metrics.snapshot(
        "mesh.collectives.").values())
    with open(out, "w") as f:
        json.dump(res, f)
