"""GPipe pipelines in the port (``parallel/pipeline.py``,
``fluid/ops/pipeline_op.py``, ``layers.Pipeline``) against sequential
stages and the JAX package, on the CPU.

The pipelined runs use one spawned gloo world of four CPU ranks (a
``file://`` store under the test's temporary directory, one thread a
rank): ``pipeline_apply`` over pp=4, and the Program region trained under
the ParallelExecutor over pp=4 and dp=2 x pp=2, from the JAX startup
state saved as ``.npz``. The JAX side runs in the pytest process on the
8-device virtual mesh (``tests/test_program_pipeline.py``'s programs).
This file imports only numpy, torch and pytest at the top, so the ranks
never import jax.

Tolerances: ``pipeline_apply`` and its gradients within 1e-5 of the same
stages run in sequence (float32; a microbatch's rows are the batch's
rows); the region's losses within 1e-5 of the port's sequential run and
2e-5 of the JAX package's pipelined run.
"""
import json
import os
import types

import numpy as np
import pytest
import torch

WORLD = 4
JOIN_TIMEOUT_S = 300
ATOL = 1e-5
SELF_RTOL = 1e-5
JAX_RTOL = 2e-5
D = 8
BATCH = 16
STEPS = 3
# name -> (stages, microbatches, mesh axes of the pipelined run)
REGIONS = {"pp4": (4, 4, "pp=4"), "dp2_pp2": (2, 2, "dp=2,pp=2")}


def _pkg(which):
    if which == "port":
        import paddle_tpu_torch.fluid as fluid
        from paddle_tpu_torch.fluid import layers, unique_name
    else:
        import paddle_tpu.fluid as fluid
        from paddle_tpu.fluid import layers, unique_name
    return types.SimpleNamespace(fluid=fluid, layers=layers,
                                 unique_name=unique_name)


def build(pkg, n_stages, n_micro=4, seed=11, break_shape=False):
    """tests/test_program_pipeline.py:17's model: x -> [n_stages x (fc
    D->D tanh)] staged region -> mean-square loss, SGD. ``break_shape``
    widens the first stage's output (:120)."""
    fluid, layers = pkg.fluid, pkg.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data(name="x", shape=[D], dtype="float32")
        y = layers.data(name="y", shape=[D], dtype="float32")
        pipe = layers.Pipeline(x, n_microbatches=n_micro)
        with pipe.block():
            h = pipe.input
            for s in range(n_stages):
                size = 2 * D if break_shape and s == 0 else D
                h = layers.fc(input=h, size=size, act="tanh")
                if s < n_stages - 1:
                    h = pipe.cut(h)
        out = pipe.output(h)
        loss = layers.mean(layers.square_error_cost(input=out, label=y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _feed(seed=1):
    rng = np.random.RandomState(seed)
    x = rng.rand(BATCH, D).astype(np.float32)
    y = np.tanh(x @ rng.rand(D, D).astype(np.float32))
    return {"x": x, "y": y}


def _loss(v):
    return float(np.ravel(np.asarray(v))[0])


def _state(scope):
    return {n: np.asarray(scope.find_var(n)) for n in scope.var_names()
            if hasattr(scope.find_var(n), "shape")}


def _port_losses(name, job, mesh=None):
    """The port's run of a region from the JAX startup state: the plain
    Executor (``mesh=None``: the stages in sequence) or the
    ParallelExecutor on ``mesh``."""
    pkg = _pkg("port")
    stages, n_micro, _ = REGIONS[name]
    main, _, loss = build(pkg, stages, n_micro)
    scope = pkg.fluid.Scope()
    with np.load(os.path.join(job, f"{name}.npz")) as z:
        for n in z.files:
            scope.set_var(n, torch.from_numpy(np.array(z[n])))
    if mesh is None:
        exe = pkg.fluid.Executor(pkg.fluid.CPUPlace())
        return [_loss(exe.run(main, feed=_feed(), fetch_list=[loss],
                              scope=scope)[0]) for _ in range(STEPS)]
    with pkg.fluid.scope_guard(scope):
        pe = pkg.fluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                        main_program=main, mesh=mesh)
        return [_loss(pe.run(fetch_list=[loss], feed=_feed())[0])
                for _ in range(STEPS)]


# --- pipeline_apply ------------------------------------------------------------

def _stage_fn(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _stage_params(n_stages=4, seed=0):
    rng = np.random.RandomState(seed)
    return [{"w": (rng.randn(D, D) * 0.5).astype(np.float32),
             "b": (rng.randn(D) * 0.1).astype(np.float32)}
            for _ in range(n_stages)]


def _apply_input(seed=2):
    return np.random.RandomState(seed).randn(BATCH, D).astype(np.float32)


def _sequential(per_stage, x):
    """The stages one after another, and the gradients of sum(sin(out))."""
    ps = [{k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
          for p in per_stage]
    xt = torch.tensor(x, requires_grad=True)
    h = xt
    for p in ps:
        h = _stage_fn(p, h)
    torch.sin(h).sum().backward()
    return (h.detach().numpy(), xt.grad.numpy(),
            np.stack([p["w"].grad.numpy() for p in ps]),
            np.stack([p["b"].grad.numpy() for p in ps]))


def _rank_apply(mesh):
    from paddle_tpu_torch.parallel import (pipeline_apply,
                                           shard_stage_params,
                                           stack_stage_params)

    per_stage = [{k: torch.from_numpy(v) for k, v in p.items()}
                 for p in _stage_params()]
    params = shard_stage_params(stack_stage_params(per_stage), mesh)
    for p in params.values():
        p.requires_grad_()
    x = torch.from_numpy(_apply_input()).requires_grad_()
    out = pipeline_apply(_stage_fn, params, x, mesh, "pp",
                         n_microbatches=8)
    torch.sin(out.full_tensor()).sum().backward()
    return {"out": out.full_tensor().detach().numpy().tolist(),
            "dx": x.grad.numpy().tolist(),
            "dw": params["w"].grad.full_tensor().numpy().tolist(),
            "db": params["b"].grad.full_tensor().numpy().tolist(),
            "w_placements": [repr(p) for p in params["w"].placements]}


def _rank_errors(pkg):
    """The region's checks under a pp mesh, on every rank."""
    out = {}
    for key, (stages, axes, kw) in {
            "count": (3, "pp=4", {}),
            "shape": (2, "dp=2,pp=2", {"break_shape": True})}.items():
        main, startup, loss = build(pkg, stages, 2, **kw)
        scope = pkg.fluid.Scope()
        pkg.fluid.Executor(pkg.fluid.CPUPlace()).run(startup, scope=scope)
        with pkg.fluid.scope_guard(scope):
            pe = pkg.fluid.ParallelExecutor(use_cuda=False, mesh=axes,
                                            main_program=main)
            try:
                pe.run(fetch_list=[loss], feed=_feed())
            except ValueError as e:
                out[key] = str(e)
    return out


def _rank_main(rank, store, job):
    import logging

    torch.set_num_threads(1)
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    import torch.distributed as dist

    from paddle_tpu_torch.mesh import MeshSpec

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    try:
        out = {"apply": _rank_apply(MeshSpec.parse("pp=4").build("cpu")),
               "losses": {name: _port_losses(name, job, axes)
                          for name, (_, _, axes) in REGIONS.items()},
               "errors": _rank_errors(_pkg("port"))}
        with open(os.path.join(job, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _jax_losses(name, job):
    """The JAX ParallelExecutor's pipelined run, after saving the startup
    state for the port."""
    import jax

    from paddle_tpu.parallel import make_mesh

    pkg = _pkg("jax")
    stages, n_micro, axes = REGIONS[name]
    main, startup, loss = build(pkg, stages, n_micro)
    ax = {a.split("=")[0]: int(a.split("=")[1]) for a in axes.split(",")}
    scope = pkg.fluid.Scope()
    with pkg.fluid.scope_guard(scope):
        pkg.fluid.Executor().run(startup)
        np.savez(os.path.join(job, f"{name}.npz"), **_state(scope))
        mesh = make_mesh(ax, devices=jax.devices()[:int(np.prod(
            list(ax.values())))])
        pe = pkg.fluid.ParallelExecutor(main_program=main, mesh=mesh,
                                        loss_name=loss.name)
        return [_loss(pe.run(feed=_feed(), fetch_list=[loss])[0])
                for _ in range(STEPS)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import time

    import torch.multiprocessing as mp

    job = str(tmp_path_factory.mktemp("pp_job"))
    jax_losses = {name: _jax_losses(name, job) for name in REGIONS}
    ctx = mp.spawn(_rank_main, args=(os.path.join(job, "store"), job),
                   nprocs=WORLD, join=False)
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.01)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            pytest.fail(f"the spawned ranks did not finish in "
                        f"{JOIN_TIMEOUT_S} s")
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(job, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return types.SimpleNamespace(job=job, ranks=ranks, jax=jax_losses)


def test_pipeline_apply_and_grads_match_sequential_stages(world):
    want = _sequential(_stage_params(), _apply_input())
    for r in world.ranks:
        got = r["apply"]
        assert got["w_placements"] == ["Shard(dim=0)"]
        for what, g, w in zip(("out", "dx", "dw", "db"),
                              (got["out"], got["dx"], got["dw"], got["db"]),
                              want):
            np.testing.assert_allclose(np.asarray(g), w, atol=ATOL, rtol=0,
                                       err_msg=what)


@pytest.mark.parametrize("name", sorted(REGIONS))
def test_region_trains_under_pp_as_sequential_and_jax(world, name):
    single = _port_losses(name, world.job)
    assert single[-1] < single[0]
    for r in world.ranks:
        got = r["losses"][name]
        np.testing.assert_allclose(got, single, rtol=SELF_RTOL, atol=0)
        np.testing.assert_allclose(got, world.jax[name], rtol=JAX_RTOL,
                                   atol=0)


def test_region_sequential_matches_jax_sequential(tmp_path):
    """Without a pp axis the region runs its stages in sequence, in
    either package: the same function."""
    jpkg, tpkg = _pkg("jax"), _pkg("port")
    main, startup, loss = build(jpkg, 4)
    jscope = jpkg.fluid.Scope()
    with jpkg.fluid.scope_guard(jscope):
        exe = jpkg.fluid.Executor()
        exe.run(startup)
        state = _state(jscope)
        jl = [_loss(exe.run(main, feed=_feed(), fetch_list=[loss])[0])
              for _ in range(STEPS)]
    main, _, loss = build(tpkg, 4)
    scope = tpkg.fluid.Scope()
    for n, v in state.items():
        scope.set_var(n, torch.from_numpy(np.array(v)))
    exe = tpkg.fluid.Executor(tpkg.fluid.CPUPlace())
    tl = [_loss(exe.run(main, feed=_feed(), fetch_list=[loss],
                        scope=scope)[0]) for _ in range(STEPS)]
    np.testing.assert_allclose(tl, jl, rtol=JAX_RTOL, atol=0)


def test_stage_count_and_shape_break_errors(world):
    """tests/test_program_pipeline.py:106 and :120: every rank refuses,
    with the JAX package's messages, before any stage sends."""
    for r in world.ranks:
        assert "3 stages" in r["errors"]["count"] and \
            "'pp' axis is 4" in r["errors"]["count"]
        assert "preserve" in r["errors"]["shape"]


def test_registry_holds_218_of_218_op_types():
    """``pipeline`` and ``pipeline_cut`` registered, and with the v2
    API's ``conv2d_input_filter`` every op type of the JAX package;
    counted over the port's own modules (other test files register
    probe ops of their own in a worker's process)."""
    from paddle_tpu.fluid.registry import OPS as JAX_OPS
    from paddle_tpu_torch.fluid.registry import OPS

    own = {t for t, info in OPS.items()
           if info.forward.__module__.startswith("paddle_tpu_torch.")}
    jax_own = {t for t, info in JAX_OPS.items()
               if info.forward.__module__.startswith("paddle_tpu.")}
    assert {"pipeline", "pipeline_cut"} <= own
    assert len(own) == 218 and len(jax_own) == 218
    assert jax_own - own == set()
