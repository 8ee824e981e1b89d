"""Sequence parallelism in the port (``parallel/sequence_parallel.py``:
ring and Ulysses attention; ``ring_attention``'s ``seq_axis`` branch;
``plan_sequence_parallel`` under the ParallelExecutor; the
``seq_parallel`` Transformer) against the JAX package, on the CPU.

The port's side runs in one spawned gloo world of four CPU ranks (a
``file://`` store under the test's temporary directory, one thread a
rank), given seeded inputs, and the JAX startup state of each program as
``.npz`` files. The JAX side runs in the pytest process on the 8-device
virtual mesh, over the same mesh shapes (sp=4, dp=2 x sp=2). This file
imports only numpy, torch and pytest at the top, so the ranks never
import jax.

Tolerances: attention outputs and the gradients of Q, K and V within
1e-5 of the JAX package's (float32 online softmax, sums in another
order); ParallelExecutor losses within 1e-5 of the port's single-device
run and 2e-5 of the JAX package's.
"""
import functools
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

# (impl, causal, mesh axes) — tests/test_sequence_parallel.py:47's grid on
# the world's four ranks
ATTN = [(impl, causal, axes) for impl in ("ring", "ulysses")
        for causal in (False, True) for axes in ("sp=4", "dp=2,sp=2")]
# cross attention: K/V half the length of Q
CROSS = [("ring", True), ("ulysses", False)]
# the JAX reference of every grid point is computed on this mesh (the
# same function on either mesh shape; one compile a point, not two)
JAX_AXES = "dp=2,sp=2"
TCFG = dict(src_vocab=40, trg_vocab=40, max_len=8, d_model=32, n_heads=4,
            d_ff=64, n_layers=1, dropout=0.0, seq_parallel=True)
T_STEPS = 10


def _qkv(b=2, s=32, h=8, d=8, seed=0, sk=None):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, s, h, d).astype(np.float32)
    k = rng.randn(b, sk or s, h, d).astype(np.float32)
    v = rng.randn(b, sk or s, h, d).astype(np.float32)
    w = rng.randn(b, s, h, d).astype(np.float32)  # the output cotangent
    return q, k, v, w


def _axes(text):
    return {a.split("=")[0]: int(a.split("=")[1]) for a in text.split(",")}


def _attn_key(impl, causal, axes):
    return f"{impl}/{int(causal)}/{axes}"


# --- the programs, one body for either package ----------------------------

def _pkg(which):
    if which == "port":
        import paddle_tpu_torch.fluid as fluid
        from paddle_tpu_torch import parallel
        from paddle_tpu_torch.fluid import layers, unique_name
        from paddle_tpu_torch.models import transformer
    else:
        import paddle_tpu.fluid as fluid
        from paddle_tpu import parallel
        from paddle_tpu.fluid import layers, unique_name
        from paddle_tpu.models import transformer
    return types.SimpleNamespace(fluid=fluid, layers=layers,
                                 unique_name=unique_name, parallel=parallel,
                                 transformer=transformer)


def build_ring_layer(pkg, impl):
    """tests/test_sequence_parallel.py:150's program."""
    fluid, layers = pkg.fluid, pkg.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 7
    with pkg.unique_name.guard(), fluid.program_guard(main, startup):
        q = layers.data(name="q", shape=[16, 4, 8], dtype="float32")
        k = layers.data(name="k", shape=[16, 4, 8], dtype="float32")
        v = layers.data(name="v", shape=[16, 4, 8], dtype="float32")
        out = layers.ring_attention(q, k, v, causal=True, impl=impl)
        proj = layers.fc(input=out, size=4, num_flatten_dims=3)
        loss = layers.mean(proj)
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def build_transformer(pkg, impl="ring"):
    """tests/test_sequence_parallel.py:191's model."""
    fluid, layers = pkg.fluid, pkg.layers
    cfg = pkg.transformer.TransformerConfig(sp_impl=impl, **TCFG)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.unique_name.guard(), fluid.program_guard(main, startup):
        src = layers.data(name="src", shape=[cfg.max_len], dtype="int64")
        trg = layers.data(name="trg", shape=[cfg.max_len], dtype="int64")
        lbl = layers.data(name="lbl", shape=[cfg.max_len, 1], dtype="int64")
        cost, _ = pkg.transformer.build_train(cfg, src, trg, lbl)
        fluid.optimizer.Adam(learning_rate=3e-3).minimize(cost)
    return main, startup, cost


PROGRAMS = {
    "ring_layer": (lambda pkg: build_ring_layer(pkg, "ring")),
    "ulysses_layer": (lambda pkg: build_ring_layer(pkg, "ulysses")),
    "transformer": (lambda pkg: build_transformer(pkg, "ring")),
}


def _feeds(name):
    if "layer" in name:
        q, k, v, _ = _qkv(b=4, s=16, h=4, d=8)
        return [{"q": q, "k": k, "v": v}]
    rng = np.random.RandomState(0)
    out = []
    for _ in range(T_STEPS):
        s = rng.randint(3, 40, size=(8, TCFG["max_len"])).astype(np.int64)
        t = np.concatenate([np.zeros((8, 1), np.int64), s[:, :-1]], axis=1)
        out.append({"src": s, "trg": t, "lbl": s[:, :, None]})
    return out


def _loss(v):
    return float(np.ravel(np.asarray(v))[0])


def _state(scope):
    return {n: np.asarray(scope.find_var(n)) for n in scope.var_names()
            if hasattr(scope.find_var(n), "shape")}


def _port_losses(name, job, mesh=None):
    """The port's run of a program from the JAX startup state: the plain
    Executor (``mesh=None``) or the ParallelExecutor under
    ``plan_sequence_parallel()``."""
    pkg = _pkg("port")
    main, _, cost = PROGRAMS[name](pkg)
    scope = pkg.fluid.Scope()
    with np.load(os.path.join(job, f"{name}.npz")) as z:
        for n in z.files:
            scope.set_var(n, torch.from_numpy(np.array(z[n])))
    if mesh is None:
        exe = pkg.fluid.Executor(pkg.fluid.CPUPlace())
        return [_loss(exe.run(main, feed=f, fetch_list=[cost],
                              scope=scope)[0]) for f in _feeds(name)]
    with pkg.fluid.scope_guard(scope):
        pe = pkg.fluid.ParallelExecutor(
            use_cuda=False, loss_name=cost.name, main_program=main,
            mesh=mesh, sharding_plan=pkg.parallel.plan_sequence_parallel())
        return [_loss(pe.run(fetch_list=[cost], feed=f)[0])
                for f in _feeds(name)]


# --- the ranks ---------------------------------------------------------------

def _rank_attention(mesh, impl, causal, q, k, v, w):
    """Output and Q/K/V gradients of sequence_parallel_attention on the
    global arrays, sharded (batch on dp when the mesh has it, sequence on
    sp), gathered whole."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from paddle_tpu_torch.parallel import sequence_parallel_attention

    names = mesh.mesh_dim_names
    batch_axis = "dp" if "dp" in names else None
    pl = [Shard(0) if n == batch_axis else Shard(1) if n == "sp"
          else Replicate() for n in names]
    ts = [distribute_tensor(torch.from_numpy(a), mesh, pl,
                            src_data_rank=None).requires_grad_()
          for a in (q, k, v)]
    out = sequence_parallel_attention(*ts, mesh, seq_axis="sp",
                                      batch_axis=batch_axis, causal=causal,
                                      impl=impl)
    out.backward(distribute_tensor(torch.from_numpy(w), mesh, pl,
                                   src_data_rank=None))
    return [out.full_tensor().detach().numpy().tolist()] + \
        [t.grad.full_tensor().numpy().tolist() for t in ts]


def _rank_main(rank, store, job):
    import logging

    torch.set_num_threads(1)
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    import torch.distributed as dist

    from paddle_tpu_torch.mesh import MeshSpec

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    try:
        meshes = {a: MeshSpec.parse(a).build("cpu")
                  for a in ("sp=4", "dp=2,sp=2")}
        out = {"attn": {}, "cross": {}, "losses": {}}
        q, k, v, w = _qkv()
        for impl, causal, axes in ATTN:
            out["attn"][_attn_key(impl, causal, axes)] = _rank_attention(
                meshes[axes], impl, causal, q, k, v, w)
        q, k, v, w = _qkv(sk=16, seed=1)
        for impl, causal in CROSS:
            out["cross"][f"{impl}/{int(causal)}"] = _rank_attention(
                meshes["sp=4"], impl, causal, q, k, v, w)
        for name in PROGRAMS:
            out["losses"][name] = _port_losses(name, job, "dp=2,sp=2")
        if rank == 0:
            with open(os.path.join(job, "world.json"), "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


# --- the JAX side and the fixture -----------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_attention(impl, causal, axes, cross=False):
    import jax
    import jax.numpy as jnp

    from paddle_tpu.parallel import make_mesh
    from paddle_tpu.parallel.sequence_parallel import (
        sequence_parallel_attention)

    ax = _axes(axes)
    mesh = make_mesh(ax, devices=jax.devices()[:int(np.prod(
        list(ax.values())))])

    def f(q, k, v):
        return sequence_parallel_attention(
            q, k, v, mesh, seq_axis="sp",
            batch_axis="dp" if "dp" in ax else None, causal=causal,
            impl=impl)

    q, k, v, w = _qkv(sk=16, seed=1) if cross else _qkv()
    out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(w))]


def _jax_losses(name, job):
    """The JAX ParallelExecutor on dp=2 x sp=2, after saving its startup
    state for the port."""
    import jax

    pkg = _pkg("jax")
    main, startup, cost = PROGRAMS[name](pkg)
    scope = pkg.fluid.Scope()
    with pkg.fluid.scope_guard(scope):
        pkg.fluid.Executor().run(startup)
        np.savez(os.path.join(job, f"{name}.npz"), **_state(scope))
        mesh = pkg.parallel.make_mesh({"dp": 2, "sp": 2},
                                      devices=jax.devices()[:4])
        pe = pkg.fluid.ParallelExecutor(
            loss_name=cost.name, main_program=main, mesh=mesh,
            sharding_plan=pkg.parallel.plan_sequence_parallel())
        return [_loss(pe.run(fetch_list=[cost], feed=f)[0])
                for f in _feeds(name)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import time

    import torch.multiprocessing as mp

    job = str(tmp_path_factory.mktemp("sp_job"))
    jax_losses = {name: _jax_losses(name, job) for name in PROGRAMS}
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
    with open(os.path.join(job, "world.json")) as f:
        port = json.load(f)
    return types.SimpleNamespace(job=job, port=port, jax=jax_losses)


@pytest.mark.parametrize("impl,causal,axes", ATTN)
def test_attention_and_grads_match_jax(world, impl, causal, axes):
    got = world.port["attn"][_attn_key(impl, causal, axes)]
    want = _jax_attention(impl, causal, JAX_AXES)
    for what, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(np.asarray(g), w, atol=ATOL, rtol=0,
                                   err_msg=what)


@pytest.mark.parametrize("impl,causal", CROSS)
def test_cross_attention_with_shorter_kv_matches_jax(world, impl, causal):
    got = world.port["cross"][f"{impl}/{int(causal)}"]
    want = _jax_attention(impl, causal, "sp=4", cross=True)
    assert np.asarray(got[2]).shape == (2, 16, 8, 8)
    for what, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(np.asarray(g), w, atol=ATOL, rtol=0,
                                   err_msg=what)


@pytest.mark.parametrize("name", ["ring_layer", "ulysses_layer"])
def test_ring_attention_layer_under_the_executor(world, name):
    """``layers.ring_attention`` under the ParallelExecutor on dp=2 x
    sp=2 against the port's single-device loss and the JAX package's
    sharded loss."""
    single = _port_losses(name, world.job)
    got = world.port["losses"][name]
    np.testing.assert_allclose(got, single, rtol=SELF_RTOL, atol=0)
    np.testing.assert_allclose(got, world.jax[name], rtol=JAX_RTOL, atol=0)


@pytest.mark.parametrize("name", ["transformer"])
def test_seq_parallel_transformer_losses_match_jax(world, name):
    """The ``seq_parallel`` Transformer, 10 Adam steps on dp=2 x sp=2,
    against the JAX package's over the same steps and its own
    single-device run; the loss falls."""
    got = world.port["losses"][name]
    assert len(got) == T_STEPS and np.isfinite(got).all()
    assert got[-1] < got[0]
    np.testing.assert_allclose(got, world.jax[name], rtol=JAX_RTOL, atol=0)
    np.testing.assert_allclose(got, _port_losses(name, world.job),
                               rtol=SELF_RTOL, atol=0)
