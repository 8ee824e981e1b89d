"""The port's mesh layer (``paddle_tpu_torch/mesh``, ``paddle_tpu_torch/
parallel``), ``get_places``/``ParallelDo``, ``moe_ffn`` and the
``DistributeTranspiler`` facade, against the JAX package on the CPU.

The spec/rules cases, ``moe_ffn`` single-device, ``ParallelDo`` under the
plain Executor and the transpiler's program views run in this process.
The mesh cases run in one spawned gloo world of 4 CPU ranks (a ``file://``
store under ``tmp_path``, one thread each) fed the JAX startup's state as
``.npz`` files: ``moe_ffn`` dense against sharded on dp=2 x ep=2,
``layers.moe`` trained under ``plan_moe_ep``, an ``is_distributed``
embedding under the transpiler's ``mesh()``/``sharding_plan()``,
``shard_param_tree``, ``get_places`` under a mesh, a refusal (a mesh
larger than the world) and a sequence-parallel mesh's executor and op
running. This file imports
only numpy, torch and pytest at the top, so the ranks never import jax.
Tolerances: sharded against the port's single run rtol 1e-5; against the
JAX run rtol 2e-5.
"""
import json
import os
import types

import numpy as np
import pytest
import torch

SELF_RTOL = 1e-5
JAX_RTOL = 2e-5
WORLD = 4
JOIN_TIMEOUT_S = 600


def _port():
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import mesh, parallel
    from paddle_tpu_torch.fluid import layers, unique_name
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.parallel import moe

    return types.SimpleNamespace(fluid=fluid, layers=layers,
                                 unique_name=unique_name, mesh=mesh,
                                 parallel=parallel, moe=moe,
                                 transformer=transformer)


def _jax():
    import paddle_tpu.fluid as fluid
    from paddle_tpu import mesh, parallel
    from paddle_tpu.fluid import layers, unique_name
    from paddle_tpu.models import transformer
    from paddle_tpu.parallel import moe

    return types.SimpleNamespace(fluid=fluid, layers=layers,
                                 unique_name=unique_name, mesh=mesh,
                                 parallel=parallel, moe=moe,
                                 transformer=transformer)


def _loss(v):
    return float(np.ravel(np.asarray(v))[0])


# --- MeshSpec and ShardingRules --------------------------------------------

def test_mesh_spec_parse_and_roundtrip():
    P, J = _port().mesh.MeshSpec, _jax().mesh.MeshSpec
    ms = P.parse("dp=2, tp=2, fsdp=2")
    assert ms.axis_names == ("dp", "tp", "fsdp") and ms.size == 8
    assert ms.axis_size("fsdp") == 2
    assert "tp" in ms and "sp" not in ms
    assert P.from_dict(ms.to_dict()) == ms
    assert P.coerce(str(ms)) == ms
    assert P.coerce({"tp": 4}) == P.parse("tp=4")
    assert ms.to_dict() == J.parse("dp=2, tp=2, fsdp=2").to_dict()
    assert str(ms) == str(J.parse("dp=2,tp=2,fsdp=2"))


@pytest.mark.parametrize("bad", ["dp=0", "dp", "dp=x", "dp=2,dp=4",
                                 "2dp=2", ""])
def test_mesh_spec_refusals(bad):
    for pkg in (_port(), _jax()):
        with pytest.raises(ValueError):
            pkg.mesh.MeshSpec.parse(bad)


def test_mesh_build_needs_the_world():
    """A mesh larger than the world (no group here: a world of 1) is a
    typed error naming both counts."""
    with pytest.raises(ValueError, match="needs 16 devices, have 1"):
        _port().mesh.MeshSpec.parse("dp=16").build("cpu")


NAMES = [("enc0.self.q.w", 2), ("dec1.cross.k.w", 2), ("enc0.self.out.w", 2),
         ("enc0.ff1.w", 2), ("enc0.ff2.w", 2), ("enc.emb", 2),
         ("proj.w", 2), ("enc0.self.q.w_moment1_0", 2),
         ("enc0.self.q.w_beta1_pow_acc_0", 0), ("enc0.a.ln.scale", 1),
         ("enc0.a.ln.bias_moment2_0", 1), ("learning_rate_0", 1),
         ("layer0/wk", 2), ("layer3/wo", 2), ("tok_emb", 2),
         ("layer0/ln1/0", 1), ("m0.experts.w1", 3), ("m0.router.w", 2)]


@pytest.mark.parametrize("rules", ["transformer_rules", "decoder_rules",
                                   "plan_transformer_tp", "plan_fsdp",
                                   "plan_moe_ep", "plan_data_parallel",
                                   "plan_sequence_parallel"])
def test_stock_rules_match_the_jax_package(rules):
    """Every stock rule set assigns each name the JAX package's spec and
    feeds the JAX package's batch spec."""
    def get(pkg):
        mod = pkg.mesh if rules.endswith("_rules") else pkg.parallel
        return getattr(mod, rules)()

    p, j = get(_port()), get(_jax())
    for name, ndim in NAMES:
        assert tuple(p.spec_for(name, ndim)) == \
            tuple(j.spec_for(name, ndim)), name
    for ndim in (0, 1, 2, 3):
        assert tuple(p.feed_spec(ndim)) == tuple(j.feed_spec(ndim))
    assert p.best_effort == j.best_effort
    if rules.endswith("_rules"):
        assert p.to_dict() == j.to_dict()


def test_transformer_rules_name_assignment():
    r = _port().mesh.transformer_rules()
    assert tuple(r.spec_for("enc0.self.q.w", 2)) == ("fsdp", "tp")
    assert tuple(r.spec_for("enc0.self.out.w", 2)) == ("tp", "fsdp")
    assert tuple(r.spec_for("enc0.self.q.w_moment1_0", 2)) == \
        ("fsdp", "tp")
    assert tuple(r.spec_for("enc0.self.q.w_beta1_pow_acc_0", 0)) == ()
    assert tuple(r.spec_for("enc0.a.ln.scale", 1)) == ("fsdp",)
    assert tuple(r.feed_spec(2)) == ("dp", None)


def test_decoder_rules_serialization_and_refusal():
    pkg = _port()
    d = pkg.mesh.decoder_rules()
    rt = pkg.mesh.ShardingRules.from_dict(d.to_dict())
    assert tuple(rt.spec_for("layer0/wk", 2)) == (None, "tp")
    assert rt.to_dict() == d.to_dict()
    assert json.loads(json.dumps(d.to_dict())) == d.to_dict()
    with pytest.raises(ValueError, match="nope"):
        pkg.mesh.ShardingRules([(r"x", pkg.parallel.P("nope"))],
                               mesh_spec=pkg.mesh.MeshSpec.parse("tp=2"))


def test_rules_first_match_wins_and_with_rule():
    pkg = _port()
    P = pkg.parallel.P
    r = pkg.mesh.ShardingRules([(r"\.w$", P("tp", None))], batch_axis=None)
    r2 = r.with_rule(r".", P("fsdp"))
    assert tuple(r2.spec_for("a.w", 2)) == ("tp", None)
    assert tuple(r2.spec_for("a.b", 1)) == ("fsdp",)
    assert tuple(r.spec_for("a.b", 1)) == ()


def test_specs_map_to_placements():
    """A spec entry shards its tensor dim over the mesh dim it names
    (several names: major first, in the mesh's order); every other mesh
    dim replicates."""
    from torch.distributed.tensor import Replicate, Shard

    par = _port().parallel
    names = ("dp", "tp", "fsdp")
    assert par.spec_to_placements(par.P("fsdp", "tp"), names) == \
        (Replicate(), Shard(1), Shard(0))
    assert par.spec_to_placements(par.P(None, ("dp", "fsdp")), names) == \
        (Shard(1), Replicate(), Shard(1))
    assert par.spec_to_placements(par.P(), names) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="sp"):
        par.spec_to_placements(par.P("sp"), names)
    with pytest.raises(ValueError, match="order"):
        par.spec_to_placements(par.P(("fsdp", "dp")), names)


def test_describe_cli(capsys):
    from paddle_tpu_torch.mesh.__main__ import main

    assert main(["--describe", "dp=2,tp=4"]) == 0
    out = capsys.readouterr().out
    assert "mesh: dp=2,tp=4 (devices: 8)" in out
    assert "enc0.self.q.w            -> PartitionSpec('fsdp', 'tp')" in out


# --- moe_ffn ---------------------------------------------------------------

def _moe_weights(d=8, e=4, ff=16, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(d, e).astype(np.float32),
            (rng.randn(e, d, ff) * 0.3).astype(np.float32),
            (rng.randn(e, ff, d) * 0.3).astype(np.float32))


def _moe_dense_ref(x, router, w1, w2):
    """Per-token top-1 expert, no capacity limit (float64)."""
    xt = x.reshape(-1, x.shape[-1]).astype(np.float64)
    logits = xt @ router
    gates = np.exp(logits - logits.max(-1, keepdims=True))
    gates /= gates.sum(-1, keepdims=True)
    out = np.zeros_like(xt)
    for t in range(xt.shape[0]):
        e = int(gates[t].argmax())
        h = np.maximum(xt[t] @ w1[e], 0.0)
        out[t] = gates[t, e] * (h @ w2[e])
    return out.reshape(x.shape)


def _moe_both(x, router, w1, w2, cf):
    import jax.numpy as jnp

    p = _port().moe.moe_ffn(*(torch.from_numpy(a) for a in
                              (x, router, w1, w2)), capacity_factor=cf)
    j = _jax().moe.moe_ffn(*(jnp.asarray(a) for a in (x, router, w1, w2)),
                           capacity_factor=cf)
    return [t.numpy() for t in p], [np.asarray(a) for a in j]


def test_moe_matches_dense_reference_and_jax():
    """tests/test_pipeline_moe.py:124: with capacity_factor = E nothing
    drops; the output is the dense top-1 reference's and the JAX
    function's, the aux loss the JAX one's."""
    router, w1, w2 = _moe_weights()
    x = np.random.RandomState(1).randn(4, 6, 8).astype(np.float32)
    (out, aux), (jout, jaux) = _moe_both(x, router, w1, w2, 4.0)
    np.testing.assert_allclose(out, _moe_dense_ref(x, router, w1, w2),
                               atol=1e-5)
    np.testing.assert_allclose(out, jout, rtol=JAX_RTOL, atol=1e-6)
    np.testing.assert_allclose(aux, jaux, rtol=JAX_RTOL)
    assert float(aux) > 0.0


def test_moe_capacity_drops_the_jax_packages_tokens():
    """tests/test_pipeline_moe.py:137: a tiny capacity drops tokens (zero
    rows), the same tokens the JAX function drops."""
    router, w1, w2 = _moe_weights(seed=2)
    x = np.random.RandomState(2).randn(1, 16, 8).astype(np.float32)
    (full, _), _ = _moe_both(x, router, w1, w2, 4.0)
    (tiny, _), (jtiny, _) = _moe_both(x, router, w1, w2, 0.25)
    full_nz = np.abs(full).sum(-1) > 0
    tiny_nz = np.abs(tiny).sum(-1) > 0
    assert 0 < tiny_nz.sum() < full_nz.sum()
    np.testing.assert_array_equal(tiny_nz, np.abs(jtiny).sum(-1) > 0)
    np.testing.assert_allclose(tiny, jtiny, rtol=JAX_RTOL, atol=1e-6)


# --- ParallelDo and get_places under the plain Executor --------------------

def build_parallel_do(pkg):
    fluid, layers = pkg.fluid, pkg.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 19
    with pkg.unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data(name="x", shape=[16], dtype="float32")
        y = layers.data(name="y", shape=[1], dtype="float32")
        places = layers.get_places()
        pd = layers.ParallelDo(places)
        with pd.do():
            x_, y_ = pd.read_input(x), pd.read_input(y)
            h = layers.fc(input=x_, size=32, act="tanh")
            p = layers.fc(input=h, size=1)
            pd.write_output(layers.square_error_cost(input=p, label=y_))
        cost = layers.mean(pd())
        fluid.optimizer.SGD(learning_rate=0.1).minimize(cost)
    return main, startup, cost, places


def _mlp_feeds(n, rows):
    rng = np.random.RandomState(0)
    w = rng.rand(16, 1).astype(np.float32)
    out = []
    for _ in range(n):
        x = rng.rand(rows, 16).astype(np.float32)
        out.append({"x": x, "y": (x @ w).astype(np.float32)})
    return out


def _jax_state(main, startup, pkg):
    scope = pkg.fluid.Scope()
    with pkg.fluid.scope_guard(scope):
        pkg.fluid.Executor().run(startup)
    return scope, {n: np.asarray(scope.find_var(n))
                   for n in scope.var_names()}


def test_parallel_do_alone_matches_jax():
    """A ParallelDo region under the plain Executor: the program is the JAX
    package's, and from the JAX startup state the losses are the JAX
    Executor's; get_places gives the port's one CPU device (the JAX
    op gives jax.device_count(), 8 on the virtual mesh: a decided
    difference)."""
    jpkg, ppkg = _jax(), _port()
    jmain, jstart, jcost, jplaces = build_parallel_do(jpkg)
    pmain, pstart, pcost, pplaces = build_parallel_do(ppkg)
    # the programs are the JAX package's but for the inferred shape of
    # the places var: [8] there (jax.device_count() at build), [1] here
    pj, jj = json.loads(pmain.to_bytes()), json.loads(jmain.to_bytes())
    assert pj["blocks"][0]["vars"][pplaces.name]["shape"] == [1]
    assert jj["blocks"][0]["vars"][jplaces.name]["shape"] == [8]
    pj["blocks"][0]["vars"][pplaces.name]["shape"] = [8]
    assert pj == jj
    jscope, state = _jax_state(jmain, jstart, jpkg)
    feeds = _mlp_feeds(4, 32)
    jexe = jpkg.fluid.Executor()
    want, jp = [], None
    for f in feeds:
        loss, jp = jexe.run(jmain, feed=f, fetch_list=[jcost, jplaces],
                            scope=jscope)
        want.append(_loss(loss))
    scope = ppkg.fluid.Scope()
    for n, v in state.items():
        scope.set_var(n, torch.from_numpy(np.array(v)))
    exe = ppkg.fluid.Executor(ppkg.fluid.CPUPlace())
    got, pp = [], None
    for f in feeds:
        loss, pp = exe.run(pmain, feed=f, fetch_list=[pcost, pplaces],
                           scope=scope)
        got.append(_loss(loss))
    np.testing.assert_allclose(got, want, rtol=SELF_RTOL)
    assert list(pp) == [0]
    assert list(np.asarray(jp)) == list(range(8))


# --- the DistributeTranspiler's program views --------------------------------

def _transpiler_mlp(pkg):
    fluid, layers = pkg.fluid, pkg.layers
    main, startup = fluid.Program(), fluid.Program()
    with pkg.unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data(name="x", shape=[4], dtype="float32")
        y = layers.data(name="y", shape=[1], dtype="float32")
        h = layers.fc(input=x, size=8, act="relu",
                      param_attr=fluid.ParamAttr(name="w1"),
                      bias_attr=fluid.ParamAttr(name="b1"))
        p = layers.fc(input=h, size=1,
                      param_attr=fluid.ParamAttr(name="w2"),
                      bias_attr=fluid.ParamAttr(name="b2"))
        cost = layers.mean(layers.square_error_cost(input=p, label=y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(cost)
    return main, startup, cost


def test_distribute_transpiler_facade_matches_jax():
    """tests/test_distributed.py:177: the parameter assignment, each
    pserver's program and startup, and hash_name are the JAX package's;
    the trainer program is the program itself."""
    from paddle_tpu.fluid import distribute_transpiler as jdt
    from paddle_tpu_torch.fluid import distribute_transpiler as pdt

    views = {}
    for name, pkg in (("port", _port()), ("jax", _jax())):
        main, startup, _ = _transpiler_mlp(pkg)
        for split in ("round_robin", "hash_name"):
            mod = pdt if name == "port" else jdt
            t = pkg.fluid.DistributeTranspiler()
            t.transpile(trainer_id=0, program=main, startup_program=startup,
                        pservers="ps0:6174,ps1:6174", trainers=2,
                        split_method=getattr(mod, split))
            assert t.get_trainer_program() is main
            progs = {}
            for ep in ("ps0:6174", "ps1:6174"):
                pp = t.get_pserver_program(ep)
                sp = t.get_startup_program(ep, pp)
                progs[ep] = ([op.desc.type for op in pp.global_block().ops],
                             sorted(pp.global_block().vars),
                             [op.desc.type for op in sp.global_block().ops],
                             sorted(sp.global_block().vars))
            views[(name, split)] = (dict(t.param_assignment), progs)
    for split in ("round_robin", "hash_name"):
        assert views[("port", split)] == views[("jax", split)], split
    names = sorted(f"v{i}" for i in range(20))
    assert pdt.hash_name(names, ["a", "b", "c"]) == \
        jdt.hash_name(names, ["a", "b", "c"])


def test_transpiler_send_recv_program_is_refused_by_the_executor():
    """The reference flow (send/recv around the step) used to be refused
    by the port's Executor; it now runs against start_pserver's
    pservers on the CPU, with the JAX package's losses (rtol 1e-5) and
    pserver parameters (rtol 1e-6, atol 1e-7: the two packages' products
    round apart by an ulp) on the same feeds and the JAX pserver's
    initial state. The ParallelExecutor still refuses it."""
    import socket

    def free_port():
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    feeds = []
    rng = np.random.RandomState(3)
    for _ in range(4):
        x = rng.randn(6, 4).astype(np.float32)
        feeds.append({"x": x, "y": x.sum(1, keepdims=True) * 0.5})
    out, init = {}, None
    for side, pkg in (("jax", _jax()), ("port", _port())):
        main, startup, cost = _transpiler_mlp(pkg)
        # a seeded JAX startup: the pservers' initial state, and so the
        # loss curve, is the same in every run
        main.random_seed = startup.random_seed = 11
        ep = f"127.0.0.1:{free_port()}"
        t = pkg.fluid.DistributeTranspiler()
        t.transpile(trainer_id=0, program=main, startup_program=startup,
                    pservers=ep, trainers=1)
        prog = t.get_trainer_program(send_recv=True)
        types_ = [op.desc.type for op in prog.global_block().ops]
        assert types_[0] == "recv" and types_[-1] == "send"
        kw = {} if side == "jax" else {"device": "cpu"}
        ps = t.start_pserver(ep, port=int(ep.rsplit(":", 1)[1]), **kw)
        try:
            if side == "jax":
                init = {n: np.array(ps._scope.find_var(n))
                        for n in ps._scope.var_names()}
                exe = pkg.fluid.Executor(pkg.fluid.CPUPlace())
            else:
                for n, v in init.items():
                    ps._scope.set_var(n, torch.tensor(v))
                exe = pkg.fluid.Executor(pkg.fluid.CPUPlace())
                with pytest.raises(NotImplementedError,
                                   match="parameter-server"):
                    pkg.fluid.ParallelExecutor(use_cuda=False,
                                               main_program=prog)
            scope = pkg.fluid.Scope()
            exe.run(startup, scope=scope)
            losses = [_loss(exe.run(prog, feed=f, fetch_list=[cost],
                                    scope=scope)[0]) for f in feeds]
            out[side] = (losses, {p: np.array(ps.get_param(p))
                                  for p in ps.owned_params()})
        finally:
            ps.shutdown()
    np.testing.assert_allclose(out["port"][0], out["jax"][0], rtol=1e-5)
    assert out["port"][0][-1] < out["port"][0][0]
    for p, want in out["jax"][1].items():
        np.testing.assert_allclose(out["port"][1][p], want, rtol=1e-6,
                                   atol=1e-7)


# --- the mesh cases (one spawned world of 4) --------------------------------

def build_moe_program(pkg):
    fluid, layers = pkg.fluid, pkg.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 11
    with pkg.unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data(name="x", shape=[6, 16], dtype="float32")
        y = layers.data(name="y", shape=[6, 16], dtype="float32")
        h, aux = layers.moe(x, num_experts=4, d_ff=32, name="m0")
        cost = layers.elementwise_add(
            layers.mean(layers.square_error_cost(input=h, label=y)),
            layers.scale(aux, scale=0.01))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(cost)
    return main, startup, cost


def build_dist_embedding(pkg):
    fluid, layers = pkg.fluid, pkg.layers
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 23
    with pkg.unique_name.guard(), fluid.program_guard(main, startup):
        ids = layers.data(name="ids", shape=[1], dtype="int64")
        lbl = layers.data(name="lbl", shape=[8], dtype="float32")
        emb = layers.embedding(ids, size=[64, 8], is_distributed=True,
                               param_attr=fluid.ParamAttr(name="table"))
        cost = layers.mean(layers.square_error_cost(input=emb, label=lbl))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(cost)
    return main, startup, cost


def _moe_feeds():
    rng = np.random.RandomState(0)
    out = []
    for _ in range(3):
        xs = rng.randn(8, 6, 16).astype(np.float32)
        out.append({"x": xs, "y": np.tanh(xs)})
    return out


def _emb_feeds():
    rng = np.random.RandomState(0)
    return [{"ids": rng.randint(0, 64, size=(32, 1)).astype(np.int64),
             "lbl": rng.rand(32, 8).astype(np.float32)} for _ in range(3)]


# name -> (builder, feeds, port mesh, JAX mesh, plan)
PROGRAMS = {
    "moe": (build_moe_program, _moe_feeds, "dp=2,ep=2", "dp=2,ep=2",
            "plan_moe_ep"),
    "embedding": (build_dist_embedding, _emb_feeds, "transpiler", "dp=4",
                  "transpiler"),
}


def _jax_program(name, job):
    pkg = _jax()
    build, feeds_fn, _, axes, plan = PROGRAMS[name]
    main, startup, cost = build(pkg)
    scope, state = _jax_state(main, startup, pkg)
    np.savez(os.path.join(job, f"{name}.state.npz"), **state)
    with pkg.fluid.scope_guard(scope):
        if plan == "transpiler":
            t = pkg.fluid.DistributeTranspiler()
            t.transpile(trainer_id=0, program=main, trainers=4)
            import jax

            mesh, splan = t.mesh(devices=jax.devices()[:4]), \
                t.sharding_plan()
        else:
            mesh = pkg.mesh.MeshSpec.parse(axes)
            splan = getattr(pkg.parallel, plan)()
        pe = pkg.fluid.ParallelExecutor(use_cuda=False, loss_name=cost.name,
                                        main_program=main, mesh=mesh,
                                        sharding_plan=splan)
        return [_loss(pe.run(fetch_list=[cost], feed=f)[0])
                for f in feeds_fn()]


def _port_single(name, job):
    pkg = _port()
    build, feeds_fn, _, _, _ = PROGRAMS[name]
    main, startup, cost = build(pkg)
    scope = pkg.fluid.Scope()
    with np.load(os.path.join(job, f"{name}.state.npz")) as z:
        for n in z.files:
            scope.set_var(n, torch.from_numpy(np.array(z[n])))
    exe = pkg.fluid.Executor(pkg.fluid.CPUPlace())
    return [_loss(exe.run(main, feed=f, fetch_list=[cost], scope=scope)[0])
            for f in feeds_fn()]


def _rank_program(pkg, name, job):
    build, feeds_fn, axes, _, plan = PROGRAMS[name]
    main, startup, cost = build(pkg)
    scope = pkg.fluid.Scope()
    with np.load(os.path.join(job, f"{name}.state.npz")) as z:
        for n in z.files:
            scope.set_var(n, torch.from_numpy(np.array(z[n])))
    with pkg.fluid.scope_guard(scope):
        if plan == "transpiler":
            t = pkg.fluid.DistributeTranspiler()
            t.transpile(trainer_id=0, program=main, trainers=WORLD)
            mesh, splan = t.mesh(devices="cpu"), t.sharding_plan()
        else:
            mesh, splan = axes, getattr(pkg.parallel, plan)()
        pe = pkg.fluid.ParallelExecutor(use_cuda=False, loss_name=cost.name,
                                        main_program=main, mesh=mesh,
                                        sharding_plan=splan)
        losses = [_loss(pe.run(fetch_list=[cost], feed=f)[0])
                  for f in feeds_fn()]
    return {"losses": losses, "mesh": dict(zip(
        pe.mesh.mesh_dim_names, (int(s) for s in pe.mesh.shape))),
        "placements": {n: [repr(p) for p in scope.find_var(n).placements]
                       for n in scope.var_names()
                       if hasattr(scope.find_var(n), "placements")}}


def _rank_moe_sharded(pkg, mesh):
    """moe_ffn on DTensors (x on dp, expert stacks on ep) against the same
    call on whole tensors."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    router, w1, w2 = (torch.from_numpy(a) for a in _moe_weights(seed=3))
    x = torch.from_numpy(
        np.random.RandomState(4).randn(8, 4, 8).astype(np.float32))
    ref, ref_aux = pkg.moe.moe_ffn(x, router, w1, w2, capacity_factor=4.0)
    xs = distribute_tensor(x, mesh, [Shard(0), Replicate()])
    rs = distribute_tensor(router, mesh, [Replicate(), Replicate()])
    w1s = distribute_tensor(w1, mesh, [Replicate(), Shard(0)])
    w2s = distribute_tensor(w2, mesh, [Replicate(), Shard(0)])
    from paddle_tpu_torch.parallel import mesh_context
    from torch.distributed.tensor.experimental import implicit_replication

    with mesh_context(mesh), implicit_replication():
        out, aux = pkg.moe.moe_ffn(xs, rs, w1s, w2s, mesh=mesh,
                                   ep_axis="ep", capacity_factor=4.0)
    return {"max_err": float((out.full_tensor() - ref).abs().max()),
            "aux_err": float((aux.full_tensor() - ref_aux).abs()),
            "out": out.full_tensor().tolist()}


def _rank_param_tree(pkg, mesh):
    """shard_param_tree with decoder_rules over tp=4: wk column-split,
    the 9-row vocab (indivisible) replicated; strict rules refuse it."""
    rules = pkg.mesh.decoder_rules()
    tree = {"layer0": {"wk": np.arange(64, dtype=np.float32).reshape(8, 8),
                       "ln1": (np.ones(8, np.float32),) * 2},
            "tok_emb": np.ones((9, 8), np.float32)}
    out = pkg.mesh.shard_param_tree(tree, mesh, rules)
    strict = pkg.mesh.ShardingRules(rules.to_dict()["rules"],
                                    batch_axis=None, best_effort=False)
    try:
        pkg.mesh.shard_param_tree(tree, mesh, strict)
        refused = ""
    except ValueError as e:
        refused = str(e)
    return {"wk": [repr(p) for p in out["layer0"]["wk"].placements],
            "wk_local": list(out["layer0"]["wk"].to_local().shape),
            "wk_equal": bool(np.array_equal(
                out["layer0"]["wk"].full_tensor().numpy(),
                tree["layer0"]["wk"])),
            "ln_is_tuple": isinstance(out["layer0"]["ln1"], tuple),
            "tok_emb": [repr(p) for p in out["tok_emb"].placements],
            "refused": refused}


def _rank_refusals(pkg):
    out = {}
    try:
        pkg.mesh.MeshSpec.parse("dp=8").build("cpu")
    except ValueError as e:
        out["size"] = str(e)
    # a sequence-parallel mesh: the plan builds an executor, and the op
    # runs (their parity: tests/test_torch_sequence_parallel.py)
    spe = pkg.fluid.ParallelExecutor(
        use_cuda=False, mesh="dp=2,sp=2",
        sharding_plan=pkg.parallel.plan_sequence_parallel(),
        main_program=pkg.fluid.Program())
    out["plan"] = spe._plan.seq_axis
    cfg = pkg.transformer.TransformerConfig(
        src_vocab=16, trg_vocab=16, max_len=4, d_model=8, n_heads=2, d_ff=8,
        n_layers=1, dropout=0.0, seq_parallel=True)
    fluid, layers = pkg.fluid, pkg.layers
    main, startup = fluid.Program(), fluid.Program()
    with pkg.unique_name.guard(), fluid.program_guard(main, startup):
        src = layers.data(name="src", shape=[4], dtype="int64")
        trg = layers.data(name="trg", shape=[4], dtype="int64")
        lbl = layers.data(name="lbl", shape=[4, 1], dtype="int64")
        cost, _ = pkg.transformer.build_train(cfg, src, trg, lbl)
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    with fluid.scope_guard(scope):
        pe = fluid.ParallelExecutor(use_cuda=False, main_program=main,
                                    mesh="dp=2,sp=2")
    ids = np.ones((4, 4), np.int64)
    out["op"] = _loss(pe.run(fetch_list=[cost], feed={
        "src": ids, "trg": ids, "lbl": ids[:, :, None]})[0])
    # get_places under a mesh: the mesh's size
    main, startup = fluid.Program(), fluid.Program()
    with pkg.unique_name.guard(), fluid.program_guard(main, startup):
        places = layers.get_places()
    with fluid.scope_guard(fluid.Scope()):
        pe = fluid.ParallelExecutor(use_cuda=False, main_program=main,
                                    mesh="dp=4")
        out["places"] = np.asarray(pe.run(fetch_list=[places])[0]).tolist()
    return out


def _rank_main(rank, store, job):
    import logging

    torch.set_num_threads(1)
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    try:
        pkg = _port()
        out = {name: _rank_program(pkg, name, job) for name in PROGRAMS}
        out["moe_sharded"] = _rank_moe_sharded(
            pkg, pkg.mesh.MeshSpec.parse("dp=2,ep=2").build("cpu"))
        out["param_tree"] = _rank_param_tree(
            pkg, pkg.mesh.MeshSpec.parse("tp=4").build("cpu"))
        out["refusals"] = _rank_refusals(pkg)
        if rank == 0:
            with open(os.path.join(job, "world.json"), "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import time

    import torch.multiprocessing as mp

    job = str(tmp_path_factory.mktemp("mesh_job"))
    jax_out = {name: _jax_program(name, job) for name in PROGRAMS}
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
    return types.SimpleNamespace(job=job, jax=jax_out, port=port)


def test_moe_sharded_matches_unsharded(world):
    """tests/test_pipeline_moe.py:150 on the port: x on dp, the expert
    stacks on ep (dp=2 x ep=2), output and aux loss as the whole-tensor
    call's, and as the JAX sharded call's."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    r = world.port["moe_sharded"]
    assert r["max_err"] < 1e-5 and r["aux_err"] < 1e-6
    mesh = _jax().parallel.make_mesh({"dp": 2, "ep": 2},
                                     devices=jax.devices()[:4])
    router, w1, w2 = _moe_weights(seed=3)
    x = np.random.RandomState(4).randn(8, 4, 8).astype(np.float32)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("dp")))
    w1s = jax.device_put(jnp.asarray(w1), NamedSharding(mesh, P("ep")))
    w2s = jax.device_put(jnp.asarray(w2), NamedSharding(mesh, P("ep")))
    out, _ = jax.jit(lambda *a: _jax().moe.moe_ffn(
        *a, mesh=mesh, ep_axis="ep", capacity_factor=4.0))(
        xs, jnp.asarray(router), w1s, w2s)
    np.testing.assert_allclose(r["out"], np.asarray(out), rtol=JAX_RTOL,
                               atol=1e-6)


def test_moe_layer_trains_under_plan_moe_ep(world):
    """tests/test_pipeline_moe.py:172 on the port: layers.moe on dp=2 x
    ep=2; the expert stacks held sharded over ep; losses as the single
    run's and the JAX sharded run's."""
    got = world.port["moe"]
    assert got["mesh"] == {"dp": 2, "ep": 2}
    np.testing.assert_allclose(got["losses"], _port_single("moe", world.job),
                               rtol=SELF_RTOL)
    np.testing.assert_allclose(got["losses"], world.jax["moe"],
                               rtol=JAX_RTOL)
    for n in ("m0.experts.w1", "m0.experts.w2"):
        assert got["placements"][n] == ["Replicate()", "Shard(dim=0)"], n
    assert got["placements"]["m0.router.w"] == ["Replicate()"] * 2


def test_transpiler_sharded_embedding_plan(world):
    """tests/test_distributed.py:248 on the port: an is_distributed table
    shards its rows over the transpiler's mesh (dp over the world of 4);
    the training matches the single run and the JAX run."""
    got = world.port["embedding"]
    assert got["mesh"] == {"dp": WORLD}
    assert got["placements"]["table"] == ["Shard(dim=0)"]
    np.testing.assert_allclose(got["losses"],
                               _port_single("embedding", world.job),
                               rtol=SELF_RTOL)
    np.testing.assert_allclose(got["losses"], world.jax["embedding"],
                               rtol=JAX_RTOL)


def test_shard_param_tree_by_name(world):
    r = world.port["param_tree"]
    assert r["wk"] == ["Shard(dim=1)"] and r["wk_local"] == [8, 2]
    assert r["wk_equal"] and r["ln_is_tuple"]
    assert r["tok_emb"] == ["Replicate()"]
    assert "tok_emb" in r["refused"]


def test_mesh_refusals_and_get_places(world):
    """A mesh larger than the world raises naming both; a sequence-parallel
    plan builds its executor and a ring_attention under a mesh holding its
    seq_axis runs (their parity is tests/test_torch_sequence_parallel.py);
    get_places under a mesh gives the mesh's devices."""
    r = world.port["refusals"]
    assert "needs 8 devices, have 4" in r["size"]
    assert r["plan"] == "sp"
    assert np.isfinite(r["op"])
    assert r["places"] == [0, 1, 2, 3]
