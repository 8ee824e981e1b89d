"""The port's ``Recompute`` region (``fluid/layers/control_flow.py``, the
``recompute`` op of ``fluid/ops/control_flow.py``) and
``TransformerConfig(recompute=True)`` against the plain program and the
JAX package, on the CPU — the counterpart of tests/test_recompute.py:

  (a) gradients through regions equal the plain program's (rtol 1e-6)
      on a deep tanh MLP and on a region that fans a value out; the
      region's parameters get the JAX package's gradients (rtol 1e-5)
      from the same program bytes;
  (b) the record of a ``recompute`` op holds no interior tensor: every
      tensor saved for backward while the region runs forward is one of
      its inputs (``torch.autograd.graph.saved_tensors_hooks``), where
      the plain program saves each layer's activations;
  (c) a region holding a dropout replays its mask in backward: the
      gradient equals a numpy replica that uses the forward's mask;
  (d) the outer-write carry and the three build-time rejections of
      tests/test_recompute.py:166;
  (e) ``TransformerConfig(recompute=True)`` trains: losses within 2e-4 of
      the plain model's (tests/test_recompute.py:111) and within 2e-5 of
      the JAX recompute model's from the same parameters; the layer-norm
      and flash-forward plain versions run twice as often, the flash
      backward as often.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.models import transformer as jtransformer
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import layers as tlayers
from paddle_tpu_torch.fluid import registry
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import layer_norm as tln
from paddle_tpu_torch.models import transformer as ttransformer

N_LAYERS, D = 8, 64
RC_RTOL = 1e-6
RTOL, ATOL = 1e-5, 1e-6
JAX = (jfluid, jlayers, junique)
PORT = (tfluid, tlayers, tunique)


def _deep_mlp(pkg, recompute, group=4, fan_out=False):
    """tests/test_recompute.py's N_LAYERS tanh fcs, a region every
    ``group`` layers; ``fan_out`` adds, in each group, a branch that
    reads the group's input a second time."""
    fluid, layers, unique_name = pkg
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = 21
    with unique_name.guard(), fluid.program_guard(prog, startup):
        x = layers.data(name="x", shape=[D], dtype="float32")
        y = layers.data(name="y", shape=[D], dtype="float32")

        def body(h, lo, hi):
            h0 = h
            for i in range(lo, hi):
                h = layers.fc(input=h, size=D, act="tanh",
                              param_attr=f"rc.w{i}", bias_attr=False)
            if fan_out:
                side = layers.fc(input=h0, size=D, act="sigmoid",
                                 param_attr=f"rc.side{lo}", bias_attr=False)
                h = layers.elementwise_add(h, layers.elementwise_mul(h0,
                                                                     side))
            return h

        h = x
        for lo in range(0, N_LAYERS, group):
            hi = min(lo + group, N_LAYERS)
            if recompute:
                rc = layers.Recompute()
                with rc.block():
                    out = body(h, lo, hi)
                h = rc.output(out)
            else:
                h = body(h, lo, hi)
        cost = layers.mean(layers.square_error_cost(input=h, label=y))
        fluid.optimizer.SGD(learning_rate=0.0).minimize(cost)
    return prog, startup, cost


def _weights(fan_out=False):
    rng = np.random.RandomState(0)
    ws = {f"rc.w{i}": (rng.rand(D, D).astype(np.float32) - 0.5) * 0.3
          for i in range(N_LAYERS)}
    if fan_out:
        ws.update({f"rc.side{lo}": (rng.rand(D, D).astype(np.float32) - 0.5)
                   * 0.3 for lo in range(0, N_LAYERS, 4)})
    return ws


def _feed(rows=4):
    rng = np.random.RandomState(1)
    return {"x": rng.rand(rows, D).astype(np.float32),
            "y": rng.rand(rows, D).astype(np.float32)}


def _port_grads(prog, startup, ws, fetch):
    scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    for n, v in ws.items():
        scope.set_var(n, torch.from_numpy(v.copy()))
    return [np.asarray(v) for v in exe.run(prog, feed=_feed(),
                                           fetch_list=fetch, scope=scope)]


@pytest.mark.parametrize("fan_out", [False, True])
def test_a_region_gradients_match_plain_and_jax(fan_out):
    ws = _weights(fan_out)
    names = ["mean_0.tmp_0"] + [n + "@GRAD" for n in sorted(ws)]
    plain = _port_grads(*_deep_mlp(PORT, False, fan_out=fan_out)[:2], ws,
                        names)
    rc = _port_grads(*_deep_mlp(PORT, True, fan_out=fan_out)[:2], ws, names)
    for a, b, n in zip(plain, rc, names):
        np.testing.assert_allclose(b, a, rtol=RC_RTOL, err_msg=n)
    # the JAX package's region from the same program bytes
    tp, ts, _ = _deep_mlp(PORT, True, fan_out=fan_out)
    jp, js, _ = _deep_mlp(JAX, True, fan_out=fan_out)
    assert json.loads(tp.to_bytes()) == json.loads(jp.to_bytes())
    assert [op.type for op in tp.global_block().ops].count("recompute") == 2
    jscope, jexe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
    jexe.run(js, scope=jscope)
    for n, v in ws.items():
        jscope.set_var(n, jnp.asarray(v))
    jout = jexe.run(jp, feed=_feed(), fetch_list=names, scope=jscope)
    for a, b, n in zip(jout, rc, names):
        np.testing.assert_allclose(b, np.asarray(a), rtol=RTOL, atol=ATOL,
                                   err_msg=n)


def test_b_record_holds_no_interior_tensor():
    """While the forward runs, the plain program saves every layer's
    input and activation for backward; with two regions, the only saved
    tensors are the regions' inputs (x, the first region's output, the
    eight weights) and the loss's own."""
    ws = _weights()
    saved = {}
    phase = {"backward": False}
    run_grad = registry.run_grad

    def counting_run_grad(*args, **kwargs):
        phase["backward"] = True
        return run_grad(*args, **kwargs)

    def pack(t):
        if not phase["backward"]:
            saved[key].append(t)
        return t

    for key in ("plain", "recompute"):
        saved[key] = []
        phase["backward"] = False
        prog, startup, cost = _deep_mlp(PORT, key == "recompute")
        registry.run_grad = counting_run_grad
        try:
            with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
                _port_grads(prog, startup, ws, [cost])
        finally:
            registry.run_grad = run_grad
    weights = [t for t in saved["recompute"] if tuple(t.shape) == (D, D)]
    acts = [t for t in saved["recompute"] if tuple(t.shape) != (D, D)]
    assert len(weights) == N_LAYERS
    # x and the first region's output (the regions' inputs) and the
    # loss's difference: no tanh activation of a region's interior
    assert len(acts) == 3, [tuple(t.shape) for t in acts]
    plain_acts = [t for t in saved["plain"] if tuple(t.shape) != (D, D)]
    assert len(plain_acts) == 2 * N_LAYERS + 1


def test_b_recompute_op_saves_only_its_inputs():
    """The op alone, through ``forward_with_grad``: every tensor its
    region saves is a leaf of the record (an input), none interior."""
    prog, startup, cost = _deep_mlp(PORT, True)
    op = [op for op in prog.global_block().ops if op.type == "recompute"][0]
    ws = _weights()
    ctx = registry.EmitCtx(device="cpu", root_seed=1, program=prog)
    ins = {"X": [torch.from_numpy(_feed()["x"]) if n == "x"
                 else torch.from_numpy(ws[n]) for n in op.attr("x_var_names")]}
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        outs, (paths, leaves, _) = registry.forward_with_grad(
            ctx, "recompute", ins, op.desc.attrs)
    assert len(saved) == len(leaves) == 5
    assert all(any(s.data_ptr() == leaf.data_ptr() for leaf in leaves)
               for s in saved)
    (y,) = outs["Out"]
    assert y.requires_grad and y.shape == (4, D)


def test_c_dropout_region_replays_its_mask():
    """x -> Recompute{fc -> dropout(0.5)} -> square_error_cost: W's
    gradient equals a numpy replica that uses the mask of the forward
    (read off the region's output); a second draw in backward would give
    another mask."""
    prog, startup = tfluid.Program(), tfluid.Program()
    prog.random_seed = startup.random_seed = 5
    with tunique.guard(), tfluid.program_guard(prog, startup):
        x = tlayers.data(name="x", shape=[D], dtype="float32")
        y = tlayers.data(name="y", shape=[D], dtype="float32")
        rc = tlayers.Recompute()
        with rc.block():
            h = tlayers.fc(input=x, size=D, param_attr="do.w",
                           bias_attr=False)
            out = tlayers.dropout(h, dropout_prob=0.5)
        out = rc.output(out)
        cost = tlayers.mean(tlayers.square_error_cost(input=out, label=y))
        tfluid.optimizer.SGD(learning_rate=0.0).minimize(cost)
    w = (np.random.RandomState(2).rand(D, D).astype(np.float32) - 0.5)
    feed = _feed(rows=8)
    scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    scope.set_var("do.w", torch.from_numpy(w.copy()))
    o, gw = exe.run(prog, feed=feed, fetch_list=[out, "do.w@GRAD"],
                    scope=scope)
    h = feed["x"].astype(np.float64) @ w
    mask = (np.asarray(o) != 0).astype(np.float64)
    assert 0.3 < mask.mean() < 0.7
    np.testing.assert_allclose(np.asarray(o), h * mask, rtol=RTOL,
                               atol=ATOL)
    dout = 2.0 * (h * mask - feed["y"]) / h.size
    want = feed["x"].T.astype(np.float64) @ (dout * mask)
    np.testing.assert_allclose(np.asarray(gw), want, rtol=RTOL, atol=ATOL)


def test_d_outer_writes_carry_and_bad_regions_are_rejected():
    """tests/test_recompute.py:166 in the port."""
    prog, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(prog, startup):
        x = tlayers.data(name="x", shape=[4], dtype="float32")
        acc = tlayers.fill_constant(shape=[4], dtype="float32", value=1.0)
        rc = tlayers.Recompute()
        with rc.block():
            doubled = tlayers.scale(x, scale=2.0)
            tlayers.assign(doubled, acc)  # write-through to the OUTER var
            out = tlayers.scale(doubled, scale=1.0)
        out = rc.output(out)
        post = tlayers.elementwise_add(out, acc)  # reads the UPDATED acc
    scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    (res,) = exe.run(prog, feed={"x": np.ones((1, 4), np.float32)},
                     fetch_list=[post], scope=scope)
    np.testing.assert_allclose(res, 4.0 * np.ones((1, 4)), rtol=1e-6)

    prog2, startup2 = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(prog2, startup2):
        x = tlayers.data(name="x", shape=[4], dtype="float32")
        stranger = tlayers.scale(x, scale=3.0)  # OUTSIDE the region
        rc = tlayers.Recompute()
        with rc.block():
            tlayers.scale(x, scale=2.0)
        with pytest.raises(ValueError, match="neither produced"):
            rc.output(stranger)
        with pytest.raises(ValueError, match="at least one var"):
            rc.output()

    prog3, startup3 = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(prog3, startup3):
        x = tlayers.data(name="x", shape=[4], dtype="float32")
        rc = tlayers.Recompute()
        with rc.block():
            i = tlayers.fill_constant(shape=[1], dtype="int64", value=0)
            n = tlayers.fill_constant(shape=[1], dtype="int64", value=3)
            y = tlayers.scale(x, scale=1.0)
            cond = tlayers.less_than(i, n)
            w = tlayers.While(cond)
            with w.block():
                tlayers.assign(tlayers.scale(y, scale=2.0), y)
                tlayers.increment(i, value=1, in_place=True)
                tlayers.less_than(i, n, cond=cond)
        with pytest.raises(ValueError, match="max_steps"):
            rc.output(y)
    with pytest.raises(RuntimeError, match="must follow block"):
        tlayers.Recompute().output(x)


TRANSFORMER = dict(src_vocab=60, trg_vocab=60, max_len=8, d_model=32,
                   n_heads=4, d_ff=64, n_layers=2, dropout=0.0,
                   seq_parallel=True)


def _transformer(pkg, recompute):
    fluid, layers, unique_name = pkg
    prog, startup = fluid.Program(), fluid.Program()
    prog.random_seed = startup.random_seed = 33
    with unique_name.guard(), fluid.program_guard(prog, startup):
        cfg = (jtransformer if pkg is JAX else ttransformer).TransformerConfig(
            recompute=recompute, **TRANSFORMER)
        src = layers.data(name="src", shape=[8], dtype="int64")
        trg = layers.data(name="trg", shape=[8], dtype="int64")
        lbl = layers.data(name="lbl", shape=[8, 1], dtype="int64")
        cost, _ = (jtransformer if pkg is JAX else ttransformer).build_train(
            cfg, src, trg, lbl)
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(cost)
    return prog, startup, cost


def _transformer_feeds(steps=4):
    rng = np.random.RandomState(5)
    s = rng.randint(3, 60, (4, 8)).astype(np.int64)
    t = np.concatenate([np.zeros((4, 1), np.int64), s[:, :-1]], 1)
    return [{"src": s, "trg": t, "lbl": s[:, :, None]}] * steps


def test_e_transformer_recompute_trains_like_plain_and_jax():
    # the parameters of the JAX recompute build; the names are the same in
    # every build (the region ops only shift per-op seeds)
    jp, js, jcost = _transformer(JAX, True)
    jscope, jexe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
    jexe.run(js, scope=jscope)
    init = {p.name: np.asarray(jscope.find_var(p.name)).copy()
            for p in jp.global_block().all_parameters()}
    feeds = _transformer_feeds()
    jl = [float(np.ravel(jexe.run(jp, feed=f, fetch_list=[jcost],
                                  scope=jscope)[0])[0]) for f in feeds]
    losses, calls = {}, {}
    for flag in (False, True):
        prog, startup, cost = _transformer(PORT, flag)
        assert {p.name for p in prog.global_block().all_parameters()} == \
            set(init)
        scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        tfluid.params_from_jax(init, scope, device="cpu")
        ln0, fa0 = dict(tln.counts.plain_calls), dict(tfa.counts.plain_calls)
        losses[flag] = [float(exe.run(prog, feed=f, fetch_list=[cost],
                                      scope=scope)[0][0]) for f in feeds]
        calls[flag] = {
            "ln": tln.counts.plain_calls[tln.KERNEL] - ln0[tln.KERNEL],
            **{n: tfa.counts.plain_calls[n] - fa0[n] for n in fa0}}
    assert np.isfinite(losses[True]).all()
    assert losses[True][-1] < losses[True][0]
    np.testing.assert_allclose(losses[True], losses[False], rtol=2e-4)
    np.testing.assert_allclose(losses[True], jl, rtol=2e-5)
    # 10 layer norms and 6 attentions a step; with recompute each region
    # runs its forward once more in backward
    steps = len(feeds)
    assert calls[False] == {"ln": 10 * steps, "flash_fwd_f32": 6 * steps,
                            "flash_bwd_dkdv_f32": 6 * steps,
                            "flash_bwd_dq_f32": 6 * steps}
    assert calls[True] == {"ln": 20 * steps, "flash_fwd_f32": 12 * steps,
                           "flash_bwd_dkdv_f32": 6 * steps,
                           "flash_bwd_dq_f32": 6 * steps}
