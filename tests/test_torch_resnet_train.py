"""The port's image-classification training path (conv2d, batch_norm,
top_k, accuracy, momentum; layers, nets, Momentum; models resnet, lenet,
vgg) against the JAX package's, on the CPU, at a small size:

  (a) op parity: each op's outputs and input gradients (the port through
      the executor's record-and-grad path, and replayed without a
      record) against the JAX op and its ``jax.vjp``, on the same seeded
      numpy inputs;
  (b) program equality: ResNet-50 (64x64), LeNet and VGG-16 (32x32) with
      Momentum build the same ops, attrs and variables in both packages;
  (c) training parity from the JAX scope's values: LeNet (8 steps) and
      ResNet-cifar10 depth 8 (3 steps, with every running mean and
      variance after the steps); VGG-16's test-mode logits;
  (d) a trained ResNet's batch-norm statistics folded into the fused
      inference program (chip_smoke.py's mapping) give the unfused
      network's test-mode logits;
  (e) the executor honours FLAGS['matmul_precision'].

Tolerances (float32; XLA and PyTorch sum in other orders): op outputs
and gradients rtol 1e-5 / atol 1e-6 (conv outputs and gradients atol
1e-5: sums of up to 196 products of unit-scale values); losses, step-1
gradients and running statistics of the trained networks the
Transformer test's LOSS_RTOL and GRAD_RTOL/GRAD_ATOL; logits within 1e-4
of the largest |logit|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.fluid.registry import get_op_info as jax_op_info
from paddle_tpu.models import lenet as jlenet
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.models import vgg as jvgg
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import layers as tlayers
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.fluid.registry import (
    FWD_META_ATTR, EmitCtx, forward_with_grad, run_forward, run_grad)
from paddle_tpu_torch.kernels import conv_bn_relu as k5
from paddle_tpu_torch.models import lenet as tlenet
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.models import vgg as tvgg

LOSS_RTOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
OP_RTOL, OP_ATOL = 1e-5, 1e-6
CONV_ATOL = 1e-5
LOGIT_TOL = 1e-4
JAX = (jfluid, jlayers, junique)
PORT = (tfluid, tlayers, tunique)


# --- (a) op parity ----------------------------------------------------

def _port_op(op_type, ins, attrs, dys):
    """Outputs, and the input gradients for the cotangents ``dys`` (out
    slot -> array) through the recorded path and through a replay."""
    ctx = EmitCtx(device="cpu", root_seed=1)
    tins = {s: [torch.from_numpy(v)] for s, v in ins.items()}
    outs, record = forward_with_grad(ctx, op_type, tins, attrs)
    grad_attrs = {FWD_META_ATTR: {"type": op_type, "attrs": attrs,
                                  "in_slots": list(ins),
                                  "out_slots": list(outs)}}
    gins = dict(tins)
    gins.update({"Out@" + s: v for s, v in outs.items()})
    gins.update({"GRAD@" + s: [torch.from_numpy(d)] for s, d in dys.items()})
    grads = [run_grad(ctx, gins, grad_attrs, rec) for rec in (record, None)]
    return ({s: v[0].detach().numpy() for s, v in outs.items()},
            [{s[5:]: v[0].numpy() for s, v in g.items()
              if v and v[0] is not None} for g in grads])


def _jax_op(op_type, ins, attrs, diff_slots, dys):
    fwd = jax_op_info(op_type).forward

    def fn(*diffs):
        full = {s: [jnp.asarray(v)] for s, v in ins.items()}
        full.update({s: [d] for s, d in zip(diff_slots, diffs)})
        return fwd(None, full, attrs)

    primals = [jnp.asarray(ins[s]) for s in diff_slots]
    _, vjp = jax.vjp(lambda *d: {s: fn(*d)[s] for s in dys}, *primals)
    grads = vjp({s: jnp.asarray(d) for s, d in dys.items()})
    return ({s: np.asarray(v) for s, v in fn(*primals).items()},
            dict(zip(diff_slots, (np.asarray(g) for g in grads))))


def _close(got, want, rtol=OP_RTOL, atol=OP_ATOL, what=""):
    assert got.shape == want.shape and got.dtype == want.dtype, what
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=what)


def _op_parity(op_type, ins, attrs, diff_slots, dys, out_slots, atol):
    tout, (recorded, replayed) = _port_op(op_type, ins, attrs, dys)
    jout, jgrads = _jax_op(op_type, ins, attrs, diff_slots, dys)
    for s in out_slots:
        _close(tout[s], jout[s], atol=atol, what=s)
    for s in diff_slots:
        _close(recorded[s], jgrads[s], atol=atol, what="grad " + s)
        np.testing.assert_array_equal(replayed[s], recorded[s])
    return tout


CONVS = [  # N, C, H, W, F, k, stride, padding, dilation, groups
    (2, 3, 9, 9, 4, 3, 1, 0, 1, 1),
    (2, 4, 10, 10, 6, 3, 2, 1, 1, 1),
    (2, 3, 16, 16, 5, 7, 2, 3, 1, 1),
    (2, 4, 11, 11, 4, 3, 1, 2, 2, 1),
    (2, 4, 9, 9, 6, 3, 1, 1, 1, 2),
    (3, 8, 7, 7, 16, 1, 2, 0, 1, 1),
]


@pytest.mark.parametrize("case", CONVS, ids=lambda c: "n{}c{}h{}f{}k{}s{}p{}d{}g{}".format(*c[:3], *c[4:]))
def test_a_conv2d_matches_jax(case):
    n, c, h, w, f, k, s, p, d, g = case
    rng = np.random.RandomState(11)
    x = rng.randn(n, c, h, w).astype(np.float32)
    wt = rng.randn(f, c // g, k, k).astype(np.float32)
    attrs = {"strides": [s, s], "paddings": [p, p], "dilations": [d, d],
             "groups": g}
    oh = (h + 2 * p - d * (k - 1) - 1) // s + 1
    dy = rng.randn(n, f, oh, oh).astype(np.float32)
    out = _op_parity("conv2d", {"Input": x, "Filter": wt}, attrs,
                     ["Input", "Filter"], {"Output": dy}, ["Output"], CONV_ATOL)
    assert out["Output"].shape == (n, f, oh, oh)


BNS = [  # shape, layout, is_test
    ((3, 4, 5, 6), "NCHW", False),
    ((3, 4, 5, 6), "NCHW", True),
    ((8, 5), "NHWC", False),
    ((8, 5), "NHWC", True),
    ((2, 3, 4, 5), "NHWC", False),
]


@pytest.mark.parametrize("shape,layout,is_test", BNS)
def test_a_batch_norm_matches_jax(shape, layout, is_test):
    rng = np.random.RandomState(5)
    c = shape[1] if layout == "NCHW" else shape[-1]
    ins = {"X": (rng.randn(*shape) * 2 + 0.5).astype(np.float32),
           "Scale": (rng.rand(c) + 0.5).astype(np.float32),
           "Bias": rng.randn(c).astype(np.float32),
           "Mean": rng.randn(c).astype(np.float32) * 0.1,
           "Variance": (rng.rand(c) + 0.5).astype(np.float32)}
    attrs = {"momentum": 0.9, "epsilon": 1e-5, "is_test": is_test,
             "data_layout": layout}
    dy = rng.randn(*shape).astype(np.float32)
    out = _op_parity("batch_norm", ins, attrs, ["X", "Scale", "Bias"],
                     {"Y": dy}, ["Y", "MeanOut", "VarianceOut", "SavedMean",
                                 "SavedVariance"], OP_ATOL)
    if is_test:
        assert not out["SavedMean"].any() and not out["SavedVariance"].any()


@pytest.mark.parametrize("nesterov", [False, True])
def test_a_momentum_matches_jax(nesterov):
    rng = np.random.RandomState(2)
    ins = {"Param": rng.randn(6, 5).astype(np.float32),
           "Grad": rng.randn(6, 5).astype(np.float32),
           "Velocity": rng.randn(6, 5).astype(np.float32),
           "LearningRate": np.array([0.05], np.float32)}
    attrs = {"mu": 0.9, "use_nesterov": nesterov}
    ctx = EmitCtx(device="cpu")
    got = run_forward(ctx, "momentum",
                      {s: [torch.from_numpy(v)] for s, v in ins.items()},
                      attrs)
    want = jax_op_info("momentum").forward(
        None, {s: [jnp.asarray(v)] for s, v in ins.items()}, attrs)
    for s in ("ParamOut", "VelocityOut"):
        _close(got[s][0].numpy(), np.asarray(want[s]), what=s)


@pytest.mark.parametrize("k", [1, 3])
def test_a_top_k_and_accuracy_match_jax(k):
    rng = np.random.RandomState(4)
    prob = rng.rand(16, 10).astype(np.float32)
    label = rng.randint(0, 10, (16, 1)).astype(np.int64)
    ctx = EmitCtx(device="cpu")
    tk = run_forward(ctx, "top_k", {"X": [torch.from_numpy(prob)]}, {"k": k})
    jk = jax_op_info("top_k").forward(None, {"X": [jnp.asarray(prob)]},
                                      {"k": k})
    _close(tk["Out"][0].numpy(), np.asarray(jk["Out"]), what="Out")
    assert tk["Indices"][0].dtype == torch.int64
    np.testing.assert_array_equal(tk["Indices"][0].numpy(),
                                  np.asarray(jk["Indices"]))
    ta = run_forward(ctx, "accuracy", {
        "Out": tk["Out"], "Indices": tk["Indices"],
        "Label": [torch.from_numpy(label)]}, {})
    ja = jax_op_info("accuracy").forward(None, {
        "Out": [jk["Out"]], "Indices": [jk["Indices"]],
        "Label": [jnp.asarray(label)]}, {})
    for s, dtype in (("Accuracy", torch.float32), ("Correct", torch.int32),
                     ("Total", torch.int32)):
        assert ta[s][0].dtype == dtype and ta[s][0].shape == (1,)
        np.testing.assert_array_equal(ta[s][0].numpy(), np.asarray(ja[s]))
    assert 0 < int(ta["Correct"][0]) < 16 and int(ta["Total"][0]) == 16


# --- (b) program equality ----------------------------------------------

def _build(pkg, model, kind, hw, lr=0.01, with_test=False):
    """Main and startup programs of ``kind`` with Momentum(lr, 0.9);
    with ``with_test`` also the test-mode clone taken before minimize."""
    fluid, layers, unique_name = pkg
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with unique_name.guard(), fluid.program_guard(main, startup):
        c = 1 if kind == "lenet" else 3
        img = layers.data(name="img", shape=[c, hw, hw], dtype="float32")
        label = layers.data(name="label", shape=[1], dtype="int64")
        if kind == "lenet":
            cost, _, _ = model.build(img, label)
        elif kind == "vgg":
            cost, _, _ = model.build_train(img, label, class_dim=10)
        elif kind == "resnet50":
            cost, _, _ = model.build_train(img, label, class_dim=1000,
                                           depth=50)
        else:
            cost, _, _ = model.build_train(img, label, class_dim=10,
                                           depth=8, variant="cifar")
        test = main.clone(for_test=True) if with_test else None
        _, pg = fluid.optimizer.Momentum(learning_rate=lr,
                                         momentum=0.9).minimize(cost)
    return main, startup, cost, [(p.name, g.name) for p, g in pg], test


def _var_table(program):
    return {n: (tuple(v.shape) if v.shape is not None else None, v.dtype,
                v.persistable, v.desc.is_parameter)
            for n, v in program.global_block().vars.items()}


def _ops(program):
    return [(op.type, op.desc.inputs, op.desc.outputs, op.desc.attrs)
            for op in program.global_block().ops]


@pytest.mark.parametrize("kind,hw", [("resnet50", 64), ("lenet", 32),
                                     ("vgg", 32)])
def test_b_training_program_equals_jax(kind, hw):
    models = {"resnet50": (jresnet, tresnet), "lenet": (jlenet, tlenet),
              "vgg": (jvgg, tvgg)}[kind]
    jm, js, _, jpg, _ = _build(JAX, models[0], kind, hw)
    tm, ts, _, tpg, _ = _build(PORT, models[1], kind, hw)
    assert tpg == jpg
    for jp, tp in ((jm, tm), (js, ts)):
        assert _ops(tp) == _ops(jp)
        jt, tt = _var_table(jp), _var_table(tp)
        # the top_k Indices var is int64 in both programs, but the JAX
        # package runs without x64 and its shape inference records the
        # int32 it computes in
        for op in tp.global_block().ops:
            if op.type == "top_k":
                name = op.output("Indices")[0]
                assert jt[name][1] == "int32" and tt[name][1] == "int64"
                jt[name] = tt[name]
        assert tt == jt
    types = [op.type for op in tm.global_block().ops]
    if kind == "resnet50":
        assert types.count("conv2d") == types.count("batch_norm") == 53
        assert types.count("conv2d_grad") == 53
        assert types.count("momentum") == len(tpg) == 161
        assert sum(int(np.prod(p.shape)) for p in
                   tm.global_block().all_parameters()) == 25_557_032


# --- (c) training parity -----------------------------------------------

def _jax_persistables(program, scope):
    return {n: np.asarray(scope.find_var(n))
            for n, v in program.global_block().vars.items()
            if v.persistable and scope.find_var(n) is not None}


def _train_both(kind, models, hw, feeds, lr, fetch_stats=False):
    """JAX startup, its persistables copied to the port, then the same
    feeds through both. Per side: losses, step-1 gradients, and (with
    ``fetch_stats``) every batch-norm running statistic after the steps."""
    jm, js, jcost, pg, _ = _build(JAX, models[0], kind, hw, lr)
    tm, _, tcost, _, _ = _build(PORT, models[1], kind, hw, lr)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    texe, tscope = tfluid.Executor("cpu"), tfluid.Scope()
    tfluid.params_from_jax(_jax_persistables(jm, jscope), tscope,
                           device="cpu")
    stats = [n for op in tm.global_block().ops if op.type == "batch_norm"
             for n in op.output("MeanOut") + op.output("VarianceOut")]
    out = {}
    for side, exe, prog, cost, scope in (("jax", jexe, jm, jcost, jscope),
                                         ("torch", texe, tm, tcost, tscope)):
        losses, grads = [], None
        for i, feed in enumerate(feeds):
            fetched = exe.run(prog, feed=feed, scope=scope,
                              fetch_list=[cost] + ([g for _, g in pg]
                                                   if i == 0 else []))
            losses.append(float(np.asarray(fetched[0]).reshape(-1)[0]))
            if i == 0:
                grads = [np.asarray(g) for g in fetched[1:]]
        out[side] = (losses, grads,
                     [np.asarray(scope.find_var(n)) for n in stats])
    return out, pg, stats


def _images(rng, n, c, hw, classes):
    return {"img": rng.randn(n, c, hw, hw).astype(np.float32),
            "label": rng.randint(0, classes, (n, 1)).astype(np.int64)}


def _hold(out, pg):
    (jl, jg, _), (tl, tg, _) = out["jax"], out["torch"]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert len(tg) == len(jg) == len(pg) > 0
    for (name, _), a, b in zip(pg, tg, jg):
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_c_lenet_momentum_trains_like_jax():
    """The port's twin of test_torch_parity.py's LeNet loss curve: the
    repo's LeNet (models/lenet.py), Momentum(0.05, 0.9), batch 16, 8
    steps."""
    rng = np.random.RandomState(0)
    feeds = [_images(rng, 16, 1, 28, 10) for _ in range(8)]
    out, pg = _train_both("lenet", (jlenet, tlenet), 28, feeds, 0.05)[:2]
    _hold(out, pg)
    assert out["torch"][0][-1] < out["torch"][0][0]


def test_c_resnet_cifar_momentum_trains_like_jax():
    """resnet_cifar10(depth=8) + Momentum(0.01, 0.9), batch 4, 3 steps:
    losses, step-1 gradients, and every running mean and variance after
    the steps (written back to the scope by the executor)."""
    rng = np.random.RandomState(1)
    feeds = [_images(rng, 4, 3, 32, 10) for _ in range(3)]
    out, pg, stats = _train_both("cifar", (jresnet, tresnet), 32, feeds,
                                 0.01)
    _hold(out, pg)
    assert len(stats) == 2 * 9
    for i, (name, a, b) in enumerate(zip(stats, out["torch"][2],
                                         out["jax"][2])):
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
        # moved off its initial value: means start at 0, variances at 1
        assert not np.all(a == float(i % 2)), name


def test_c_vgg16_test_logits_match_jax_and_a_step_is_finite():
    """VGG-16 (vgg16_bn_drop, 32x32, 10 classes): jax.random's dropout
    masks cannot be matched, so the test-mode clone's logits are
    compared after copying the JAX parameters; a training step on the
    port gives a finite loss."""
    jm, js, _, _, jtest = _build(JAX, jvgg, "vgg", 32, with_test=True)
    tm, _, tcost, _, ttest = _build(PORT, tvgg, "vgg", 32, with_test=True)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    texe, tscope = tfluid.Executor("cpu"), tfluid.Scope()
    tfluid.params_from_jax(_jax_persistables(jm, jscope), tscope,
                           device="cpu")
    feed = _images(np.random.RandomState(3), 2, 3, 32, 10)
    name = chip_smoke.logits_var(ttest)
    want = jexe.run(jtest, feed=feed, fetch_list=[name], scope=jscope)[0]
    got = texe.run(ttest, feed=feed, fetch_list=[name], scope=tscope)[0]
    assert got.shape == want.shape == (2, 10)
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()
    (loss,) = texe.run(tm, feed=feed, fetch_list=[tcost], scope=tscope)
    assert np.isfinite(loss).all()


# --- (d) the fold: trained statistics through the fused form -----------

def test_d_trained_statistics_fold_into_the_fused_resnet():
    """Train resnet_cifar10(depth=8) for 2 steps on the port, fold every
    conv2d + batch_norm pair into the fused program (chip_smoke.py's
    mapping), and its logits (the K5 plain version) equal the unfused
    test-mode network's."""
    tm, ts, _, _, ttest = _build(PORT, tresnet, "cifar", 32,
                                 with_test=True)
    exe, scope = tfluid.Executor("cpu"), tfluid.Scope()
    exe.run(ts, scope=scope)
    rng = np.random.RandomState(6)
    for _ in range(2):
        exe.run(tm, feed=_images(rng, 4, 3, 32, 10), scope=scope)
    fm, fs = tfluid.Program(), tfluid.Program()
    with tunique.guard(), tfluid.program_guard(fm, fs):
        img = tlayers.data(name="img", shape=[3, 32, 32], dtype="float32")
        flogits = tresnet.resnet_cifar10(img, class_dim=10, depth=8,
                                         is_test=True, fused=True)
    fscope = tfluid.Scope()
    exe.run(fs, scope=fscope)
    assert chip_smoke.fold_trained_network(ttest, scope, fm, fscope) == 9
    feed = _images(rng, 3, 3, 32, 10)
    ulogits = chip_smoke.logits_var(ttest)
    want = exe.run(ttest, feed=feed, fetch_list=[ulogits], scope=scope)[0]
    before = k5.counts.plain_calls[k5.KERNEL]
    got = exe.run(fm, feed={"img": feed["img"]}, fetch_list=[flogits],
                  scope=fscope)[0]
    assert k5.counts.plain_calls[k5.KERNEL] - before == 9
    assert got.shape == want.shape == (3, 10)
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()


# --- (e) matmul_precision ----------------------------------------------

_PROBE = "_matmul_precision_probe"
_seen = []


def _probe_program():
    from paddle_tpu_torch.fluid import registry

    if _PROBE not in registry.OPS:
        @registry.register_op(_PROBE)
        def _probe(ctx, ins, attrs):
            _seen.append((torch.backends.cudnn.allow_tf32,
                          torch.get_float32_matmul_precision()))
            return {"Out": ins["X"][0] + 1}
    main = tfluid.Program()
    blk = main.global_block()
    x = blk.create_var(name="x", shape=[2], dtype="float32")
    blk.append_op(type=_PROBE, inputs={"X": [x]}, outputs={"Out": ["y"]})
    return main


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_e_executor_honours_matmul_precision(precision, monkeypatch):
    """Under 'highest' an op run by Executor.run sees TF32 off in cuDNN
    and cuBLAS whatever the caller set, and the caller's settings are
    back after the run; 'high' leaves them as the caller set them."""
    from paddle_tpu_torch.flags import FLAGS

    main = _probe_program()
    monkeypatch.setitem(FLAGS, "matmul_precision", precision)
    saved = (torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    try:
        _seen.clear()
        (y,) = tfluid.Executor("cpu").run(
            main, feed={"x": np.zeros(2, np.float32)}, fetch_list=["y"])
        want = (False, "highest") if precision == "highest" \
            else (True, "high")
        assert _seen == [want] and (y == 1).all()
        assert (torch.backends.cudnn.allow_tf32,
                torch.get_float32_matmul_precision()) == (True, "high")
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


def test_e_unknown_matmul_precision_raises(monkeypatch):
    from paddle_tpu_torch.flags import FLAGS

    monkeypatch.setitem(FLAGS, "matmul_precision", "bf16")
    with pytest.raises(ValueError, match="matmul_precision"):
        tfluid.Executor("cpu").run(_probe_program(),
                                   feed={"x": np.zeros(2, np.float32)})
