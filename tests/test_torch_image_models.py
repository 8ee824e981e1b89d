"""The legacy benchmark suite's image models (``models/{alexnet,googlenet,
smallnet}.py``) and ``nets.glu`` / ``nets.scaled_dot_product_attention``
in the port against the JAX package's, on the CPU, at
``tests/test_models.py``'s reduced sizes (96x96, SmallNet 32x32; batch 2):

  (a) each model with Momentum(0.01, 0.9) builds the same ops, attrs and
      variables in both packages;
  (b) SmallNet (no dropout) trains 3 steps from the JAX scope's values
      with losses within rtol 2e-5 (the Transformer test's LOSS_RTOL);
  (c) AlexNet and GoogLeNet: jax.random's dropout masks cannot be
      matched, so the test-mode clone's logits are compared after
      copying the JAX parameters (within 1e-4 of the largest |logit|,
      as VGG's in ``tests/test_torch_resnet_train.py``), and a training
      step on the port gives a finite loss;
  (d) the two nets on the same feeds: outputs within rtol 1e-5.
"""
import numpy as np
import pytest

import chip_smoke
import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid import nets as jnets
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.models import alexnet as jalexnet
from paddle_tpu.models import googlenet as jgooglenet
from paddle_tpu.models import smallnet as jsmallnet
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import layers as tlayers
from paddle_tpu_torch.fluid import nets as tnets
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.models import alexnet as talexnet
from paddle_tpu_torch.models import googlenet as tgooglenet
from paddle_tpu_torch.models import smallnet as tsmallnet

LOSS_RTOL = 2e-5
LOGIT_TOL = 1e-4
OUT_RTOL, OUT_ATOL = 1e-5, 1e-6
JAX = (jfluid, jlayers, junique)
PORT = (tfluid, tlayers, tunique)
MODELS = {"alexnet": (jalexnet, talexnet, 96, 1000),
          "googlenet": (jgooglenet, tgooglenet, 96, 1000),
          "smallnet": (jsmallnet, tsmallnet, 32, 10)}


def _build(pkg, model, hw, classes):
    """Main, startup, cost and the test clone (taken before minimize) of
    ``model.build_train`` with Momentum(0.01, 0.9)."""
    fluid, layers, unique_name = pkg
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with unique_name.guard(), fluid.program_guard(main, startup):
        img = layers.data(name="img", shape=[3, hw, hw], dtype="float32")
        label = layers.data(name="label", shape=[1], dtype="int64")
        cost, _, _ = model.build_train(img, label, class_dim=classes)
        test = main.clone(for_test=True)
        fluid.optimizer.Momentum(learning_rate=0.01,
                                 momentum=0.9).minimize(cost)
    return main, startup, cost, test


def _feed(rng, hw, classes):
    return {"img": rng.randn(2, 3, hw, hw).astype(np.float32),
            "label": rng.randint(0, classes, (2, 1)).astype(np.int64)}


def _both(name):
    """Both packages' programs, the JAX startup run and its persistables
    copied into the port's scope."""
    jmod, tmod, hw, classes = MODELS[name]
    jm, js, jcost, jtest = _build(JAX, jmod, hw, classes)
    tm, _, tcost, ttest = _build(PORT, tmod, hw, classes)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    texe, tscope = tfluid.Executor("cpu"), tfluid.Scope()
    tfluid.params_from_jax(
        {n: np.asarray(jscope.find_var(n))
         for n, v in jm.global_block().vars.items()
         if v.persistable and jscope.find_var(n) is not None},
        tscope, device="cpu")
    return ((jexe, jscope, jm, jcost, jtest), (texe, tscope, tm, tcost, ttest),
            hw, classes)


def _ops(program):
    return [(op.type, op.desc.inputs, op.desc.outputs, op.desc.attrs)
            for op in program.global_block().ops]


def _var_table(program):
    return {n: (tuple(v.shape) if v.shape is not None else None, v.dtype,
                v.persistable, v.desc.is_parameter)
            for n, v in program.global_block().vars.items()}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_a_training_program_equals_jax(name):
    jmod, tmod, hw, classes = MODELS[name]
    jm, js = _build(JAX, jmod, hw, classes)[:2]
    tm, ts = _build(PORT, tmod, hw, classes)[:2]
    for jp, tp in ((jm, tm), (js, ts)):
        assert _ops(tp) == _ops(jp)
        jt, tt = _var_table(jp), _var_table(tp)
        # accuracy's top_k Indices: int64 in both programs, recorded as
        # the int32 the JAX package computes without x64
        for op in tp.global_block().ops:
            if op.type == "top_k":
                name_ = op.output("Indices")[0]
                assert jt[name_][1] == "int32" and tt[name_][1] == "int64"
                jt[name_] = tt[name_]
        assert tt == jt
    types = [op.type for op in tm.global_block().ops]
    if name == "alexnet":
        assert types.count("lrn") == 2 and types.count("lrn_grad") == 2


def test_b_smallnet_trains_like_jax():
    (jexe, jscope, jm, jcost, _), (texe, tscope, tm, tcost, _), hw, classes \
        = _both("smallnet")
    rng = np.random.RandomState(0)
    feeds = [_feed(rng, hw, classes) for _ in range(3)]
    losses = {}
    for side, exe, prog, cost, scope in (("jax", jexe, jm, jcost, jscope),
                                         ("torch", texe, tm, tcost, tscope)):
        losses[side] = [float(np.asarray(exe.run(
            prog, feed=f, fetch_list=[cost], scope=scope)[0]).reshape(-1)[0])
            for f in feeds]
    np.testing.assert_allclose(losses["torch"], losses["jax"],
                               rtol=LOSS_RTOL)
    assert len(set(losses["torch"])) == 3


@pytest.mark.parametrize("name", ["alexnet", "googlenet"])
def test_c_test_logits_match_jax_and_a_step_is_finite(name):
    (jexe, jscope, _, _, jtest), (texe, tscope, tm, tcost, ttest), hw, \
        classes = _both(name)
    feed = _feed(np.random.RandomState(3), hw, classes)
    logits = chip_smoke.logits_var(ttest)
    want = jexe.run(jtest, feed=feed, fetch_list=[logits], scope=jscope)[0]
    got = texe.run(ttest, feed=feed, fetch_list=[logits], scope=tscope)[0]
    assert got.shape == want.shape == (2, classes)
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()
    (loss,) = texe.run(tm, feed=feed, fetch_list=[tcost], scope=tscope)
    assert np.isfinite(loss).all()


def _net_program(pkg, nets, which):
    fluid, layers, unique_name = pkg
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        if which == "glu":
            x = layers.data(name="x", shape=[6, 8], dtype="float32")
            outs = [nets.glu(x, dim=-1), nets.glu(x, dim=1)]
        else:
            q = layers.data(name="q", shape=[5, 8], dtype="float32")
            k = layers.data(name="k", shape=[7, 8], dtype="float32")
            v = layers.data(name="v", shape=[7, 8], dtype="float32")
            outs = [nets.scaled_dot_product_attention(q, k, v),
                    nets.scaled_dot_product_attention(q, k, v, num_heads=2)]
    return main, outs


@pytest.mark.parametrize("which", ["glu", "sdpa"])
def test_d_nets_match_jax(which):
    rng = np.random.RandomState(9)
    if which == "glu":
        feed = {"x": rng.randn(3, 6, 8).astype(np.float32)}
    else:
        feed = {s: rng.randn(3, n, 8).astype(np.float32)
                for s, n in (("q", 5), ("k", 7), ("v", 7))}
    jm, jouts = _net_program(JAX, jnets, which)
    tm, touts = _net_program(PORT, tnets, which)
    assert _ops(tm) == _ops(jm)
    want = jfluid.Executor(jfluid.CPUPlace()).run(
        jm, feed=feed, fetch_list=jouts, scope=jfluid.Scope())
    got = tfluid.Executor("cpu").run(tm, feed=feed, fetch_list=touts,
                                     scope=tfluid.Scope())
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=OUT_RTOL, atol=OUT_ATOL)
