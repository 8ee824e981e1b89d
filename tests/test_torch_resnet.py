"""The port's fused ResNet (paddle_tpu_torch/models/resnet.py, the
conv2d_bn_relu and pool2d ops, fluid/io.py) against the JAX package's,
through the saved inference artifact, on the CPU:

  (a) resnet_imagenet(depth=50, fused=True, is_test=True) at 64x64
      builds the same program in both: op types and their inputs and
      outputs, every variable's name, shape and dtype, the parameters;
  (b) a fused resnet_cifar10(depth=8) saved by the JAX package loads in
      the port and gives the JAX logits, with the JAX Pallas route
      (interpret) and without it;
  (c) the same for ResNet-50 at 64x64 against the JAX default route;
  (d) a ResNet the port saves loads in the JAX package with the same
      logits; and pool2d (max, avg exclusive and not, global, ceil_mode)
      equals the JAX op.

Tolerance: logits within 1e-4 of the largest |logit| (float32; XLA's
convolution and the plain version's im2col GEMM sum in other orders).
"""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.fluid.flags import FLAGS as JFLAGS, set_flags
from paddle_tpu.models import resnet as jresnet
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import layers as tlayers
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.kernels import conv_bn_relu as k5
from paddle_tpu_torch.models import resnet as tresnet

RTOL = 1e-4
JAX = (jfluid, jlayers, junique, jresnet)
PORT = (tfluid, tlayers, tunique, tresnet)


def _build(pkg, variant, depth, hw):
    fluid, layers, unique_name, resnet = pkg
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with unique_name.guard(), fluid.program_guard(main, startup):
        img = layers.data(name="img", shape=[3, hw, hw], dtype="float32")
        model = (resnet.resnet_imagenet if variant == "imagenet"
                 else resnet.resnet_cifar10)
        logits = model(img, depth=depth, is_test=True, fused=True)
    return main, startup, logits


def _var_table(program):
    return [(n, v.shape, v.dtype, v.persistable, v.desc.is_parameter)
            for n, v in program.global_block().vars.items()]


def _close(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


def _jax_save(tmp_path, variant, depth, hw):
    jm, js, jl = _build(JAX, variant, depth, hw)
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    d = str(tmp_path / "jax_saved")
    with jfluid.scope_guard(scope):
        exe.run(js)
        jfluid.save_inference_model(d, ["img"], [jl], exe, jm)
    return d


def _jax_logits(d, x):
    exe, scope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    with jfluid.scope_guard(scope):
        prog, feeds, fetches = jfluid.load_inference_model(d, exe)
        return exe.run(prog, feed={feeds[0]: x}, fetch_list=fetches)[0]


def _port_logits(d, x):
    exe, scope = tfluid.Executor("cpu"), tfluid.Scope()
    prog, feeds, fetches = tfluid.load_inference_model(d, exe, scope=scope)
    assert all(scope.find_var(v.name).device.type == "cpu"
               for v in prog.list_vars() if v.persistable)
    return exe.run(prog, feed={feeds[0]: x}, fetch_list=fetches,
                   scope=scope)[0]


def _images(hw):
    return np.random.RandomState(7).randn(2, 3, hw, hw).astype(np.float32)


def test_a_resnet50_program_equals_jax():
    jm, js, _ = _build(JAX, "imagenet", 50, 64)
    tm, ts, _ = _build(PORT, "imagenet", 50, 64)
    for jp, tp in ((jm, tm), (js, ts)):
        assert [(op.type, op.desc.inputs, op.desc.outputs)
                for op in tp.global_block().ops] == \
            [(op.type, op.desc.inputs, op.desc.outputs)
             for op in jp.global_block().ops]
        assert _var_table(tp) == _var_table(jp)
    types = [op.type for op in tm.global_block().ops]
    assert types.count("conv2d_bn_relu") == 53
    assert types.count("pool2d") == 2 and types.count("elementwise_add") == 17
    params = tm.global_block().all_parameters()
    assert [p.name for p in params] == \
        [p.name for p in jm.global_block().all_parameters()]
    assert sum(int(np.prod(p.shape)) for p in params) == 25_557_032


@pytest.mark.parametrize("pallas", [True, False])
def test_b_jax_saved_cifar_resnet_loads_in_port(tmp_path, pallas):
    saved = JFLAGS["use_pallas_kernels"]
    set_flags({"use_pallas_kernels": pallas})
    try:
        d = _jax_save(tmp_path, "cifar", 8, 32)
        x = _images(32)
        want = _jax_logits(d, x)
    finally:
        set_flags({"use_pallas_kernels": saved})
    before = k5.counts.plain_calls[k5.KERNEL]
    got = _port_logits(d, x)
    assert k5.counts.plain_calls[k5.KERNEL] - before == 9
    _close(got, want)


def test_c_jax_saved_resnet50_loads_in_port(tmp_path):
    d = _jax_save(tmp_path, "imagenet", 50, 64)
    x = _images(64)
    _close(_port_logits(d, x), _jax_logits(d, x))


def test_d_port_saved_resnet_loads_in_jax(tmp_path):
    tm, ts, tl = _build(PORT, "cifar", 8, 32)
    exe, scope = tfluid.Executor("cpu"), tfluid.Scope()
    exe.run(ts, scope=scope)
    d = str(tmp_path / "port_saved")
    # executor None: the save ops run on the host, never through a
    # fresh Executor() (which would mean the card)
    with tfluid.scope_guard(scope):
        tfluid.save_inference_model(d, ["img"], [tl], None, tm)
    x = _images(32)
    want = exe.run(tm, feed={"img": x}, fetch_list=[tl], scope=scope)[0]
    _close(_jax_logits(d, x), want)
    _close(_port_logits(d, x), want)


POOLS = [
    dict(pool_type="max", pool_size=3, pool_stride=2, pool_padding=1),
    dict(pool_type="avg", pool_size=3, pool_stride=2, pool_padding=1),
    dict(pool_type="avg", pool_size=2, pool_stride=1, pool_padding=1),
    dict(pool_type="avg", pool_size=7, global_pooling=True),
    dict(pool_type="max", pool_size=3, pool_stride=2, ceil_mode=True),
    dict(pool_type="avg", pool_size=2, pool_stride=2, pool_padding=1,
         ceil_mode=True),
]


@pytest.mark.parametrize("kw", POOLS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_d_pool2d_matches_jax(kw):
    x = np.random.RandomState(1).randn(2, 3, 8, 7).astype(np.float32)
    outs = []
    for fluid, layers, unique_name, _ in (JAX, PORT):
        main, startup = fluid.Program(), fluid.Program()
        with unique_name.guard(), fluid.program_guard(main, startup):
            inp = layers.data(name="x", shape=[3, 8, 7], dtype="float32")
            out = layers.pool2d(inp, **kw)
        exe = fluid.Executor(fluid.CPUPlace())
        outs.append((out.shape, exe.run(main, feed={"x": x},
                                        fetch_list=[out])[0]))
    (jshape, want), (tshape, got) = outs
    assert tshape == jshape and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_unfused_and_training_forms_build():
    """The unfused form (conv2d + batch_norm) and build_train build: 9
    conv/bn pairs in resnet_cifar10(depth=8), and the training outputs
    (cost, accuracy, prediction) with their shapes."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tunique.guard(), tfluid.program_guard(main, startup):
        img = tlayers.data(name="img", shape=[3, 32, 32], dtype="float32")
        label = tlayers.data(name="label", shape=[1], dtype="int64")
        logits = tresnet.resnet_cifar10(img, depth=8, fused=False)
        cost, acc, pred = tresnet.build_train(img, label, class_dim=10,
                                              depth=8, variant="cifar")
    types = [op.type for op in main.global_block().ops]
    assert types.count("conv2d") == types.count("batch_norm") == 18
    assert "conv2d_bn_relu" not in types
    assert logits.shape == pred.shape == (-1, 10)
    assert cost.shape == acc.shape == (1,) and acc.dtype == "float32"


def test_io_save_load_vars_roundtrip(tmp_path):
    """save_vars / load_vars in both forms (one .npy per var, and one
    .npz): the values come back on the executor's device; a load needs
    an executor, a save of a missing var writes nothing."""
    scope = tfluid.Scope()
    vals = {"a": torch.arange(6.0).reshape(2, 3), "b/c": torch.ones(4)}
    for n, v in vals.items():
        scope.set_var(n, v)
    exe = tfluid.Executor("cpu")
    for filename in (None, "all"):
        d = str(tmp_path / f"vars_{filename}")
        tfluid.io.save_vars(exe, d, vars=list(vals), filename=filename,
                            scope=scope)
        back = tfluid.Scope()
        tfluid.io.load_vars(exe, d, vars=list(vals), filename=filename,
                            scope=back)
        for n, v in vals.items():
            assert torch.equal(back.find_var(n), v)
    with pytest.raises(ValueError, match="needs the Executor"):
        tfluid.io.load_vars(None, d, vars=list(vals), scope=back)
    d = str(tmp_path / "missing")
    with pytest.raises(RuntimeError, match="not initialized in scope"):
        tfluid.io.save_vars(exe, d, vars=["a", "nope"], filename="x",
                            scope=scope)
    with pytest.raises(RuntimeError, match="nothing was written"):
        tfluid.io.save_vars(None, d, vars=["a", "nope"], filename="x",
                            scope=scope)
    import os

    assert os.listdir(d) == []
