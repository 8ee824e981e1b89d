"""The v2 slice's op and feed in the port against the JAX package's, on
the CPU:

  - a bfloat16 numpy feed (``ml_dtypes.bfloat16``) through the port's
    ``Executor`` and, in a process of its own, a one-device
    ``ParallelExecutor``: the fetch equals the JAX package's bfloat16
    result widened to float32, bitwise, with the data var declared
    ``float32`` and ``bfloat16``;
  - ``conv2d_input_filter`` (X ``[N, C, H, W]`` with a computed per-sample
    filter ``[N, F, C, k, k]``, C != F) in both ``trans`` forms, stride 1
    and 2, padding 0 and 1: the program bytes, the output and the
    gradients of X and Filter through each package's own
    ``calc_gradient``, within rtol 1e-5 / atol 1e-5;
  - ``v2.layer.conv_operator`` inside a ``mixed_layer``, as the v2 sweep
    builds it, forward and both forms;
  - the v2 device rule: ``init(use_gpu=False)`` selects the CPU, a bare
    ``init()``, or no ``init`` and no ``device=``, means the card (a
    raise here), and a
    trainer never moves parameters to another device;
  - ``import paddle_tpu_torch.v2`` (and ``compat``) leaves PIL, cv2 and
    matplotlib unimported.
"""
import json
import os
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu.v2 as jv2
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import unique_name as junique
import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.v2 as tv2
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.fluid.executor import _as_feed
from paddle_tpu_torch.v2 import parameters as tparameters

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-5
JAX = (jfluid, jv2, junique, jframework)
PORT = (tfluid, tv2, tunique, tframework)
BF16_FEED = (np.arange(12, dtype=np.float32).reshape(3, 4) / 7).astype(
    ml_dtypes.bfloat16)


# --- the bfloat16 numpy feed ------------------------------------------------

def _scale_program(pkg, dtype):
    fluid, _, _, fw = pkg
    main, startup = fw.Program(), fw.Program()
    with fw.program_guard(main, startup):
        a = fluid.layers.data("a", [4], dtype=dtype)
        out = fluid.layers.scale(a, 2.0)
    return main, startup, out


def _jax_bf16_widened(dtype):
    main, startup, out = _scale_program(JAX, dtype)
    exe = jfluid.Executor()
    scope = jfluid.Scope()
    exe.run(startup, scope=scope)
    (got,) = exe.run(main, feed={"a": BF16_FEED}, fetch_list=[out],
                     scope=scope)
    got = np.asarray(got)
    assert got.dtype == ml_dtypes.bfloat16
    return got.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bf16_numpy_feed_runs_through_the_executor(dtype):
    """The port's fetch is the JAX package's bfloat16 result widened to
    float32 (decided difference 2), bitwise."""
    main, startup, out = _scale_program(PORT, dtype)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    (got,) = exe.run(main, feed={"a": BF16_FEED}, fetch_list=[out],
                     scope=scope)
    want = _jax_bf16_widened(dtype)
    assert got.dtype == np.float32 and got.shape == (3, 4)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert float(got.sum()) == 18.8515625
    # a 0-d bfloat16 feed stays 0-d, as a 0-d float32 feed does
    scalar = _as_feed(BF16_FEED[1, 2], torch.device("cpu"))
    assert scalar.shape == () and scalar.dtype == torch.bfloat16
    assert scalar.float().item() == float(BF16_FEED[1, 2])


_PE_CHILD = r"""
import json, sys
import ml_dtypes, numpy as np
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid.framework import Program, program_guard
feed = (np.arange(12, dtype=np.float32).reshape(3, 4) / 7).astype(
    ml_dtypes.bfloat16)
res = {}
for dtype in ("float32", "bfloat16"):
    main, startup = Program(), Program()
    with program_guard(main, startup):
        a = fluid.layers.data("a", [4], dtype=dtype)
        out = fluid.layers.scale(a, 2.0)
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    with fluid.scope_guard(scope):
        pe = fluid.ParallelExecutor(use_cuda=False, main_program=main)
    (got,) = pe.run(fetch_list=[out.name], feed={"a": feed})
    got = np.asarray(got)
    res[dtype] = [str(got.dtype), got.view(np.uint32).tolist()]
print(json.dumps(res))
"""


def test_bf16_numpy_feed_runs_through_the_parallel_executor():
    """The same feed on a one-device CPU mesh, in a process of its own
    (the executor starts a process group there)."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", _PE_CHILD], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for dtype in ("float32", "bfloat16"):
        want = _jax_bf16_widened(dtype)
        assert res[dtype][0] == "float32"
        assert res[dtype][1] == want.view(np.uint32).tolist()


# --- conv2d_input_filter ----------------------------------------------------

N, C, H, W, NF, K = 2, 3, 5, 6, 4, 3  # C != F: a wrong filter transpose shows


def _out_hw(stride, padding, trans):
    if trans:
        return ((H - 1) * stride - 2 * padding + K,
                (W - 1) * stride - 2 * padding + K)
    return ((H + 2 * padding - K) // stride + 1,
            (W + 2 * padding - K) // stride + 1)


def _op_program(pkg, attrs):
    fluid, v2, unique, fw = pkg
    layers = fluid.layers
    main, startup = fw.Program(), fw.Program()
    with fw.program_guard(main, startup), unique.guard():
        x = layers.data("x", [C, H, W])
        f = layers.data("f", [NF, C, K, K])
        x.stop_gradient = f.stop_gradient = False
        out = v2.layer._raw_op("conv2d_input_filter",
                               {"X": [x], "Filter": [f]}, attrs)
        dy = layers.data("dy", [-1], append_batch_size=False)
        loss = layers.reduce_sum(layers.elementwise_mul(
            layers.reshape(out, [-1]), dy))
        gx, gf = fluid.calc_gradient(loss, [x, f])
    return main, startup, [out, gx, gf]


def _run(pkg, main, startup, fetch, feed):
    fluid = pkg[0]
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    return [np.asarray(v) for v in exe.run(main, feed=feed,
                                           fetch_list=fetch, scope=scope)]


@pytest.mark.parametrize("trans", [False, True], ids=["fwd", "trans"])
@pytest.mark.parametrize("stride,padding", [(1, 0), (1, 1), (2, 0), (2, 1)])
def test_conv2d_input_filter_matches_jax(trans, stride, padding):
    """Output and the gradients of X and Filter (each package's
    ``calc_gradient``) for a seeded cotangent."""
    attrs = {"stride": stride, "padding": padding, "trans": trans}
    rng = np.random.RandomState(100 * stride + 10 * padding + trans)
    oh, ow = _out_hw(stride, padding, trans)
    feed = {"x": rng.randn(N, C, H, W).astype(np.float32),
            "f": rng.randn(N, NF, C, K, K).astype(np.float32),
            "dy": rng.randn(N * NF * oh * ow).astype(np.float32)}
    tm, ts, tfetch = _op_program(PORT, attrs)
    jm, js, jfetch = _op_program(JAX, attrs)
    assert tm.to_bytes() == jm.to_bytes()
    got = _run(PORT, tm, ts, tfetch, feed)
    want = _run(JAX, jm, js, jfetch, feed)
    assert got[0].shape == (N, NF, oh, ow)
    assert got[1].shape == (N, C, H, W) and got[2].shape == (N, NF, C, K, K)
    for name, g, w in zip(("Out", "X@GRAD", "Filter@GRAD"), got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=name)


def test_conv2d_input_filter_forward_is_per_sample_conv():
    """Sample n meets only its own filter: the port's op against
    ``F.conv2d`` / ``F.conv_transpose2d`` one sample at a time."""
    from paddle_tpu_torch.fluid.registry import EmitCtx, run_forward

    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(N, C, H, W).astype(np.float32))
    f = torch.from_numpy(rng.randn(N, NF, C, K, K).astype(np.float32))
    ctx = EmitCtx(device="cpu")
    for trans in (False, True):
        (out,) = run_forward(ctx, "conv2d_input_filter",
                             {"X": [x], "Filter": [f]},
                             {"stride": 2, "padding": 1,
                              "trans": trans})["Out"]
        for n in range(N):
            if trans:
                ref = torch.nn.functional.conv_transpose2d(
                    x[n:n + 1], f[n].transpose(0, 1), None, 2, 1)
            else:
                ref = torch.nn.functional.conv2d(x[n:n + 1], f[n], None, 2,
                                                 1)
            torch.testing.assert_close(out[n:n + 1], ref, rtol=RTOL,
                                       atol=ATOL)


def _conv_operator_program(pkg, trans):
    fluid, v2, unique, fw = pkg
    main, startup = fw.Program(), fw.Program()
    with fw.program_guard(main, startup), unique.guard():
        img = v2.layer.data(name="img",
                            type=v2.layer.data_type.dense_vector(C * 8 * 8))
        x4 = fluid.layers.reshape(img, shape=[-1, C, 8, 8])
        filt = v2.layer.data(
            name="filt", type=v2.layer.data_type.dense_vector(NF * C * K * K))
        out = v2.layer.mixed_layer(input=[v2.layer.conv_operator(
            x4, filt, filter_size=K, num_filters=NF, padding=1,
            trans=trans)])
    return main, startup, [out]


@pytest.mark.parametrize("trans", [False, True], ids=["fwd", "trans"])
def test_conv_operator_in_mixed_layer_matches_jax(trans):
    rng = np.random.RandomState(5)
    feed = {"img": rng.rand(N, C * 8 * 8).astype(np.float32),
            "filt": rng.rand(N, NF * C * K * K).astype(np.float32)}
    tm, ts, tfetch = _conv_operator_program(PORT, trans)
    jm, js, jfetch = _conv_operator_program(JAX, trans)
    assert tm.to_bytes() == jm.to_bytes()
    (got,) = _run(PORT, tm, ts, tfetch, feed)
    (want,) = _run(JAX, jm, js, jfetch, feed)
    assert got.shape == (N, NF * 8 * 8)  # padding 1, k 3: both keep 8x8
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# --- the v2 device rule -----------------------------------------------------

def _fc_topology():
    x = tv2.layer.data(name="x", type=tv2.layer.data_type.dense_vector(4))
    y = tv2.layer.data(name="y", type=tv2.layer.data_type.dense_vector(1))
    pred = tv2.layer.fc_layer(input=x, size=1)
    return pred, tv2.layer.square_error_cost(input=pred, label=y)


def test_v2_device_rule(monkeypatch):
    """No ``init`` and no ``device=`` means the card, which raises here;
    so does a bare ``init()``; ``init(use_gpu=False)`` is the CPU for create, SGD and infer; an
    explicit ``device=`` wins; a trainer on another device than its
    parameters raises instead of moving them."""
    monkeypatch.setattr(tparameters, "_init_device", None)
    main, startup = tframework.Program(), tframework.Program()
    with tfluid.scope_guard(tfluid.Scope()), \
            tframework.program_guard(main, startup), tunique.guard():
        pred, cost = _fc_topology()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tv2.create(cost)
        params = tv2.create(cost, device="cpu")
        assert params.device == torch.device("cpu")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tv2.infer(output_layer=pred, parameters=params,
                      input=[(np.ones(4, np.float32),)])
        with pytest.raises(ValueError, match="parameters live on 'cpu'"):
            tv2.SGD(cost=cost, parameters=params, device="meta",
                    update_equation=tv2.optimizer.Momentum())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tv2.init()
        assert tparameters._init_device is None
        tv2.init(use_gpu=False)
        assert tparameters._init_device == torch.device("cpu")
        trainer = tv2.SGD(cost=cost, parameters=params,
                          update_equation=tv2.optimizer.Momentum())
        assert trainer._exe.device == torch.device("cpu")
        out = tv2.infer(output_layer=pred, parameters=params,
                        input=[(np.ones(4, np.float32),)])
        assert out.shape == (1, 1) and np.isfinite(out).all()
        for name in params.names():
            assert params.scope.find_var(name).device.type == "cpu"


# --- imports ------------------------------------------------------------------

def test_v2_import_leaves_image_and_plot_libraries_unimported():
    """The card's machine has no PIL, cv2 or matplotlib: v2 and compat
    import them only inside the functions that need them."""
    code = ("import sys, paddle_tpu_torch.v2, paddle_tpu_torch.v2.image, "
            "paddle_tpu_torch.v2.plot, paddle_tpu_torch.v2.trainer_cli, "
            "paddle_tpu_torch.v2.master, paddle_tpu_torch.compat; "
            "print(sorted(m for m in ('PIL', 'cv2', 'matplotlib', 'jax', "
            "'paddle_tpu') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
