"""K5's plain version and router (paddle_tpu_torch/kernels/conv_bn_relu.py)
against the JAX package's fused_conv_bn_relu, on the CPU.

The JAX side runs its Pallas kernel in interpret mode, as its own tests
do. Tolerances (float32; im2col GEMMs summed in other orders): forward
2e-5, fold_bn 1e-6 relative, gradients 1e-4, the two SGD losses 1e-5
relative. The CUDA kernel itself runs only on a card (chip_smoke.py's
`infer kernels` phase holds it against this plain version);
test_k5_arithmetic_emulated runs its arithmetic (3xTF32 products in
slices of 32 k, two k-groups, a fixed summation order) on the CPU."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.fluid.flags import FLAGS as JFLAGS, set_flags
from paddle_tpu.fluid.ops.pallas_kernels import conv_bn_relu as jk5
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import layers as tlayers
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.kernels import conv_bn_relu as k5
from test_torch_flash_attention import _tf32_rna, _tf32_trunc

# (x shape, F, k, stride, padding, relu): the JAX tests' four shapes
# (tests/test_pallas_kernels.py), a 1x1/2 projection, the 7x7/2 pad-3
# stem
SHAPES = [
    ((2, 8, 10, 10), 16, 3, 1, 1, True),
    ((2, 8, 9, 9), 12, 3, 2, 0, True),
    ((2, 16, 7, 7), 32, 1, 1, 0, False),
    ((1, 3, 12, 12), 7, 5, 2, 2, True),
    ((2, 16, 9, 9), 24, 1, 2, 0, False),
    ((1, 3, 30, 30), 8, 7, 2, 3, True),
]


def _inputs(seed, shape, f, k):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(f, shape[1], k, k) * 0.1).astype(np.float32)
    scale = (rng.rand(f) + 0.5).astype(np.float32)
    shift = (rng.randn(f) * 0.1).astype(np.float32)
    return x, w, scale, shift


def _jax_fwd(x, w, scale, shift, stride, padding, relu):
    return jk5.fused_conv_bn_relu(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale),
        jnp.asarray(shift), stride=stride, padding=padding, relu=relu,
        block_m=32, interpret=True)


@pytest.mark.parametrize("shape,f,k,stride,padding,relu", SHAPES)
def test_plain_version_matches_jax_kernel(shape, f, k, stride, padding,
                                          relu):
    arrs = _inputs(0, shape, f, k)
    want = np.asarray(_jax_fwd(*arrs, stride, padding, relu))
    got = k5.fused_conv_bn_relu_reference(
        *(torch.from_numpy(a) for a in arrs), stride, padding, relu)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_fold_bn_matches_jax():
    rng = np.random.RandomState(3)
    gamma, beta, mean = (rng.randn(6).astype(np.float32) for _ in range(3))
    var = (rng.rand(6) + 0.2).astype(np.float32)
    want = jk5.fold_bn(*(jnp.asarray(a) for a in (gamma, beta, mean, var)),
                       1e-5)
    got = k5.fold_bn(gamma, beta, mean, var, 1e-5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


@pytest.mark.parametrize("stride,padding,relu", [(1, 1, True),
                                                 (2, 0, False)])
def test_backward_matches_jax_custom_vjp(stride, padding, relu):
    """dx, dW, dscale, dshift of sum(y * g) through the autograd.Function
    against jax.grad through the JAX custom_vjp (Pallas, interpret)."""
    x, w, scale, shift = _inputs(1, (2, 4, 8, 8), 6, 3)
    g = np.random.RandomState(2).randn(
        *_jax_fwd(x, w, scale, shift, stride, padding, relu).shape
    ).astype(np.float32)

    def jloss(x, w, s, b):
        return jnp.sum(jk5.fused_conv_bn_relu(
            x, w, s, b, stride=stride, padding=padding, relu=relu,
            block_m=32, interpret=True) * g)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (x, w, scale, shift)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in
              (x, w, scale, shift)]
    y = k5.fused_conv_bn_relu(*leaves, stride=stride, padding=padding,
                              relu=relu)
    got = torch.autograd.grad((y * torch.from_numpy(g)).sum(), leaves)
    for name, a, b in zip(("dx", "dW", "dscale", "dshift"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


def test_router_cpu_counted_meta_uncounted_other_raises():
    x, w, scale, shift = (torch.from_numpy(a) for a in
                          _inputs(4, (1, 3, 8, 8), 4, 3))
    before = dict(k5.counts.plain_calls), dict(k5.counts.kernel_launches)
    k5.fused_conv_bn_relu_fwd(x, w, scale, shift, 1, 1, True)
    assert k5.counts.plain_calls[k5.KERNEL] == before[0][k5.KERNEL] + 1
    meta = [t.to("meta") for t in (x, w, scale, shift)]
    y = k5.fused_conv_bn_relu_fwd(*meta, 2, 1, True)
    assert y.device.type == "meta" and tuple(y.shape) == (1, 4, 4, 4)
    assert k5.counts.plain_calls[k5.KERNEL] == before[0][k5.KERNEL] + 1
    assert k5.counts.kernel_launches == before[1]
    other = types.SimpleNamespace(device=torch.device("mps"))
    with pytest.raises(ValueError, match="not mps"):
        k5.fused_conv_bn_relu_fwd(other, w, scale, shift, 1, 1, True)


def _build_tiny(fluid, layers, unique_name):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 4
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data(name="x", shape=[3, 8, 8], dtype="float32")
        y = layers.data(name="y", shape=[1], dtype="float32")
        h = layers.conv2d_bn_relu(x, num_filters=4, filter_size=3,
                                  stride=1, padding=1)
        pool = layers.pool2d(h, pool_size=8, pool_type="avg")
        pred = layers.fc(input=pool, size=1)
        cost = layers.mean(layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.SGD(learning_rate=0.01).minimize(cost)
    return main, startup, cost


@pytest.fixture
def jax_pallas_forced():
    saved = JFLAGS["use_pallas_kernels"]
    set_flags({"use_pallas_kernels": True})
    yield
    set_flags({"use_pallas_kernels": saved})


def test_conv2d_bn_relu_op_trains_like_jax_pallas(jax_pallas_forced):
    """The port of test_conv2d_bn_relu_op_uses_pallas_when_forced: two
    SGD steps of conv2d_bn_relu + pool2d + fc from the JAX startup state;
    the losses equal the JAX package's (forced Pallas, interpret) and
    fall, and every forward and backward of the op went through K5's
    router."""
    jm, js, jcost = _build_tiny(jfluid, jlayers, junique)
    tm, _, tcost = _build_tiny(tfluid, tlayers, tunique)
    assert [op.type for op in tm.global_block().ops] == \
        [op.type for op in jm.global_block().ops]
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    tscope = tfluid.Scope()
    tfluid.params_from_jax(
        {n: np.asarray(jscope.find_var(n))
         for n, v in jm.global_block().vars.items()
         if v.persistable and jscope.find_var(n) is not None},
        tscope, device="cpu")
    texe = tfluid.Executor(tfluid.CPUPlace())
    rng = np.random.RandomState(4)
    feed = {"x": rng.randn(4, 3, 8, 8).astype(np.float32),
            "y": rng.randn(4, 1).astype(np.float32)}
    before = k5.counts.plain_calls[k5.KERNEL]
    losses = {"jax": [], "torch": []}
    for _ in range(2):
        losses["jax"].append(float(jexe.run(jm, feed=feed, scope=jscope,
                                             fetch_list=[jcost])[0][0]))
        losses["torch"].append(float(texe.run(tm, feed=feed, scope=tscope,
                                              fetch_list=[tcost])[0][0]))
    np.testing.assert_allclose(losses["torch"], losses["jax"], rtol=1e-5)
    assert losses["torch"][1] < losses["torch"][0]
    assert k5.counts.plain_calls[k5.KERNEL] - before == 2


def _k5_emulated(x, w, scale, shift, stride, padding, relu):
    """K5's arithmetic on the CPU: the implicit GEMM in slices of 32 k;
    each slice's three TF32 products (operands split as the kernel
    splits them) summed exactly and rounded once to float32 (the tensor
    core's truncating summation is not modelled); slice s's sum added in
    float32 to the accumulator of k-group s % 2, then group 1's to group
    0's; the affine in two roundings and relu. Returns NCHW float32."""
    n, _, h, wd = x.shape
    f, _, kh, kw = w.shape
    oh, ow = k5.conv_out_hw(h, wd, kh, kw, stride, padding)
    p = k5._patches(x.float(), kh, kw, stride, padding)
    wt = w.float().reshape(f, -1)
    pad = -p.shape[1] % 32
    p, wt = (torch.nn.functional.pad(a, (0, pad)) for a in (p, wt))
    pb, wb = _tf32_rna(p), _tf32_rna(wt)
    ps, ws = _tf32_trunc(p - pb), _tf32_trunc(wt - wb)
    acc = [torch.zeros(p.shape[0], f), torch.zeros(p.shape[0], f)]
    for s in range(p.shape[1] // 32):
        k = slice(32 * s, 32 * s + 32)
        terms = [(ps, wb), (pb, ws), (pb, wb)]
        fr = sum(a[:, k].double() @ b[:, k].double().T for a, b in terms)
        acc[s % 2] = acc[s % 2] + fr.float()
    y = (acc[0] + acc[1]) * scale.float() + shift.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.reshape(n, oh, ow, f).permute(0, 3, 1, 2)


# the stem (K = 147, not a multiple of 4 or 32), a strided 3x3 and a 1x1
K5_EMULATED = [((4, 3, 30, 30), 8, 7, 2, 3, True),
               ((4, 8, 9, 9), 12, 3, 2, 0, True),
               ((4, 64, 7, 7), 32, 1, 1, 0, False)]


@pytest.mark.parametrize("shape,f,k,stride,padding,relu", K5_EMULATED)
def test_k5_arithmetic_emulated(shape, f, k, stride, padding, relu):
    """K5's arithmetic keeps float32 accuracy and its batch
    independence: within 2e-5 of a float64 convolution and of the JAX
    kernel (Pallas, interpret mode), and an image's outputs are bitwise
    the same at batch 4 and alone."""
    arrs = _inputs(7, shape, f, k)
    xt, wt, st, sh = (torch.from_numpy(a) for a in arrs)
    got = _k5_emulated(xt, wt, st, sh, stride, padding, relu)
    exact = torch.nn.functional.conv2d(
        xt.double(), wt.double(), stride=stride, padding=padding) \
        * st.double()[None, :, None, None] + sh.double()[None, :, None, None]
    if relu:
        exact = torch.clamp_min(exact, 0.0)
    np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=0,
                               atol=2e-5)
    want = np.asarray(_jax_fwd(*arrs, stride, padding, relu))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    alone = _k5_emulated(xt[1:2], wt, st, sh, stride, padding, relu)
    assert torch.equal(got[1:2], alone)
