"""Which function the port computes on bfloat16 inputs, pinned against the
JAX package's ops at their default flags, on the CPU.

The port's ``ring_attention``, ``layer_norm`` and ``conv2d_bn_relu``
compute the JAX package's kernel branch (the Pallas kernels' function),
whatever the sequence length or backend. The JAX ops at their default
flags route elsewhere: ``use_pallas_kernels='auto'`` means the Pallas
kernels on a TPU only, and attention takes its kernel only from
``flash_min_seq`` = 3072 keys on (``paddle_tpu/fluid/flags.py``), both
measured on a TPU v5e; on the CPU, and on a TPU below 3072, they take
their dense/jnp/XLA branches, another function on bfloat16:

  (a) ``ring_attention``: the dense route (``ring_attention_shard``)
      keeps P in float32 for P V; the port rounds P to bfloat16 against
      the running max of each 128-key block;
  (b) ``layer_norm``: the jnp route computes in bfloat16 and returns
      bfloat16 Y, Mean and Variance; the port normalizes in float32,
      rounds Y once, and returns float32 Mean and Variance;
  (c) ``conv2d_bn_relu`` under FLAGS['amp']: the XLA route rounds the
      convolution to bfloat16 before the float32 affine and relu; the
      port applies them to the float32 accumulator and rounds once;
  (d) a bfloat16 fetch: the JAX executor returns a bfloat16 array, the
      port its exact float32 widening (numpy has no bfloat16 without
      ``ml_dtypes``, which the card's machine does not list).

Each gap is held by two bounds, chosen from the values observed here
(written beside each):
  (i)  how far the outputs are apart: the largest difference in bfloat16
       ulps of the JAX output's largest |value| (ulp = 2^(floor(log2
       max) - 7)) and the share of elements that differ at all, from
       below too: a share that fell near 0 would mean the port had moved
       to the default route, a decision these tests pin;
  (ii) accuracy: the port's RMS error against a float64 evaluation of
       the same formula on the same (bfloat16-valued) inputs, at most a
       stated multiple of the JAX default route's RMS error against that
       same float64 value. The port's branch is no less accurate than
       that multiple; on layer norm it is more accurate.
The JAX ops run op by op under ``jax.disable_jit()`` (a jitted block may
drop a float32 -> bfloat16 -> float32 round trip); their flags are set
and restored only by the fixtures.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.fluid.flags import FLAGS as JFLAGS, set_flags as jset_flags
from paddle_tpu.fluid.registry import get_op_info as jax_op_info
from paddle_tpu.observability import metrics as jmetrics
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.flags import FLAGS as TFLAGS
from paddle_tpu_torch.fluid import layers as tlayers
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.fluid.registry import EmitCtx, run_forward

# the JAX package's defaults (paddle_tpu/fluid/flags.py), set by the
# fixtures in case an earlier test in the process left them otherwise
JAX_DEFAULTS = {"use_pallas_kernels": "auto", "flash_min_seq": 3072,
                "amp": False}


@pytest.fixture
def jax_defaults():
    saved = {k: JFLAGS[k] for k in JAX_DEFAULTS}
    jset_flags(JAX_DEFAULTS)
    yield
    jset_flags(saved)


@pytest.fixture
def amp(jax_defaults):
    """FLAGS['amp'] on in both packages, every other JAX flag at its
    default; both restored after."""
    jset_flags({"amp": True})
    saved = TFLAGS["amp"]
    TFLAGS["amp"] = True
    yield
    TFLAGS["amp"] = saved


def _bf16_values(x):
    """float32 numpy rounded to bfloat16 and widened: the same values on
    both sides."""
    return torch.from_numpy(np.array(x, np.float32)).bfloat16().float() \
        .numpy()


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _gap(port, jax_out):
    """(max |port - jax| in bfloat16 ulps of max |jax|, share of elements
    that differ)."""
    vmax = float(np.abs(jax_out).max())
    ulp = 2.0 ** (np.floor(np.log2(vmax)) - 7)
    return (float(np.abs(port - jax_out).max()) / ulp,
            float((port != jax_out).mean()))


def _rms(got, ref):
    return float(np.sqrt(np.mean((got.astype(np.float64) - ref) ** 2)))


def _hold(port, jax_out, ref, ulps, share, rms_ratio):
    """Bounds (i) and (ii): ulps and share are (at most, and for share
    (at least, at most)) the gap's; rms_ratio the most the port's RMS
    error against ``ref`` may be, in multiples of the JAX route's."""
    got_ulps, got_share = _gap(port, jax_out)
    ratio = _rms(port, ref) / _rms(jax_out, ref)
    assert got_ulps <= ulps, (got_ulps, ulps)
    assert share[0] <= got_share <= share[1], (got_share, share)
    assert ratio <= rms_ratio, (ratio, rms_ratio)


def _ctx():
    return EmitCtx(device="cpu", root_seed=1)


# --- (a) ring_attention --------------------------------------------------

# (B, S, H, head_dim, causal)
ATTENTION = [(2, 256, 4, 64, False), (2, 256, 4, 64, True),
             (2, 512, 8, 64, False), (2, 512, 8, 64, True)]


def _attention_float64(q, k, v, causal):
    """Dense softmax attention in float64 on [B, S, H, D] inputs."""
    q, k, v = (torch.from_numpy(x.astype(np.float64)).permute(0, 2, 1, 3)
               for x in (q, k, v))
    s = torch.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool).tril()
        s = s.masked_fill(~keep, -np.inf)
    return torch.matmul(torch.softmax(s, -1), v).permute(0, 2, 1, 3).numpy()


@pytest.mark.parametrize("case", ATTENTION,
                         ids=lambda c: "b{}s{}h{}d{}c{:d}".format(*c))
def test_a_ring_attention_bf16_against_the_jax_default_route(case,
                                                             jax_defaults):
    """Observed, the four cases in order: gap 1.0 / 1.0 / 0.5 / 0.5 ulps,
    38.5% / 37.4% / 39.6% / 38.3% of O differing; RMS error against
    float64 1.31x / 1.23x / 1.33x / 1.24x the dense route's (P rounded
    to bfloat16; largest errors 1.09x / 1.07x / 1.11x / 1.00x). Bounds:
    1.5 ulps, 25%-45% differing, 1.5x."""
    b, s, h, d, causal = case
    rng = np.random.RandomState(b * 1000 + s + h + d + causal)
    q, k, v = (_bf16_values(rng.randn(b, s, h, d)) for _ in range(3))
    attrs = {"causal": causal, "scale": 0.0}
    dense = jmetrics.counter("attention.route.dense")
    flash = jmetrics.counter("attention.route.flash")
    before = dense.value(), flash.value()
    with jax.disable_jit():
        jo = jax_op_info("ring_attention").forward(
            None, {n: [jnp.asarray(x, jnp.bfloat16)]
                   for n, x in zip("QKV", (q, k, v))}, attrs)
    # the JAX op took its dense route: the route the defaults choose
    assert (dense.value(), flash.value()) == (before[0] + 1, before[1])
    to = run_forward(_ctx(), "ring_attention",
                     {n: [torch.from_numpy(x).bfloat16()]
                      for n, x in zip("QKV", (q, k, v))}, attrs)["Out"][0]
    assert to.dtype == torch.bfloat16 and jo.dtype == jnp.bfloat16
    _hold(_f32(to), _f32(jo), _attention_float64(q, k, v, causal),
          ulps=1.5, share=(0.25, 0.45), rms_ratio=1.5)


# --- (b) layer_norm -------------------------------------------------------

LAYER_NORM = [(256, 512), (64, 512)]


@pytest.mark.parametrize("rows,cols", LAYER_NORM)
def test_b_layer_norm_bf16_against_the_jax_default_route(rows, cols,
                                                         jax_defaults):
    """Observed, [256, 512] then [64, 512]: gap 1.0 / 1.5 ulps of Y's max,
    34.6% / 34.3% of Y differing; Y's RMS error against float64 0.56x /
    0.54x the jnp route's, Mean's and Variance's below 5e-5x (float32
    against bfloat16 statistics). Bounds: 2 ulps, 20%-45% differing, Y
    0.75x, the statistics 1e-3x."""
    rng = np.random.RandomState(rows + cols)
    x = _bf16_values(rng.randn(rows, cols) * 3.0 + 0.5)
    scale, bias = _bf16_values(rng.randn(cols)), _bf16_values(rng.randn(cols))
    attrs = {"epsilon": 1e-5, "begin_norm_axis": 1}
    with jax.disable_jit():
        jr = jax_op_info("layer_norm").forward(
            None, {"X": [jnp.asarray(x, jnp.bfloat16)],
                   "Scale": [jnp.asarray(scale, jnp.bfloat16)],
                   "Bias": [jnp.asarray(bias, jnp.bfloat16)]}, attrs)
    tr = run_forward(_ctx(), "layer_norm",
                     {"X": [torch.from_numpy(x).bfloat16()],
                      "Scale": [torch.from_numpy(scale).bfloat16()],
                      "Bias": [torch.from_numpy(bias).bfloat16()]}, attrs)
    # the jnp route returns bfloat16 statistics (the kernel's are float32)
    assert jr["Y"].dtype == jr["Mean"].dtype == jr["Variance"].dtype \
        == jnp.bfloat16
    assert tr["Y"][0].dtype == torch.bfloat16
    assert tr["Mean"][0].dtype == tr["Variance"][0].dtype == torch.float32
    x64 = x.astype(np.float64)
    mean = x64.mean(1)
    var = ((x64 - mean[:, None]) ** 2).mean(1)
    y = (x64 - mean[:, None]) / np.sqrt(var[:, None] + 1e-5) * scale + bias
    _hold(_f32(tr["Y"][0]), _f32(jr["Y"]), y, ulps=2.0, share=(0.2, 0.45),
          rms_ratio=0.75)
    for slot, ref in (("Mean", mean), ("Variance", var)):
        ratio = _rms(_f32(tr[slot][0]), ref) / _rms(_f32(jr[slot]), ref)
        assert ratio <= 1e-3, (slot, ratio)


# --- (c) conv2d_bn_relu under amp --------------------------------------------

# N, C, H, F, k, stride, padding: ResNet-50's res2 3x3 (64 -> 64) and 1x1
# reduce (256 -> 64), and its stem (3 -> 64, 7x7 stride 2), spatial cut
FUSED = [(2, 64, 14, 64, 3, 1, 1), (2, 256, 7, 64, 1, 1, 0),
         (1, 3, 32, 64, 7, 2, 3)]


@pytest.mark.parametrize("case", FUSED,
                         ids=lambda c: "n{}c{}h{}f{}k{}s{}p{}".format(*c))
def test_c_conv2d_bn_relu_amp_against_the_jax_default_route(case, amp):
    """Observed, the three cases in order: gap 0.72 / 0.49 / 0.55 ulps of
    the output's max, 50.8% / 50.2% / 49.8% differing; RMS error against
    float64 1.04x / 0.99x / 1.01x the XLA route's (one rounding each, of
    the accumulator or of the output). Bounds: 1 ulp, 35%-60%
    differing, 1.25x."""
    n, c, h, f, k, s, p = case
    rng = np.random.RandomState(n * 100 + c + f)
    ins = {"X": rng.randn(n, c, h, h).astype(np.float32),
           "Filter": (rng.randn(f, c, k, k) / np.sqrt(c * k * k))
           .astype(np.float32),
           "Scale": (rng.rand(f) + 0.5).astype(np.float32),
           "Shift": (rng.randn(f) * 0.1).astype(np.float32)}
    attrs = {"stride": s, "padding": p, "relu": True}
    with jax.disable_jit():
        jo = np.asarray(jax_op_info("conv2d_bn_relu").forward(
            None, {slot: [jnp.asarray(v)] for slot, v in ins.items()},
            attrs)["Out"])
    to = run_forward(_ctx(), "conv2d_bn_relu",
                     {slot: [torch.from_numpy(v)] for slot, v in ins.items()},
                     attrs)["Out"][0].numpy()
    assert jo.dtype == to.dtype == np.float32
    # the port rounds its output once (bfloat16 values); the XLA route
    # applies the affine after its rounding, so its values are not
    assert np.array_equal(to, _bf16_values(to))
    assert not np.array_equal(jo, _bf16_values(jo))
    conv = F.conv2d(*(torch.from_numpy(_bf16_values(ins[n]).astype(
        np.float64)) for n in ("X", "Filter")), stride=s, padding=p).numpy()
    ref = np.maximum(conv * ins["Scale"].astype(np.float64)[:, None, None]
                     + ins["Shift"].astype(np.float64)[:, None, None], 0.0)
    _hold(to, jo, ref, ulps=1.0, share=(0.35, 0.6), rms_ratio=1.25)


# --- (d) the bfloat16 fetch ---------------------------------------------------

def test_d_bf16_fetch_is_float32_in_the_port_bf16_in_jax(jax_defaults):
    """One cast program, float32 feed -> cast to bfloat16, fetched in both
    packages: the JAX executor returns a bfloat16 array, the port float32
    numpy of the same values (the decided difference: only the dtype)."""
    fetched = []
    for fluid, layers, unique_name in ((jfluid, jlayers, junique),
                                       (tfluid, tlayers, tunique)):
        main, startup = fluid.Program(), fluid.Program()
        with unique_name.guard(), fluid.program_guard(main, startup):
            x = layers.data(name="x", shape=[6], dtype="float32")
            y = layers.cast(x, "bfloat16")
        xv = np.random.RandomState(3).randn(4, 6).astype(np.float32)
        exe = fluid.Executor(fluid.CPUPlace())
        with jax.disable_jit():
            (got,) = exe.run(main, feed={"x": xv}, fetch_list=[y],
                             scope=fluid.Scope())
        fetched.append(got)
    jy, ty = fetched
    assert jy.dtype == jnp.bfloat16 and ty.dtype == np.float32
    np.testing.assert_array_equal(ty, np.asarray(jy).astype(np.float32))
    np.testing.assert_array_equal(ty, _bf16_values(
        np.random.RandomState(3).randn(4, 6)))
