"""K1 on bfloat16 rows in the port (paddle_tpu_torch/kernels/layer_norm.py)
against the JAX package, on the CPU.

The JAX kernel (``_ln_kernel``) widens x, scale and bias to float32 on
load, normalizes in float32 and rounds y once to x's dtype; mean and rstd
stay float32. On the CPU the port's router runs the plain version, which
computes the same function (the CUDA kernel ``layer_norm_bf16`` is held
against it on the card by chip_smoke.py). Here:

  (a) ``fused_layer_norm`` on seeded bfloat16 inputs against the JAX
      ``fused_layer_norm(..., interpret=True)``: y within 1 bfloat16 ulp
      of its largest |value| (both round the same float32 value once; the
      row sums run in other orders), at most 1% of y differing, Mean and
      Variance within 1e-6 relative (+ 1e-6 absolute: float32 sums in
      another order; x has mean ~0.5 and variance ~9); the gradients (the jnp backward, in float32,
      each rounded once to bfloat16) within the same bounds;
  (b) a Fluid program, float32 feed -> ``layers.cast`` to bfloat16 ->
      ``layers.layer_norm`` (bfloat16 Scale and Bias) -> cast back ->
      ``layers.mean``, in both packages, the JAX executor on its Pallas
      route (``use_pallas_kernels=True``) op by op (``jax.disable_jit``:
      a jitted block may drop a float32 -> bfloat16 -> float32 round
      trip): the output within the bounds of (a), the mean within one
      bfloat16 ulp of the output's largest |value|;
  (c) routes: a CPU bfloat16 call counts under ``layer_norm_bf16``, a
      ``meta`` one not at all; the kernel's checks refuse x, scale and
      bias of mixed dtypes.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.fluid.flags import FLAGS as JFLAGS, set_flags
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import layers as tlayers
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.kernels import layer_norm as tln

jln = importlib.import_module("paddle_tpu.fluid.ops.pallas_kernels.layer_norm")

ULPS, SHARE, STAT_TOL = 1.0, 0.01, 1e-6


def _ulps(got, want):
    """(max |got - want| in bfloat16 ulps of max |want|, share of elements
    that differ), compared in float32."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    vmax = float(np.abs(want).max())
    ulp = 2.0 ** (np.floor(np.log2(vmax)) - 7) if vmax else 2.0 ** -133
    return float(np.abs(got - want).max()) / ulp, float((got != want).mean())


def _hold(got, want, what):
    ulps, share = _ulps(got, want)
    assert ulps <= ULPS and share <= SHARE, (what, ulps, share)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _seeded(rng, *shape, scale=1.0):
    """float32 normals rounded to bfloat16: the same values on both
    sides."""
    return np.array(jnp.asarray(
        (rng.randn(*shape) * scale).astype(np.float32),
        jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("shape,begin", [((37, 24), 1), ((3, 5, 40), 2),
                                         ((4, 512), 1)])
def test_a_bf16_layer_norm_matches_pallas_interpret(shape, begin):
    rng = np.random.RandomState(17)
    f = int(np.prod(shape[begin:]))
    x = _seeded(rng, *shape, scale=3.0) + 0.5
    s, b = _seeded(rng, f), _seeded(rng, f)
    dy = _seeded(rng, *shape)

    def jf(x, s, b):
        return jln.fused_layer_norm(x, s, b, eps=1e-5, begin_norm_axis=begin,
                                    block_rows=16, interpret=True)

    jx, js, jb, jdy = (jnp.asarray(a, jnp.bfloat16) for a in (x, s, b, dy))
    (jy, jm, jv), vjp = jax.vjp(jf, jx, js, jb)
    jdx, jds, jdb = vjp((jdy, jnp.zeros_like(jm), jnp.zeros_like(jv)))

    tx, ts, tb = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
                  for a in (x, s, b))
    before = dict(tln.counts.plain_calls)
    ty, tm, tv = tln.fused_layer_norm(tx, ts, tb, eps=1e-5,
                                      begin_norm_axis=begin)
    assert tln.counts.plain_calls == {**before, tln.KERNEL_BF16:
                                      before[tln.KERNEL_BF16] + 1}
    assert ty.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    assert tm.dtype == tv.dtype == torch.float32
    _hold(_f32(ty), _f32(jy), "y")
    for got, want in ((tm, jm), (tv, jv)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=STAT_TOL,
                                   atol=STAT_TOL)
    tdx, tds, tdb = torch.autograd.grad(
        ty, (tx, ts, tb), torch.from_numpy(dy).to(torch.bfloat16))
    for what, got, want in (("dx", tdx, jdx), ("dscale", tds, jds),
                            ("dbias", tdb, jdb)):
        assert got.dtype == torch.bfloat16
        _hold(_f32(got), _f32(want), what)


def _program(pkg, seq, d):
    fluid, layers, unique_name = pkg
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data(name="x", shape=[seq, d], dtype="float32")
        y = layers.layer_norm(layers.cast(x, "bfloat16"), begin_norm_axis=2)
        out = layers.cast(y, "float32")
        loss = layers.mean(out)
    return main, startup, out, loss, y


@pytest.fixture
def jax_pallas():
    saved = {"use_pallas_kernels": JFLAGS["use_pallas_kernels"]}
    set_flags({"use_pallas_kernels": True})
    yield
    set_flags(saved)


def test_b_cast_layer_norm_program_matches_jax(jax_pallas):
    """Batch 3, seq 7, d 48: both programs build the same ops and bfloat16
    parameters (Scale 1, Bias 0 from their startup programs), and compute
    the same output and mean."""
    seq, d = 7, 48
    feed = {"x": (np.random.RandomState(5).randn(3, seq, d) * 2
                  + 1).astype(np.float32)}
    out = {}
    for side, pkg, exe in (
            ("jax", (jfluid, jlayers, junique),
             jfluid.Executor(jfluid.CPUPlace())),
            ("torch", (tfluid, tlayers, tunique), tfluid.Executor("cpu"))):
        main, startup, o, loss, y = _program(pkg, seq, d)
        assert y.dtype == "bfloat16"
        assert [p.dtype for p in main.global_block().all_parameters()] == \
            ["bfloat16", "bfloat16"]
        scope = (jfluid if side == "jax" else tfluid).Scope()
        exe.run(startup, scope=scope)
        before = dict(tln.counts.plain_calls)
        with jax.disable_jit():
            got = exe.run(main, feed=feed, fetch_list=[o, loss],
                          scope=scope)
        if side == "torch":
            assert tln.counts.plain_calls[tln.KERNEL_BF16] == \
                before[tln.KERNEL_BF16] + 1
        out[side] = ([op.type for op in main.global_block().ops],
                     np.asarray(got[0], np.float32),
                     float(np.asarray(got[1]).reshape(-1)[0]))
    (jops, jo, jl), (tops, to, tl) = out["jax"], out["torch"]
    assert jops == tops == ["cast", "layer_norm", "cast", "mean"]
    assert to.shape == jo.shape == (3, seq, d)
    _hold(to, jo, "program output")
    ulp = 2.0 ** (np.floor(np.log2(np.abs(jo).max())) - 7)
    assert abs(tl - jl) <= ulp, (tl, jl)


def test_c_routes_count_bf16_apart_and_checks_refuse_mixed_dtypes():
    x = torch.empty(6, 8, device="meta", dtype=torch.bfloat16)
    s = torch.empty(8, device="meta", dtype=torch.bfloat16)
    before = dict(tln.counts.plain_calls)
    y, m, r = tln.layer_norm_fwd(x, s, s, 1e-5)
    assert (y.dtype, m.dtype, r.dtype) == (torch.bfloat16, torch.float32,
                                           torch.float32)
    assert tln.counts.plain_calls == before
    cpu = torch.ones(4, 8, dtype=torch.bfloat16)
    tln.layer_norm_fwd(cpu, cpu[0], cpu[0], 1e-5)
    assert tln.counts.plain_calls == {**before, tln.KERNEL_BF16:
                                      before[tln.KERNEL_BF16] + 1}
    assert tln.counts.names == (tln.KERNEL, tln.KERNEL_BF16)
    with pytest.raises(TypeError, match="one dtype"):
        tln._layer_norm_cuda(x, s.float(), s, 1e-5)
    with pytest.raises(TypeError, match="one dtype"):
        tln._layer_norm_cuda(x.float(), s.float(), s, 1e-5)
