"""The port's layer norm (paddle_tpu_torch/kernels/layer_norm.py) against
the JAX package's Pallas kernel in interpret mode, on the CPU.

On the CPU the router runs the plain version of K1 (the CUDA kernel is
held against it on the card by chip_smoke.py). Tolerance: 2e-6 absolute
plus 1e-5 relative on Y, Mean, Variance and on dx, dscale, dbias
(float32 at unit-scale inputs; the two sides sum rows in another order,
and dscale/dbias are sums over up to 37 rows of magnitude ~10).
"""
import importlib

import jax
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import layer_norm as tln

jln = importlib.import_module("paddle_tpu.fluid.ops.pallas_kernels.layer_norm")

ATOL, RTOL = 2e-6, 1e-5


def _case(rng, shape, begin):
    f = int(np.prod(shape[begin:]))
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(f).astype(np.float32), rng.randn(f).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


@pytest.mark.parametrize("shape,begin", [((37, 24), 1), ((3, 5, 40), 2)])
def test_layer_norm_matches_pallas_interpret(shape, begin):
    rng = np.random.RandomState(7)
    x, s, b, dy = _case(rng, shape, begin)

    def jf(x, s, b):
        return jln.fused_layer_norm(x, s, b, eps=1e-5, begin_norm_axis=begin,
                                    block_rows=16, interpret=True)

    (jy, jm, jv), vjp = jax.vjp(jf, x, s, b)
    jdx, jds, jdb = vjp((dy, np.zeros_like(jm), np.zeros_like(jv)))

    tx, ts, tb = (torch.tensor(a, requires_grad=True) for a in (x, s, b))
    before = tln.counts.plain_calls[tln.KERNEL]
    ty, tm, tv = tln.fused_layer_norm(tx, ts, tb, eps=1e-5,
                                      begin_norm_axis=begin)
    assert tln.counts.plain_calls[tln.KERNEL] == before + 1
    tdx, tds, tdb = torch.autograd.grad(ty, (tx, ts, tb), torch.tensor(dy))
    for want, got in ((jy, ty), (jm, tm), (jv, tv), (jdx, tdx), (jds, tds),
                      (jdb, tdb)):
        got = got.detach().numpy()
        assert got.shape == np.asarray(want).shape
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL,
                                   atol=ATOL)


def test_router_meta_is_uncounted_and_other_devices_raise():
    x = torch.empty(6, 8, device="meta")
    s = torch.empty(8, device="meta")
    before = dict(tln.counts.plain_calls)
    y, m, r = tln.layer_norm_fwd(x, s, s, 1e-5)
    assert (y.shape, m.shape, r.shape) == ((6, 8), (6,), (6,))
    assert tln.counts.plain_calls == before
    # the kernel takes float32 and bfloat16 rows; float16 is refused
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tln._layer_norm_cuda(x.half(), s.half(), s.half(), 1e-5)
