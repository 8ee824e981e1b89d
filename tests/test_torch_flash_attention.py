"""The port's flash attention (paddle_tpu_torch/kernels/flash_attention.py)
against the JAX package's Pallas kernels in interpret mode, on the CPU.

On the CPU the routers run the plain versions of K2, K3a and K3b (the
CUDA kernels are held against them on the card by chip_smoke.py). Cases:
causal and not, S = 40 with blocks of 16 (not a multiple of the block),
Sq != Sk both ways, head_dim 16 and 64. Tolerance: 5e-6 absolute on O,
LSE, dQ, dK and dV (float32 at unit-scale inputs; the dense softmax and
the blocked online softmax round differently).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as tfa

jfa = importlib.import_module(
    "paddle_tpu.fluid.ops.pallas_kernels.flash_attention")

TOL = 5e-6
CASES = [(40, 40, 16), (40, 40, 64), (40, 24, 16), (24, 40, 64)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk,d", CASES)
def test_flash_matches_pallas_interpret(sq, sk, d, causal):
    rng = np.random.RandomState(sq * 100 + sk + d)
    b, h = 2, 3
    q = rng.randn(b, sq, h, d).astype(np.float32)
    k = rng.randn(b, sk, h, d).astype(np.float32)
    v = rng.randn(b, sk, h, d).astype(np.float32)
    do = rng.randn(b, sq, h, d).astype(np.float32)

    def jf(q, k, v):
        return jfa.flash_attention(q, k, v, causal=causal, block_q=16,
                                   block_k=16, interpret=True)

    jo, vjp = jax.vjp(jf, q, k, v)
    jdq, jdk, jdv = vjp(do)
    # the LSE the TPU forward kernel saves for its backward
    scale = d ** -0.5

    def bhsd(x, s):
        return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, s, d)

    _, jlse = jfa._fwd_pallas(bhsd(q, sq), bhsd(k, sk), bhsd(v, sk), scale,
                              causal, 16, 16, True, None)

    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    before = dict(tfa.counts.plain_calls)
    to = tfa.flash_attention(tq, tk, tv, causal=causal)
    tdq, tdk, tdv = torch.autograd.grad(to, (tq, tk, tv), torch.tensor(do))
    assert tfa.counts.plain_calls == {n: before[n] + 1 for n in before}
    _, tlse = tfa.flash_attention_fwd(
        *(torch.tensor(np.asarray(bhsd(x, s))) for x, s in
          ((q, sq), (k, sk), (v, sk))), causal, scale)
    for want, got in ((jo, to), (jlse, tlse), (jdq, tdq), (jdk, tdk),
                      (jdv, tdv)):
        got = got.detach().numpy()
        assert got.shape == np.asarray(want).shape
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL)


def test_routers_on_meta_and_kernel_refusals():
    q = torch.empty(4, 40, 16, device="meta")
    k = torch.empty(4, 24, 16, device="meta")
    before = dict(tfa.counts.plain_calls)
    o, lse = tfa.flash_attention_fwd(q, k, k, True, 0.25)
    assert (o.shape, lse.shape) == ((4, 40, 16), (4, 40))
    dq, dk, dv = tfa.flash_attention_bwd(q, k, k, q, lse, lse, True, 0.25)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, k.shape)
    assert tfa.counts.plain_calls == before
    with pytest.raises(TypeError, match="float32"):
        tfa._fwd_cuda(q.to(torch.bfloat16), k, k, False, 0.25)
    wide = torch.empty(4, 40, 132, device="meta")
    with pytest.raises(ValueError, match="head_dim"):
        tfa._fwd_cuda(wide, wide, wide, False, 0.25)
