"""The port's flash attention (paddle_tpu_torch/kernels/flash_attention.py)
against the JAX package's Pallas kernels in interpret mode, on the CPU.

On the CPU the routers run the plain versions of K2, K3a and K3b (the
CUDA kernels are held against them on the card by chip_smoke.py). Cases:
causal and not, S = 40 with blocks of 16 (not a multiple of the block),
Sq != Sk both ways, head_dim 16 and 64. Tolerance: 5e-6 absolute on O,
LSE, dQ, dK and dV (float32 at unit-scale inputs; the dense softmax and
the blocked online softmax round differently).

The CUDA backward kernels (K3a, K3b) take their products on the tensor
cores in 3xTF32; test_3xtf32_products_keep_float32_accuracy emulates
that operand split on the CPU and pins why its products keep float32
accuracy. The tensor core's own accumulation is not emulated: chip_smoke.py
reads the kernels against float64 on the card.
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


def _tf32_rna(x):
    """cvt.rna.tf32.f32 on the float32 bit pattern: round to the top 19
    bits, to nearest with ties away from zero."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x):
    """A tensor core reading a float32 as a .tf32 operand: the low 13
    bits are dropped (truncation)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """The backward kernels' product: float32 operands split as big =
    rna(x), small = x - big (truncated as the tensor core reads it);
    a_big b_big + a_big b_small + a_small b_big summed in float32."""
    a, b = a.float(), b.float()
    ab, bb = _tf32_rna(a), _tf32_rna(b)
    as_, bs = _tf32_trunc(a - ab), _tf32_trunc(b - bb)
    return (ab @ bb + (ab @ bs + as_ @ bb)).double()


def _mm_tf32(a, b):
    return (_tf32_rna(a.float()) @ _tf32_rna(b.float())).double()


def _mm_f32(a, b):
    return (a.float() @ b.float()).double()


def _dense_bwd(q, k, v, do, lse, delta, causal, scale, mm):
    """flash_attention_bwd_reference's dense formulas in float64, with
    every product taken by ``mm``."""
    s = mm(q, k.transpose(1, 2)) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        p = p * tfa._causal_keep(q.shape[1], k.shape[1], q.device)
    dv = mm(p.transpose(1, 2), do)
    ds = p * (mm(do, v.transpose(1, 2)) - delta[..., None])
    return mm(ds, k) * scale, mm(ds.transpose(1, 2), q) * scale, dv


@pytest.mark.parametrize("causal", [False, True])
def test_3xtf32_products_keep_float32_accuracy(causal):
    """Why K3a/K3b may run their products on the tensor cores without a
    new tolerance: with the 3xTF32 split, dQ/dK/dV at [2, 512, 64] stay
    within 1e-6 (of max(1, |reference|)) of a float64 reference and
    within 2x of plain float32 products, while one TF32 product per
    multiply is at least 100x worse. Only the products differ: the
    rest of the formulas runs in float64. Not modelled: the tensor
    core's summation, which does not round to nearest; the kernels add
    each streamed tile's sum to their accumulators with float32 adds so
    that it cannot drift over a long sequence."""
    rng = np.random.RandomState(0)
    q, k, v, do = (torch.tensor(rng.randn(2, 512, 64).astype(np.float32))
                   .double() for _ in range(4))
    scale = 64 ** -0.5
    s = torch.matmul(q, k.transpose(1, 2)) * scale
    if causal:
        s = s.masked_fill(~tfa._causal_keep(512, 512, s.device), -1e30)
    lse = torch.logsumexp(s, dim=-1)
    delta = (do * torch.matmul(torch.softmax(s, dim=-1), v)).sum(-1)
    args = (q, k, v, do, lse, delta, causal, scale)
    ref = _dense_bwd(*args, torch.matmul)

    def errs(mm):
        return [float((g - r).abs().max()) for g, r in
                zip(_dense_bwd(*args, mm), ref)]

    split, one, f32 = errs(_mm_3xtf32), errs(_mm_tf32), errs(_mm_f32)
    for name, r, e3, e1, ef in zip(("dQ", "dK", "dV"), ref, split, one,
                                   f32):
        top = max(1.0, float(r.abs().max()))
        assert e3 <= 1e-6 * top, (name, e3, top)
        assert e3 <= 2 * ef, (name, e3, ef)
        assert e1 >= 100 * e3, (name, e1, e3)
