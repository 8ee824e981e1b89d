"""The port's flash attention (paddle_tpu_torch/kernels/flash_attention.py)
against the JAX package's Pallas kernels in interpret mode, on the CPU.

On the CPU the routers run the plain versions of K2, K3a and K3b (the
CUDA kernels are held against them on the card by chip_smoke.py). Cases:
causal and not, S = 40 with blocks of 16 (not a multiple of the block),
Sq != Sk both ways, head_dim 16, 64, 18 (not a multiple of 4: the card
zero-pads it to 20, test_head_dim_padding_is_exact), 256 (the largest
bucket, CUDA-core kernels on the card) and 264 (above 256: the card's
CUDA-core kernels compute it in 256-column slices). Tolerance: 5e-6 absolute on O,
LSE, dQ, dK and dV (float32 at unit-scale inputs; the dense softmax and
the blocked online softmax round differently).

The CUDA kernels (K2, K3a, K3b) take their products on the tensor
cores in 3xTF32; test_3xtf32_products_keep_float32_accuracy emulates
that operand split on the CPU and pins why its products keep float32
accuracy, and test_k2_algorithm_emulated runs K2's whole algorithm (key
tiles of 64, split products, exp2-domain online softmax, each tile's
P V merged by O = O alpha + O_tile) against float64 and the JAX kernel.
The tensor core's own accumulation is not emulated: chip_smoke.py
reads the kernels against float64 on the card.
"""
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as tfa

jfa = importlib.import_module(
    "paddle_tpu.fluid.ops.pallas_kernels.flash_attention")

TOL = 5e-6
CASES = [(40, 40, 16), (40, 40, 64), (40, 24, 16), (24, 40, 64),
         (40, 40, 18), (40, 24, 256), (24, 40, 264)]


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
    # every head_dim passes the kernels' checks (132 and 18 included, and
    # 264 and 512 above 256, which the card computes in column slices);
    # the meta and CPU routes take head_dim 264
    for d in (132, 18, 256, 264, 512):
        wide = torch.empty(4, 40, d, device="meta")
        assert tfa._check_cuda(q=wide, k=wide, v=wide) == wide.device
    wide = torch.empty(4, 40, 264, device="meta")
    o, lse = tfa.flash_attention_fwd(wide, wide, wide, False, 0.25)
    assert (o.shape, lse.shape) == ((4, 40, 264), (4, 40))
    assert tfa.counts.plain_calls == before
    cpu = torch.ones(2, 5, 264)
    o, lse = tfa.flash_attention_fwd(cpu, cpu, cpu, True, 0.25)
    assert o.shape == (2, 5, 264) and torch.equal(o, cpu)
    assert tfa.counts.plain_calls[tfa.FWD] == before[tfa.FWD] + 1


@pytest.mark.parametrize("d", [18, 1, 131])
def test_head_dim_padding_is_exact(d):
    """The wrapper zero-pads a head_dim that is not a multiple of 4 before
    launching the kernels and slices the outputs back, the scale from the
    true head_dim: the zero columns add exact zeros to q.k, dO.v and
    delta, so the plain forward and backward on the padded inputs give
    the unpadded ones' values (to the float32 rounding of the products)."""
    rng = np.random.RandomState(d)
    q, k, v, do = (torch.tensor(rng.randn(3, 20, d).astype(np.float32))
                   for _ in range(4))
    scale = d ** -0.5
    qp, kp, vp, dop = tfa.pad_head_dim(q, k, v, do)
    assert qp.shape[-1] % 4 == 0 and qp.shape[-1] - d < 4
    assert torch.equal(qp[..., :d], q) and not qp[..., d:].any()
    o, lse = tfa.flash_attention_fwd_reference(q, k, v, True, scale)
    op, lsep = tfa.flash_attention_fwd_reference(qp, kp, vp, True, scale)
    delta = (do * o).sum(-1)
    deltap = (dop * op).sum(-1)
    np.testing.assert_allclose(delta.numpy(), deltap.numpy(), atol=1e-6)
    grads = tfa.flash_attention_bwd_reference(q, k, v, do, lse, delta, True,
                                              scale)
    gradsp = tfa.flash_attention_bwd_reference(qp, kp, vp, dop, lsep,
                                               deltap, True, scale)
    for want, got in zip((o, lse) + grads,
                         tfa._unpad(d, op) + (lsep,) + tfa._unpad(d, *gradsp)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-6)


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


def _mm3_f32(a, b):
    """K2's product in float32: operands split as the kernels split
    them, the three products (small terms first) summed in float32."""
    a, b = a.float(), b.float()
    ab, bb = _tf32_rna(a), _tf32_rna(b)
    as_, bs = _tf32_trunc(a - ab), _tf32_trunc(b - bb)
    return (as_ @ bb + ab @ bs) + ab @ bb


def _k2_emulated(q, k, v, causal, scale, tile=64):
    """K2's algorithm on the CPU in float32: key tiles of ``tile``,
    3xTF32 products, the running max m in units of s * scale * log2(e),
    p = 2^(s c - m), masked scores -inf (p = 0), each tile's P V in fresh
    fragments merged as O = O alpha + O_tile, lse = (m + log2 l) ln 2.
    Returns (O, LSE)."""
    bh, sq, d = q.shape
    c = torch.tensor(scale, dtype=torch.float32) * torch.tensor(
        math.log2(math.e), dtype=torch.float32)
    m = torch.full((bh, sq, 1), -1e30)
    l = torch.zeros((bh, sq, 1))
    acc = torch.zeros((bh, sq, d))
    for t0 in range(0, k.shape[1], tile):
        kt, vt = k[:, t0:t0 + tile], v[:, t0:t0 + tile]
        s = _mm3_f32(q, kt.transpose(1, 2))
        if causal:
            kpos = torch.arange(t0, t0 + kt.shape[1])[None, :]
            s = s.masked_fill(kpos > torch.arange(sq)[:, None], -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * c)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * c - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _mm3_f32(p, vt)
        m = m_new
    den = l.clamp(min=torch.finfo(torch.float32).tiny)
    return acc / den, ((m + torch.log2(den)) * math.log(2.0))[..., 0]


@pytest.mark.parametrize("causal", [False, True])
def test_k2_algorithm_emulated(causal):
    """K2's arithmetic at [2, 512, 64] keeps float32 accuracy: O and LSE
    err against float64 at most 4x the plain float32 version's error
    (and under 1e-5), and agree with the JAX _fwd_kernel (Pallas,
    interpret mode, 64-row blocks) within 5e-6."""
    rng = np.random.RandomState(5 + causal)
    q, k, v = (torch.tensor(rng.randn(2, 512, 64).astype(np.float32))
               for _ in range(3))
    scale = 64 ** -0.5
    s = torch.matmul(q.double(), k.double().transpose(1, 2)) * scale
    if causal:
        s = s.masked_fill(~tfa._causal_keep(512, 512, s.device), -math.inf)
    lse64 = torch.logsumexp(s, dim=-1)
    o64 = torch.matmul(torch.exp(s - lse64[..., None]), v.double())
    emu = _k2_emulated(q, k, v, causal, scale)
    plain = tfa.flash_attention_fwd_reference(q, k, v, causal, scale)
    jo, jlse = jfa._fwd_pallas(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                               scale, causal, 64, 64, True, None)
    for name, got, ref, pl_, jx in (("O", emu[0], o64, plain[0], jo),
                                    ("LSE", emu[1], lse64, plain[1], jlse)):
        e_emu = float((got.double() - ref).abs().max())
        e_plain = float((pl_.double() - ref).abs().max())
        assert e_emu <= 4 * e_plain and e_emu < 1e-5, (name, e_emu, e_plain)
        np.testing.assert_allclose(got.numpy(), np.asarray(jx), rtol=0,
                                   atol=5e-6, err_msg=name)
