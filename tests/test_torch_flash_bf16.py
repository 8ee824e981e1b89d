"""bfloat16 flash attention in the port against the JAX package, on the
CPU, at a small size.

With bfloat16 Q/K/V the TPU kernels take their bfloat16 branch
(``lowp`` in ``paddle_tpu/fluid/ops/pallas_kernels/flash_attention.py``):
bfloat16 operands into the products with float32 sums, P rounded to
bfloat16 before P V and dV, dS rounded before dK and dQ, an online
softmax whose running max moves at 128-key boundaries (the block_k that
``layers.ring_attention`` runs), O, dQ, dK and dV rounded once to
bfloat16, LSE float32. The port's plain versions compute that function
on bfloat16 inputs (the CUDA kernels are held against them on the card
by chip_smoke.py). Here:

  (a) the plain forward and backward against ``_fwd_pallas`` /
      ``_flash_bwd`` in interpret mode (blocks of 128): full and causal,
      Sq != Sk both ways, Sk = 200 (a padded second key block), head_dim
      8, 64, 72, 256, 264 and 512; and the float32 plain path bit for bit
      the dense formulas it was before; the wgmma kernels above head_dim
      128 (``csrc/flash_wide_wgmma.cuh``: K2, K3a, K3b) emulated in
      float32 in their order of sums, within 1 ulp of the plain version;
  (b) ``flash_attention``'s autograd at bfloat16 against ``jax.vjp`` of
      the JAX ``flash_attention(..., interpret=True)``;
  (c) the ``cast`` op and its gradient (``astype``'s VJP);
  (d) Transformer-base's self-attention layer at a small width (2 heads,
      S = 64, head_dim 32): three ``fc`` projections, ``cast`` to
      bfloat16, causal ``ring_attention``, ``cast`` back, the output
      ``fc``, a squared-error loss, 3 Momentum steps against the JAX
      executor on its Pallas route (``use_pallas_kernels=True,
      flash_min_seq=0``) run op by op (``jax.disable_jit``: a jitted
      block may drop the float32 -> bfloat16 -> float32 round trips);
      the step-1 parameter gradients; the bfloat16 fetch;
  (e) the meta and CPU routes count the bfloat16 kernels under their own
      names (``counts_bf16``), the kernels' checks take bfloat16.

Tolerances, in bfloat16 ulps of the largest |value| of the tensor
compared (ulp = 2^(floor(log2 max) - 7)): both sides round the same
float32 values to bfloat16, and their float32 sums run in other orders,
so an element may land one bfloat16 step apart where its float32 value
lies near a rounding boundary: at most 1.5 ulps of the max and at most 1%
of the elements differing at all (observed: at most 0.5 ulps and 0.59%);
at head_dim 512 at most 2% (``SHARE_512``: dS is rounded after a
512-long dot, observed 0.83-1.21%).
LSE is float32: within 2e-6. The causal cases keep Sq >= 128: row 0 of
a causal dQ is 0 in exact arithmetic (one visible key, dP = delta), and
both sides return the float32 residue of dP - delta (~1e-7), which
differs between them: it is one row in Sq of the differing elements.
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
from paddle_tpu.fluid.registry import get_op_info as jax_op_info
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import layers as tlayers
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.fluid.registry import (
    FWD_META_ATTR, EmitCtx, forward_with_grad, run_grad)
from paddle_tpu_torch.kernels import flash_attention as tfa

jfa = importlib.import_module(
    "paddle_tpu.fluid.ops.pallas_kernels.flash_attention")

ULPS, SHARE, LSE_TOL, LOSS_RTOL = 1.5, 0.01, 2e-6, 1e-5
# at head_dim 512 the plain version and the Pallas kernel round more
# elements apart: dS = p (dP - delta) is rounded to bfloat16 after a
# 512-long float32 dot summed in another order, and each dS that lands on
# the other side of a rounding boundary moves a row of dK (and dQ). Over
# four seeds of the two 512 CASES: 0.83-1.21% of dK (full) and 0.85-1.06%
# of dQ (causal) differ, every one by at most 0.5 ulp of the max
SHARE_512 = 0.02
JAX = (jfluid, jlayers, junique)
PORT = (tfluid, tlayers, tunique)
# (Sq, Sk, head_dim, causal)
CASES = [(256, 256, 64, False), (256, 256, 64, True), (160, 200, 72, True),
         (200, 160, 8, False), (136, 200, 8, True), (130, 200, 264, True),
         (200, 130, 264, False), (130, 200, 256, True), (200, 130, 256, False),
         (130, 200, 512, True), (200, 130, 512, False)]


def _ulps(got, want):
    """(max |got - want| in bfloat16 ulps of max |want|, share of elements
    that differ), both compared in float32."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    vmax = float(np.abs(want).max())
    ulp = 2.0 ** (np.floor(np.log2(vmax)) - 7) if vmax else 2.0 ** -133
    return float(np.abs(got - want).max()) / ulp, float((got != want).mean())


def _hold(got, want, what, max_share=SHARE):
    ulps, share = _ulps(got, want)
    assert ulps <= ULPS and share <= max_share, (what, ulps, share)


def _seeded(rng, *shape):
    """float32 normals rounded to bfloat16: the same values on both sides."""
    return np.array(jnp.asarray(rng.randn(*shape).astype(np.float32),
                                jnp.bfloat16).astype(jnp.float32))


def _to_bf16(x):
    return torch.from_numpy(np.array(x, np.float32)).to(torch.bfloat16)


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.detach().float().numpy()


# --- (a) the plain versions against the TPU kernels -------------------

@pytest.mark.parametrize("sq,sk,d,causal", CASES)
def test_a_plain_bf16_matches_pallas_interpret(sq, sk, d, causal):
    rng = np.random.RandomState(sq * 1000 + sk + d)
    bh = 3
    q, k, v = (_seeded(rng, bh, s, d) for s in (sq, sk, sk))
    do = _seeded(rng, bh, sq, d)
    scale = d ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    jo, jlse = jfa._fwd_pallas(jq, jk, jv, scale, causal, 128, 128, True,
                               None)
    jdq, jdk, jdv = jfa._flash_bwd(scale, causal, 128, 128, True, None,
                                   (jq, jk, jv, jo, jlse), jdo)

    tq, tk, tv, tdo = (_to_bf16(x) for x in (q, k, v, do))
    to, tlse = tfa.flash_attention_fwd_reference(tq, tk, tv, causal, scale)
    assert to.dtype == torch.bfloat16 and tlse.dtype == torch.float32
    # delta from the bfloat16 O, as _Flash.backward and the JAX bwd take it
    delta = (tdo.float() * to.float()).sum(-1)
    grads = tfa.flash_attention_bwd_reference(tq, tk, tv, tdo, tlse, delta,
                                              causal, scale)
    assert all(g.dtype == torch.bfloat16 for g in grads)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), rtol=0,
                               atol=LSE_TOL)
    for what, got, want in zip(("O", "dQ", "dK", "dV"), (to,) + grads,
                               (jo, jdq, jdk, jdv)):
        _hold(_f32(got), _f32(want), what, SHARE_512 if d >= 512 else SHARE)


def _dense_f32_fwd(q, k, v, causal, scale):
    """The float32 plain forward as it stood before the bfloat16 branch."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    keep = tfa._causal_keep(q.shape[1], k.shape[1], q.device) if causal \
        else None
    if keep is not None:
        s = torch.where(keep, s, torch.full_like(s, tfa.NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if keep is not None:
        p = p * keep
    l = p.sum(dim=-1, keepdim=True).clamp(min=torch.finfo(torch.float32).tiny)
    return torch.matmul(p, v.float()) / l, (m + torch.log(l))[..., 0]


def _dense_f32_bwd(q, k, v, dout, lse, delta, causal, scale):
    s = torch.matmul(q, k.transpose(1, 2)) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        p = p * tfa._causal_keep(q.shape[1], k.shape[1], q.device)
    dv = torch.matmul(p.transpose(1, 2), dout)
    ds = p * (torch.matmul(dout, v.transpose(1, 2)) - delta[..., None])
    return (torch.matmul(ds, k) * scale, torch.matmul(ds.transpose(1, 2), q)
            * scale, dv)


@pytest.mark.parametrize("causal", [False, True])
def test_a_float32_plain_path_is_unchanged(causal):
    """float32 inputs take the dense formulas, bit for bit."""
    rng = np.random.RandomState(3)
    q, k, v, do = (torch.from_numpy(rng.randn(2, s, 24).astype(np.float32))
                   for s in (40, 300, 300, 40))
    o, lse = tfa.flash_attention_fwd_reference(q, k, v, causal, 0.2)
    wo, wlse = _dense_f32_fwd(q, k, v, causal, 0.2)
    assert torch.equal(o, wo) and torch.equal(lse, wlse)
    delta = (do * o).sum(-1)
    got = tfa.flash_attention_bwd_reference(q, k, v, do, lse, delta, causal,
                                            0.2)
    want = _dense_f32_bwd(q, k, v, do, lse, delta, causal, 0.2)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_a_bf16_forward_moves_its_max_at_block_boundaries():
    """The forward's softmax blocks are BLOCK_K = 128 keys: with a large
    score in the second block, P of the first block is rounded against
    the first block's max (as the TPU kernel does), which a dense
    softmax does not reproduce; the block-wise plain version does."""
    rng = np.random.RandomState(11)
    q, k, v = (_seeded(rng, 1, s, 16) for s in (4, 256, 256))
    k[0, 200] = q[0, 0] * 2  # row 0's max lies in the second block
    jo, _ = jfa._fwd_pallas(*(jnp.asarray(x, jnp.bfloat16) for x in
                              (q, k, v)), 0.25, False, 128, 128, True, None)
    to, _ = tfa.flash_attention_fwd_reference(
        *(_to_bf16(x) for x in (q, k, v)), False, 0.25)
    assert tfa.BLOCK_K == 128
    _hold(_f32(to), _f32(jo), "O")
    # P rounded against the row's global max instead: 22% of O differs
    q32, k32, v32 = (torch.from_numpy(x) for x in (q, k, v))
    s = torch.matmul(q32, k32.transpose(1, 2)) * 0.25
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    dense = torch.matmul(tfa._bf16(p), v32) / p.sum(dim=-1, keepdim=True)
    assert _ulps(_f32(dense.to(torch.bfloat16)), _f32(jo))[1] > SHARE


def _units(x, d):
    """x's last axis (head_dim d) as 64-column units, zero-padded: the
    TMA boxes of csrc/flash_wide_wgmma.cuh."""
    return torch.nn.functional.pad(x.float(), (0, -d % 64)).split(64, -1)


def _column_plan(d):
    """(units, [(first unit, units) a slice]): ceil(d / 256) output
    slices of at most 4 units, balanced (flash_wide_wgmma.cuh plan_of)."""
    nq, nz = -(-d // 64), -(-d // 256)
    per = -(-nq // nz)
    return nq, [(z * per, min(per, nq - z * per)) for z in range(nz)]


def _chain(a, b):
    """sum over units u of a_u b_u^T, one unit after another in float32:
    the score chain over head_dim."""
    s = torch.matmul(a[0], b[0].transpose(1, 2))
    for au, bu in zip(a[1:], b[1:]):
        s = s + torch.matmul(au, bu.transpose(1, 2))
    return s


def _wide_fwd_emulated(q, k, v, causal, scale):
    """The wide forward's order of sums: per output slice, 128-key
    softmax blocks whose scores chain over every unit of head_dim (the
    slices' P bit for bit the same); acc alpha rounded, then P V of the
    block added into it in place, a 64-column unit at a time."""
    bh, sq, d = q.shape
    nq, slices = _column_plan(d)
    qu, ku, vu = _units(q, d), _units(k, d), _units(v, d)
    out = torch.zeros(bh, sq, 64 * nq)
    probs = []
    for v0, nv in slices:
        m = torch.full((bh, sq, 1), tfa.NEG_INF)
        l = torch.zeros((bh, sq, 1))
        acc = [torch.zeros(bh, sq, 64) for _ in range(nv)]
        ps = []
        for t0 in range(0, k.shape[1], tfa.BLOCK_K):
            s = _chain(qu, [x[:, t0:t0 + tfa.BLOCK_K] for x in ku]) * scale
            keep = None
            if causal:
                keep = (torch.arange(sq)[:, None]
                        >= torch.arange(t0, t0 + s.shape[-1])[None, :])
                s = torch.where(keep, s, torch.full_like(s, tfa.NEG_INF))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            if keep is not None:
                p = torch.where(keep, p, torch.zeros_like(p))
            l = l * alpha + p.sum(-1, keepdim=True)
            pb = tfa._bf16(p)
            for u in range(nv):
                acc[u] = torch.baddbmm(acc[u] * alpha, pb,
                                       vu[v0 + u][:, t0:t0 + tfa.BLOCK_K])
            m = m_new
            ps.append(p)
        probs.append(torch.cat(ps, -1))
        for u in range(nv):
            out[..., 64 * (v0 + u):64 * (v0 + u + 1)] = acc[u]
    assert all(torch.equal(p, probs[0]) for p in probs[1:])
    l = l.clamp(min=torch.finfo(torch.float32).tiny)
    return (out[..., :d] / l).to(torch.bfloat16), (m + torch.log(l))[..., 0]


def _wide_dkdv_emulated(q, k, v, do, lse, delta, causal, scale):
    """The wide dK/dV's order of sums: per block of 64 keys and output
    slice, query tiles of 64 (causal: from the block's first key), S^T
    and dP^T chained over every unit of head_dim (the slices' P^T and
    dS^T bit for bit the same), dV += bf16(P^T) dO and dK += bf16(dS^T) Q
    in place, a 64-column unit at a time."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    nq, slices = _column_plan(d)
    qu, ku, vu, du = (_units(x, d) for x in (q, k, v, do))
    dk = torch.zeros(bh, sk, 64 * nq)
    dv = torch.zeros(bh, sk, 64 * nq)
    for k0 in range(0, sk, 64):
        kb, vb = ([x[:, k0:k0 + 64] for x in xs] for xs in (ku, vu))
        kpos = torch.arange(k0, k0 + kb[0].shape[1])[:, None]
        seen = []
        for v0, nv in slices:
            acc_k = [torch.zeros(bh, kb[0].shape[1], 64) for _ in range(nv)]
            acc_v = [torch.zeros(bh, kb[0].shape[1], 64) for _ in range(nv)]
            ds_all = []
            for t0 in range(k0 if causal else 0, sq, 64):
                qt, dt = ([x[:, t0:t0 + 64] for x in xs] for xs in (qu, du))
                st = _chain(kb, qt) * scale
                p = torch.exp(st - lse[:, None, t0:t0 + 64])
                if causal:
                    qpos = torch.arange(t0, t0 + st.shape[-1])[None, :]
                    p = torch.where(qpos >= kpos, p, torch.zeros_like(p))
                ds = p * (_chain(vb, dt) - delta[:, None, t0:t0 + 64])
                ds_all += [p, ds]
                for u in range(nv):
                    acc_v[u] = torch.baddbmm(acc_v[u], tfa._bf16(p),
                                             dt[v0 + u])
                    acc_k[u] = torch.baddbmm(acc_k[u], tfa._bf16(ds),
                                             qt[v0 + u])
            seen.append(ds_all)
            for u in range(nv):
                cols = slice(64 * (v0 + u), 64 * (v0 + u + 1))
                dk[:, k0:k0 + 64, cols] = acc_k[u] * scale
                dv[:, k0:k0 + 64, cols] = acc_v[u]
        assert all(torch.equal(a, b) for other in seen[1:]
                   for a, b in zip(seen[0], other))
    return dk[..., :d].to(torch.bfloat16), dv[..., :d].to(torch.bfloat16)


def _wide_dq_emulated(q, k, v, do, lse, delta, causal, scale):
    """The wide dQ's order of sums: key tiles of 64 in order (causal: the
    tiles past a block's last row add exact zeros), S and dP chained over
    every unit of head_dim, dS = P (dP - delta) rounded to bfloat16, dQ
    += bf16(dS) K in place a 64-column unit at a time (warpgroup w's
    units w, w + 2, ...: each unit's sum is its own), scale applied once
    at the end."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    nq = -(-d // 64)
    qu, ku, vu, du = (_units(x, d) for x in (q, k, v, do))
    acc = [torch.zeros(bh, sq, 64) for _ in range(nq)]
    qpos = torch.arange(sq)[:, None]
    for t0 in range(0, sk, 64):
        kt, vt = ([x[:, t0:t0 + 64] for x in xs] for xs in (ku, vu))
        s = _chain(qu, kt) * scale
        p = torch.exp(s - lse[..., None])
        if causal:
            kpos = torch.arange(t0, t0 + s.shape[-1])[None, :]
            p = torch.where(kpos <= qpos, p, torch.zeros_like(p))
        ds = tfa._bf16(p * (_chain(du, vt) - delta[..., None]))
        for w in (0, 1):
            for u in range(w, nq, 2):
                acc[u] = torch.baddbmm(acc[u], ds, kt[u])
    return (torch.cat(acc, -1)[..., :d] * scale).to(torch.bfloat16)


@pytest.mark.parametrize("sq,sk,d,causal", [
    (200, 300, 256, True), (300, 200, 264, False), (200, 300, 512, False),
    (300, 200, 384, True)])
def test_a_wide_wgmma_order_of_sums_emulated(sq, sk, d, causal):
    """The order of sums of csrc/flash_wide_wgmma.cuh (K2, K3a and K3b
    bf16 at 128 < head_dim <= 512), emulated in float32, within 1 bf16
    ulp of the max of the plain bf16 version (and at most SHARE of the
    elements differing); every column slice computes the same P and
    dS."""
    rng = np.random.RandomState(sq + sk + d)
    q, k, v = (_to_bf16(_seeded(rng, 2, s, d)) for s in (sq, sk, sk))
    do = _to_bf16(_seeded(rng, 2, sq, d))
    scale = d ** -0.5
    o, lse = tfa.flash_attention_fwd_reference(q, k, v, causal, scale)
    eo, else_ = _wide_fwd_emulated(q, k, v, causal, scale)
    np.testing.assert_allclose(else_.numpy(), lse.numpy(), rtol=0,
                               atol=LSE_TOL)
    delta = (do.float() * o.float()).sum(-1)
    rq, rk, rv = tfa.flash_attention_bwd_reference(q, k, v, do, lse,
                                                   delta, causal, scale)
    ek, ev = _wide_dkdv_emulated(q, k, v, do, lse, delta, causal, scale)
    eq = _wide_dq_emulated(q, k, v, do, lse, delta, causal, scale)
    for what, got, want in (("O", eo, o), ("dK", ek, rk), ("dV", ev, rv),
                            ("dQ", eq, rq)):
        ulps, share = _ulps(_f32(got), _f32(want))
        assert ulps <= 1 and share <= SHARE, (what, ulps, share)


# --- (b) autograd -----------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_b_flash_attention_autograd_matches_jax(causal):
    rng = np.random.RandomState(21 + causal)
    b, s, h, d = 2, 160, 2, 64
    q, k, v, do = (_seeded(rng, b, s, h, d) for _ in range(4))
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))

    def jf(q, k, v):
        return jfa.flash_attention(q, k, v, causal=causal, interpret=True)

    jo, vjp = jax.vjp(jf, jq, jk, jv)
    jgrads = vjp(jdo)
    tq, tk, tv = (_to_bf16(x).requires_grad_() for x in (q, k, v))
    before = dict(tfa.counts_bf16.plain_calls)
    before32 = dict(tfa.counts.plain_calls)
    to = tfa.flash_attention(tq, tk, tv, causal=causal)
    tgrads = torch.autograd.grad(to, (tq, tk, tv), _to_bf16(do))
    assert tfa.counts_bf16.plain_calls == {n: before[n] + 1 for n in before}
    assert tfa.counts.plain_calls == before32
    assert to.dtype == torch.bfloat16 and to.shape == (b, s, h, d)
    for what, got, want in zip(("O", "dQ", "dK", "dV"), (to,) + tgrads,
                               (jo,) + tuple(jgrads)):
        assert got.dtype == torch.bfloat16
        _hold(_f32(got), _f32(want), what)


# --- (c) the cast op --------------------------------------------------

@pytest.mark.parametrize("src,dst", [("float32", "bfloat16"),
                                     ("bfloat16", "float32")])
def test_c_cast_op_and_gradient_match_jax(src, dst):
    rng = np.random.RandomState(7)
    x = rng.randn(3, 5, 7).astype(np.float32) * 3
    dy = rng.randn(3, 5, 7).astype(np.float32)
    attrs = {"in_dtype": src, "out_dtype": dst}
    jx = jnp.asarray(x, jnp.dtype(src) if src != "bfloat16" else jnp.bfloat16)
    jdy = jnp.asarray(dy, jnp.bfloat16 if dst == "bfloat16" else jnp.float32)
    fwd = jax_op_info("cast").forward
    jy, vjp = jax.vjp(lambda a: fwd(None, {"X": [a]}, attrs)["Out"], jx)
    (jdx,) = vjp(jdy)

    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    ctx = EmitCtx(device="cpu", root_seed=1)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt[src])
    outs, record = forward_with_grad(ctx, "cast", {"X": [tx]}, attrs)
    ty = outs["Out"][0]
    assert ty.dtype == tdt[dst]
    np.testing.assert_array_equal(_f32(ty), _f32(jy))
    gattrs = {FWD_META_ATTR: {"type": "cast", "attrs": attrs,
                              "in_slots": ["X"], "out_slots": ["Out"]}}
    tdy = torch.from_numpy(np.array(jdy.astype(jnp.float32))).to(tdt[dst])
    grads = run_grad(ctx, {"X": [tx], "Out@Out": [ty], "GRAD@Out": [tdy]},
                     gattrs, record)
    tdx = grads["GRAD@X"][0]
    assert tdx.dtype == tdt[src] and jdx.dtype == jx.dtype
    np.testing.assert_array_equal(_f32(tdx), _f32(jdx))


def test_c_cast_layer_builds_the_jax_program():
    progs = []
    for fluid, layers, unique_name in (JAX, PORT):
        main, startup = fluid.Program(), fluid.Program()
        with unique_name.guard(), fluid.program_guard(main, startup):
            x = layers.data(name="x", shape=[4], dtype="float32")
            y = layers.cast(x, "bfloat16")
            z = layers.cast(y, np.float32)
        progs.append(([(op.type, op.desc.inputs, op.desc.outputs,
                        op.attr("in_dtype"), op.attr("out_dtype"))
                       for op in main.global_block().ops],
                      (y.dtype, z.dtype)))
    assert progs[0] == progs[1]
    assert progs[1][1] == ("bfloat16", "float32")


# --- (d) the attention program ----------------------------------------

def _attention_build(pkg, heads, seq, dh, bf16=True, lr=0.1):
    """Transformer-base's self-attention layer (models/transformer.py
    _mha, seq_parallel form): q, k, v fc projections without bias,
    reshaped to [B, S, H, dh], cast to bfloat16, causal ring_attention,
    cast back, the output fc, a squared-error loss, Momentum(lr, 0.9)."""
    fluid, layers, unique_name = pkg
    d = heads * dh
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data(name="x", shape=[seq, d], dtype="float32")
        y = layers.data(name="y", shape=[seq, d], dtype="float32")

        def proj(inp, pname):
            return layers.fc(input=inp, size=d, num_flatten_dims=2,
                             bias_attr=False, param_attr=fluid.ParamAttr(
                                 name=f"attn.{pname}.w"))

        qkv = [layers.reshape(proj(x, n), shape=[0, 0, heads, dh])
               for n in "qkv"]
        if bf16:
            qkv = [layers.cast(t, "bfloat16") for t in qkv]
        attn = layers.ring_attention(*qkv, causal=True)
        ctx = layers.cast(attn, "float32") if bf16 else attn
        out = proj(layers.reshape(ctx, shape=[0, 0, d]), "out")
        cost = layers.mean(layers.square_error_cost(input=out, label=y))
        _, pg = fluid.optimizer.Momentum(learning_rate=lr,
                                         momentum=0.9).minimize(cost)
    return main, startup, cost, attn, [(p.name, g.name) for p, g in pg]


@pytest.fixture
def jax_flags():
    saved = {k: JFLAGS[k] for k in ("use_pallas_kernels", "flash_min_seq")}
    set_flags({"use_pallas_kernels": True, "flash_min_seq": 0})
    yield
    set_flags(saved)


def _jax_persistables(program, scope):
    return {n: np.asarray(scope.find_var(n))
            for n, v in program.global_block().vars.items()
            if v.persistable and scope.find_var(n) is not None}


def test_d_bf16_attention_program_trains_like_jax(jax_flags):
    """2 heads, S = 64, head_dim 32, batch 2, Momentum(0.1, 0.9), 3 steps
    from the JAX scope's values. Losses within LOSS_RTOL = 1e-5 relative
    (the fc products and the update are float32 on both sides, summed in
    other orders; a bfloat16 element of the attention output that rounded
    the other way moves the loss by ~1e-7 of itself; observed at most
    7.5e-7); the attention output and the four parameter gradients
    fetched at step 1 within the bfloat16 bounds above, the float32
    gradients within ULPS only (observed: the output bitwise equal, the
    gradients within 4e-5 ulps; with other initial values one output
    element of 8192 one bfloat16 step apart, its exact value 1.5e-8 of
    itself from the rounding midpoint); every parameter float32, every
    gradient var of a bfloat16 var bfloat16. The update is linear in the
    gradient: Adam's first steps move each weight by about lr * sign(g),
    which amplifies the order noise of gradient elements near 0 (under
    Adam(1e-3) the step-3 losses differed by 1.3e-5 of themselves)."""
    heads, seq, dh, batch = 2, 64, 32, 2
    jm, js, jcost, jattn, jpg = _attention_build(JAX, heads, seq, dh)
    tm, _, tcost, tattn, tpg = _attention_build(PORT, heads, seq, dh)
    assert jpg == tpg and len(tpg) == 4
    assert tattn.dtype == jattn.dtype == "bfloat16"
    for name, var in tm.global_block().vars.items():
        if name.endswith("@GRAD") and name[:-5] in tm.global_block().vars:
            assert var.dtype == tm.global_block().vars[name[:-5]].dtype, name
    rng = np.random.RandomState(9)
    feed = {"x": rng.randn(batch, seq, heads * dh).astype(np.float32),
            "y": rng.randn(batch, seq, heads * dh).astype(np.float32)}

    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    texe, tscope = tfluid.Executor("cpu"), tfluid.Scope()
    tfluid.params_from_jax(_jax_persistables(jm, jscope), tscope,
                           device="cpu")
    before = dict(tfa.counts_bf16.plain_calls)
    before32 = dict(tfa.counts.plain_calls)
    out = {}
    for side, exe, prog, cost, attn, scope in (
            ("jax", jexe, jm, jcost, jattn, jscope),
            ("torch", texe, tm, tcost, tattn, tscope)):
        losses, first = [], None
        for i in range(3):
            with jax.disable_jit():
                got = exe.run(prog, feed=feed, scope=scope,
                              fetch_list=[cost] + ([attn] + [g for _, g in tpg]
                                                   if i == 0 else []))
            losses.append(float(np.asarray(got[0]).reshape(-1)[0]))
            if i == 0:
                first = got[1:]
        dtypes = {p.name: str(np.asarray(scope.find_var(p.name)).dtype)
                  for p in prog.global_block().all_parameters()}
        out[side] = (losses, first[0], first[1:], dtypes)
    (jl, ja, jg, jd), (tl, ta, tg, td) = out["jax"], out["torch"]
    assert tfa.counts_bf16.plain_calls == {n: before[n] + 3 for n in before}
    assert tfa.counts.plain_calls == before32
    # the bfloat16 fetch: float32 numpy, the exact widening of the value
    assert ta.dtype == np.float32 and ta.shape == (batch, seq, heads, dh)
    _hold(ta, np.asarray(ja).astype(np.float32), "attention output")
    # the gradients are float32, summed in other orders: nearly every
    # element differs in its last bits, so only the ulps bound applies
    for (name, _), got, want in zip(tpg, tg, jg):
        assert _ulps(got, want)[0] <= ULPS, name
    for a, b in zip(tl, jl):
        assert abs(a - b) <= LOSS_RTOL * abs(b), (tl, jl)
    assert tl[-1] < tl[0]
    assert set(td.values()) == set(jd.values()) == {"float32"}


def test_d_bf16_fetch_var_and_tensor_fetch():
    """A bfloat16 variable fetched as numpy is its exact float32 widening;
    ``return_numpy=False`` gives the bfloat16 tensor."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tunique.guard(), tfluid.program_guard(main, startup):
        x = tlayers.data(name="x", shape=[5], dtype="float32")
        y = tlayers.cast(x, "bfloat16")
    xv = np.random.RandomState(1).randn(3, 5).astype(np.float32)
    exe, scope = tfluid.Executor("cpu"), tfluid.Scope()
    (got,) = exe.run(main, feed={"x": xv}, fetch_list=[y], scope=scope)
    want = torch.from_numpy(xv).to(torch.bfloat16)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want.float().numpy())
    (t,) = exe.run(main, feed={"x": xv}, fetch_list=[y], scope=scope,
                   return_numpy=False)
    assert t.dtype == torch.bfloat16 and torch.equal(t, want)
    scope.set_var("h", want)
    got = tfluid.fetch_var("h", scope)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want.float().numpy())
    assert tfluid.fetch_var("h", scope, return_numpy=False) is want


# --- (e) routes and checks --------------------------------------------

def test_e_routes_count_the_bf16_kernels_apart():
    q = torch.empty(4, 40, 16, device="meta", dtype=torch.bfloat16)
    k = torch.empty(4, 24, 16, device="meta", dtype=torch.bfloat16)
    before = dict(tfa.counts_bf16.plain_calls)
    before32 = dict(tfa.counts.plain_calls)
    o, lse = tfa.flash_attention_fwd(q, k, k, True, 0.25)
    assert (o.dtype, lse.dtype) == (torch.bfloat16, torch.float32)
    assert (o.shape, lse.shape) == ((4, 40, 16), (4, 40))
    grads = tfa.flash_attention_bwd(q, k, k, q, lse, lse, True, 0.25)
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3
    assert tfa.counts_bf16.plain_calls == before
    cpu = torch.ones(2, 5, 16, dtype=torch.bfloat16)
    tfa.flash_attention_fwd(cpu, cpu, cpu, True, 0.25)
    row = torch.zeros(2, 5)
    tfa.flash_attention_bwd(cpu, cpu, cpu, cpu, row, row, True, 0.25)
    assert tfa.counts_bf16.plain_calls == {n: before[n] + 1 for n in before}
    assert tfa.counts.plain_calls == before32
    assert tfa.counts_bf16.names == (tfa.FWD_BF16, tfa.BWD_DKDV_BF16,
                                     tfa.BWD_DQ_BF16)
    # the kernels' checks take one dtype, float32 or bfloat16; lse and
    # delta float32
    for d in (8, 136, 264):
        t = torch.empty(4, 40, d, device="meta", dtype=torch.bfloat16)
        f = torch.empty(4, 40, device="meta")
        assert tfa._check_cuda(q=t, k=t, v=t, dout=t, lse=f, delta=f) \
            == t.device
    with pytest.raises(TypeError, match="float32"):
        tfa._check_cuda(q=q, k=k.float(), v=k)
    with pytest.raises(TypeError, match="float32"):
        tfa._check_cuda(q=q.half(), k=k.half(), v=k.half())
    with pytest.raises(TypeError, match="float32 lse"):
        tfa._check_cuda(q=q, k=k, v=k, dout=q, lse=q[..., 0], delta=lse)


@pytest.mark.parametrize("d", [1, 12, 72, 130])
def test_e_bf16_head_dim_padding_is_exact(d):
    """bfloat16 rows are staged 16 bytes at a time: head_dim is zero-padded
    to a multiple of 8, and the plain bfloat16 forward and backward on the
    padded inputs give the unpadded ones' values (zero columns add exact
    zeros to q.k and dO.v; the float32 sums may reorder)."""
    rng = np.random.RandomState(d)
    q, k, v, do = (_to_bf16(_seeded(rng, 2, 150, d)) for _ in range(4))
    scale = d ** -0.5
    padded = tfa.pad_head_dim(q, k, v, do)
    assert padded[0].shape[-1] % 8 == 0 and padded[0].shape[-1] - d < 8
    assert torch.equal(padded[0][..., :d], q)
    assert not padded[0][..., d:].float().any()
    o, lse = tfa.flash_attention_fwd_reference(q, k, v, True, scale)
    op, lsep = tfa.flash_attention_fwd_reference(*padded[:3], True, scale)
    delta = (do.float() * o.float()).sum(-1)
    grads = tfa.flash_attention_bwd_reference(q, k, v, do, lse, delta, True,
                                              scale)
    gradsp = tfa.flash_attention_bwd_reference(*padded, lsep, delta, True,
                                               scale)
    np.testing.assert_allclose(lsep.numpy(), lse.numpy(), rtol=0, atol=1e-6)
    for what, got, want in zip(("O", "dQ", "dK", "dV"),
                               tfa._unpad(d, op, *gradsp), (o,) + grads):
        _hold(_f32(got), _f32(want), what)
