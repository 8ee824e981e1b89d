"""The contract around the bfloat16 flash backward's kernels, on the CPU,
at small sizes. The kernels themselves (K3a ``flash_bwd_dkdv_bf16`` and
K3b ``flash_bwd_dq_bf16`` on wgmma and TMA, the delta pass
``flash_delta``) run only on the card, where chip_smoke.py holds them
against their plain versions; here:

  (a) the plain delta (``flash_delta_reference``, which the CPU route of
      ``_Flash.backward`` runs) against the delta the JAX ``_flash_bwd``
      hands its Pallas kernels, on the same seeded bfloat16 O and dO:
      within 1e-6 of the largest |delta| (float32 sums of exact products
      in another order; observed at most 5.5e-8), and the float32 form;
  (b) the ``flash_delta`` router: the CPU takes the plain version and
      counts it, ``meta`` takes it uncounted, any other device raises;
      ``flash_attention``'s backward counts one delta and one of each
      backward kernel on the CPU;
  (c) the wrappers' refusals before any launch (dtype, shape, alignment,
      contiguity, device), through ``meta`` tensors and CPU tensors.
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

DELTA_RTOL = 1e-6


def _seeded(rng, *shape):
    """float32 normals rounded to bfloat16: the same values on both sides."""
    return np.array(jnp.asarray(rng.randn(*shape).astype(np.float32),
                                jnp.bfloat16).astype(jnp.float32))


def _jax_delta(monkeypatch, q, k, v, do, causal, scale):
    """(O, delta) of the JAX bf16 backward: O from ``_fwd_pallas``, delta as
    ``_flash_bwd`` passes it to its first pallas_call (interpret mode)."""
    seen = []
    real = jfa.pl.pallas_call

    def spy(*a, **kw):
        kernel = real(*a, **kw)

        def run(*args):
            seen.append(args)
            return kernel(*args)
        return run

    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    jo, jlse = jfa._fwd_pallas(jq, jk, jv, scale, causal, 128, 128, True,
                               None)
    monkeypatch.setattr(jfa.pl, "pallas_call", spy)
    jfa._flash_bwd(scale, causal, 128, 128, True, None,
                   (jq, jk, jv, jo, jlse), jdo)
    monkeypatch.setattr(jfa.pl, "pallas_call", real)
    # _bwd_dkdv_kernel's inputs: q, do, lse, delta [bh, sq_pad, 1], k, v
    delta = np.asarray(seen[0][3])[:, :q.shape[1], 0]
    return jo, delta


@pytest.mark.parametrize("sq,d,causal", [(256, 64, True), (200, 72, False),
                                         (77, 8, True)])
def test_a_plain_delta_matches_the_jax_backward(monkeypatch, sq, d, causal):
    rng = np.random.RandomState(sq + d)
    bh = 3
    q, k, v, do = (_seeded(rng, bh, sq, d) for _ in range(4))
    jo, jdelta = _jax_delta(monkeypatch, q, k, v, do, causal, d ** -0.5)
    assert jdelta.dtype == np.float32 and jdelta.shape == (bh, sq)
    to = torch.from_numpy(np.array(jo.astype(jnp.float32))).to(
        torch.bfloat16)
    tdo = torch.from_numpy(do).to(torch.bfloat16)
    got = tfa.flash_delta_reference(tdo, to)
    assert got.dtype == torch.float32 and got.shape == (bh, sq)
    err = np.abs(got.numpy() - jdelta).max() / np.abs(jdelta).max()
    assert err <= DELTA_RTOL, err
    # float32 rows: the dense float32 products and sum
    o32 = rng.randn(bh, sq, d).astype(np.float32)
    want = np.sum(do * o32, axis=-1, dtype=np.float64)
    got32 = tfa.flash_delta_reference(torch.from_numpy(do),
                                      torch.from_numpy(o32))
    assert np.abs(got32.numpy() - want).max() <= \
        DELTA_RTOL * np.abs(want).max()


def test_b_delta_router_counts_and_routes():
    before = dict(tfa.counts_delta.plain_calls)
    meta = torch.empty(4, 40, 16, device="meta", dtype=torch.bfloat16)
    got = tfa.flash_delta(meta, meta)
    assert (got.shape, got.dtype) == ((4, 40), torch.float32)
    assert tfa.counts_delta.plain_calls == before
    cpu = torch.ones(2, 5, 16, dtype=torch.bfloat16)
    assert torch.equal(tfa.flash_delta(cpu, cpu * 2),
                       torch.full((2, 5), 32.0))
    assert tfa.counts_delta.plain_calls == {tfa.DELTA: before[tfa.DELTA] + 1}
    assert tfa.counts_delta.names == (tfa.DELTA,)
    with pytest.raises(ValueError, match="cpu .* or cuda"):
        tfa.flash_delta(_OtherDevice(), cpu)


class _OtherDevice:
    """Stands for a tensor on a device the router does not take."""
    device = torch.device("xpu")


def test_b_backward_counts_one_delta_and_each_kernel():
    rng = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(_seeded(rng, 1, 40, 2, 16)).to(torch.bfloat16)
               .requires_grad_() for _ in range(3))
    before = (dict(tfa.counts_delta.plain_calls),
              dict(tfa.counts_bf16.plain_calls))
    out = tfa.flash_attention(q, k, v, causal=True)
    torch.autograd.grad(out.float().sum(), (q, k, v))
    assert tfa.counts_delta.plain_calls[tfa.DELTA] == \
        before[0][tfa.DELTA] + 1
    assert tfa.counts_bf16.plain_calls == {n: c + 1 for n, c in
                                           before[1].items()}


def _bwd_args(dtype=torch.bfloat16, device="meta", d=64, bh=4, sq=96,
              sk=80):
    q, do = (torch.empty(bh, sq, d, device=device, dtype=dtype)
             for _ in range(2))
    k, v = (torch.empty(bh, sk, d, device=device, dtype=dtype)
            for _ in range(2))
    lse, delta = (torch.empty(bh, sq, device=device) for _ in range(2))
    return [q, k, v, do, lse, delta, True, 0.125]


@pytest.mark.parametrize("wrapper", ["_bwd_dkdv_cuda", "_bwd_dq_cuda"])
def test_c_backward_wrappers_refuse_before_launch(wrapper):
    fn = getattr(tfa, wrapper)
    bad = _bwd_args()
    bad[3] = bad[3].float()  # dO float32 among bfloat16
    with pytest.raises(TypeError, match="one dtype"):
        fn(*bad)
    bad = _bwd_args(dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fn(*bad)
    bad = _bwd_args()
    bad[4] = bad[4].to(torch.bfloat16)
    with pytest.raises(TypeError, match="float32 lse"):
        fn(*bad)
    bad = _bwd_args()  # q one element off a 16-byte boundary
    bad[0] = torch.empty(bad[0].numel() + 1, device="meta",
                         dtype=torch.bfloat16)[1:].view(bad[0].shape)
    with pytest.raises(ValueError, match="16-byte aligned q"):
        fn(*bad)
    bad = _bwd_args()  # dO not contiguous
    bad[3] = torch.empty(4, 64, 96, device="meta",
                         dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fn(*bad)
    bad = _bwd_args()  # delta on another device than q
    bad[5] = torch.empty(4, 96)
    with pytest.raises(ValueError, match="is on cpu"):
        fn(*bad)
    bad = _bwd_args()  # k and v of other shapes
    bad[2] = bad[2][:, :40]
    with pytest.raises(ValueError, match="flash attention takes"):
        fn(*bad)


def test_c_delta_wrapper_refuses_before_launch():
    t = torch.empty(4, 40, 64, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="one shape"):
        tfa._delta_cuda(t, t[:, :20])
    with pytest.raises(TypeError, match="one dtype"):
        tfa._delta_cuda(t, t.float())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa._delta_cuda(t.half(), t.half())
    off = torch.empty(t.numel() + 1, device="meta",
                      dtype=torch.bfloat16)[1:].view(t.shape)
    with pytest.raises(ValueError, match="16-byte aligned dout"):
        tfa._delta_cuda(off, t)
    with pytest.raises(ValueError, match="is on cpu"):
        tfa._delta_cuda(t, torch.empty(4, 40, 64, dtype=torch.bfloat16))
