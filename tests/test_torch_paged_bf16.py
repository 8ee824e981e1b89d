"""K4 on bfloat16 pages: the port's plain version against the JAX
package's Pallas kernel in interpret mode, and a decoder stepped through
a bfloat16 ``PagedKvCache`` against the JAX package's, on the CPU.

The JAX kernel widens bf16 pages to float32 as it loads them
(``paddle_tpu/fluid/ops/pallas_kernels/paged_attention.py:188-190``) and
its output takes Q's dtype (``:271``); the port's plain version does the
same, and the card's kernel (``csrc/paged_attention.cu``,
``paged_attention_bf16``) is held to the plain version by
``chip_smoke.py``.

Tolerances: float32 Q, atol 1e-5 (sums in another order); bf16 Q, one
bf16 ulp of max|O| (the two float32 results round to neighbouring bf16
values at worst). A decoder step: logits atol 1e-4 (as the float32 step's
test), pools within one bf16 ulp (a K/V row computed in float32 by XLA
and PyTorch may round to neighbouring bf16 values); greedy tokens equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.fluid.ops.pallas_kernels.paged_attention import (
    _paged_attention_pallas)
from paddle_tpu.serving import decode as jd
from paddle_tpu.serving import kv_cache as jkv
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.serving import decode as td
from paddle_tpu_torch.serving import kv_cache as tkv

ATOL = 1e-5
BF16_ULP = 2.0 ** -8

CASES = {
    # decode: one token a slot, ragged lengths, a dead slot
    "decode": dict(B=4, C=None, Hq=4, Hkv=4, D=16, ps=4, W=5, P=20,
                   kv_lens=[1, 7, 0, 20], q_lens=None),
    # prefill: chunks with dead lanes, a dead slot, a page boundary
    "prefill": dict(B=3, C=6, Hq=4, Hkv=4, D=16, ps=4, W=5, P=20,
                    kv_lens=[20, 5, 0], q_lens=[6, 5, 0]),
    # GQA: 4 query heads a kv head, chunked, head_dim not a multiple of 4
    "gqa": dict(B=2, C=5, Hq=8, Hkv=2, D=18, ps=8, W=4, P=12,
                kv_lens=[30, 5], q_lens=[5, 3]),
}


def _case(seed, *, B, C, Hq, Hkv, D, ps, W, P, kv_lens, q_lens):
    rng = np.random.RandomState(seed)
    q = rng.randn(*((B, Hq, D) if C is None else (B, C, Hq, D)))
    kp = rng.randn(P, ps, Hkv, D)
    vp = rng.randn(P, ps, Hkv, D)
    kv_lens = np.asarray(kv_lens, np.int32)
    tables = np.zeros((B, W), np.int32)
    for b in range(B):
        n = -(-int(kv_lens[b]) // ps)
        tables[b, :n] = rng.randint(1, P, size=n)
    q_lens = None if q_lens is None else np.asarray(q_lens, np.int32)
    return (q.astype(np.float32), kp.astype(np.float32),
            vp.astype(np.float32), tables, kv_lens, q_lens)


def _both(q, kp, vp, tables, kv_lens, q_lens, q_dtype):
    """The JAX kernel (interpret mode) and the port's router on the same
    inputs, pages rounded to bf16 by each package (both round to nearest
    even, so the pages are bitwise equal)."""
    jdt = jnp.bfloat16 if q_dtype == torch.bfloat16 else jnp.float32
    jq = jnp.asarray(q).astype(jdt)
    jk = jnp.asarray(kp).astype(jnp.bfloat16)
    jv = jnp.asarray(vp).astype(jnp.bfloat16)
    jout = _paged_attention_pallas(
        jq, jk, jv, jnp.asarray(tables), jnp.asarray(kv_lens),
        q_lens=None if q_lens is None else jnp.asarray(q_lens),
        interpret=True)
    tk = torch.from_numpy(kp).to(torch.bfloat16)
    tv = torch.from_numpy(vp).to(torch.bfloat16)
    assert np.array_equal(tk.float().numpy(),
                          np.asarray(jk.astype(jnp.float32)))
    tout = pa.paged_attention(
        torch.from_numpy(q).to(q_dtype), tk, tv, torch.from_numpy(tables),
        torch.from_numpy(kv_lens),
        q_lens=None if q_lens is None else torch.from_numpy(q_lens))
    return np.asarray(jout.astype(jnp.float32)), tout


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_on_bf16_pages_matches_pallas(name):
    q, kp, vp, tables, kv_lens, q_lens = _case(3, **CASES[name])
    pa.counts.reset()
    jout, tout = _both(q, kp, vp, tables, kv_lens, q_lens, torch.float32)
    # the output takes Q's dtype; the router counted the bf16 form's plain
    # version
    assert tout.dtype == torch.float32
    assert pa.counts.plain_calls == {pa.KERNEL: 0, pa.KERNEL_BF16: 1}
    np.testing.assert_allclose(tout.numpy(), jout, atol=ATOL, rtol=0)
    # dead slots and dead lanes are exact zeros
    if q_lens is not None:
        for b, ql in enumerate(q_lens):
            assert not tout[b, ql:].any()
    else:
        assert not tout[kv_lens == 0].any()


@pytest.mark.parametrize("name", sorted(CASES))
def test_bf16_q_on_bf16_pages_returns_bf16(name):
    q, kp, vp, tables, kv_lens, q_lens = _case(4, **CASES[name])
    jout, tout = _both(q, kp, vp, tables, kv_lens, q_lens, torch.bfloat16)
    assert tout.dtype == torch.bfloat16
    got = tout.float().numpy()
    np.testing.assert_allclose(got, jout, rtol=0,
                               atol=BF16_ULP * np.abs(jout).max())


def test_other_page_dtypes_are_refused_by_name():
    q, kp, vp, tables, kv_lens, _ = _case(5, **CASES["decode"])
    assert pa.kernel_of(torch.from_numpy(kp)) == pa.KERNEL
    assert pa.kernel_of(torch.from_numpy(kp).bfloat16()) == pa.KERNEL_BF16
    with pytest.raises(TypeError, match="float16"):
        pa.kernel_of(torch.from_numpy(kp).half())


def _pools(spec, P, ps, dtype_np, rng):
    shape = (spec.n_layers, P, ps, spec.n_kv_heads, spec.head_dim)
    return rng.randn(*shape).astype(dtype_np), rng.randn(*shape).astype(
        dtype_np)


def test_bf16_cache_stepped_by_decoder_matches_jax():
    """A ``PagedKvCache(dtype=bf16)`` of each package, stepped by
    ``decoder_step_chunked`` through a 5-token prefill chunk and four
    greedy decode steps, with the JAX parameters carried across by
    ``params_from_jax``: the same tokens, logits within 1e-4, pools
    within a bf16 ulp."""
    spec_kw = dict(vocab=64, d_model=32, n_layers=2, n_heads=4,
                   n_kv_heads=2, seed=11)
    jspec, tspec = jd.DecoderSpec(**spec_kw), td.DecoderSpec(**spec_kw)
    jparams = jd.build_decoder_params(jspec)
    tparams = td.params_from_jax(jparams, device="cpu")
    P, ps = 8, 4
    jc = jkv.PagedKvCache(jspec.n_layers, jspec.n_kv_heads, jspec.head_dim,
                          page_size=ps, num_pages=P, dtype=jnp.bfloat16)
    tc = tkv.PagedKvCache(tspec.n_layers, tspec.n_kv_heads, tspec.head_dim,
                          page_size=ps, num_pages=P, dtype=torch.bfloat16,
                          device="cpu")
    assert tc.hbm_bytes == jc.hbm_bytes == tc.device_bytes
    tables = np.array([[1, 2, 3, 0], [0, 0, 0, 0]], np.int32)
    prompt = [3, 1, 4, 1, 5]
    tokens = np.zeros((2, 5), np.int32)
    positions = np.zeros((2, 5), np.int32)
    tokens[0] = prompt
    positions[0] = np.arange(5)
    q_lens = np.array([5, 0], np.int32)
    kv_lens = np.array([5, 0], np.int32)
    produced = []
    for step in range(5):
        jk, jv, jlog = jd.decoder_step_chunked(
            jparams, jspec, jnp.asarray(tokens), jnp.asarray(positions),
            jnp.asarray(q_lens), jc.k, jc.v, jnp.asarray(tables),
            jnp.asarray(kv_lens))
        jc.rebind(jk, jv)
        with torch.no_grad():
            tk, tv, tlog = td.decoder_step_chunked(
                tparams, tspec, *(torch.from_numpy(a) for a in (
                    tokens, positions, q_lens)), tc.k, tc.v,
                torch.from_numpy(tables), torch.from_numpy(kv_lens))
        tc.rebind(tk, tv)
        assert tc.k.dtype == torch.bfloat16
        jl, tl = np.asarray(jlog), tlog.numpy()
        np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
        for a, b in ((tc.k, jc.k), (tc.v, jc.v)):
            want = np.asarray(b.astype(jnp.float32))
            np.testing.assert_allclose(a.float().numpy(), want, rtol=0,
                                       atol=BF16_ULP * np.abs(want).max())
        # greedy, with a margin above the step's float error
        top2 = np.sort(jl[0])[-2:]
        assert top2[1] - top2[0] > 1e-3
        nxt = int(np.argmax(jl[0]))
        assert nxt == int(np.argmax(tl[0]))
        produced.append(nxt)
        pos = int(kv_lens[0])
        tokens = np.zeros((2, 1), np.int32)
        positions = np.zeros((2, 1), np.int32)
        tokens[0, 0], positions[0, 0] = nxt, pos
        q_lens = np.array([1, 0], np.int32)
        kv_lens = np.array([pos + 1, 0], np.int32)
    assert len(produced) == 5


def test_bf16_pool_spills_and_restores_bitwise():
    """A preemption spill of a bf16 pool travels as its int16 bits and
    restores bitwise into other pages."""
    rng = np.random.RandomState(9)
    c = tkv.PagedKvCache(2, 2, 8, page_size=4, num_pages=8,
                         dtype=torch.bfloat16, device="cpu")
    c.k.copy_(torch.from_numpy(rng.randn(*c.k.shape).astype(np.float32)))
    c.v.copy_(torch.from_numpy(rng.randn(*c.v.shape).astype(np.float32)))
    k, v = c.gather_pages([2, 5])
    assert k.dtype == np.int16 and k.shape == (2, 2, 4, 2, 8)
    c.scatter_pages([6, 7], k, v)
    assert torch.equal(c.k[:, [6, 7]], c.k[:, [2, 5]])
    assert torch.equal(c.v[:, [6, 7]], c.v[:, [2, 5]])
