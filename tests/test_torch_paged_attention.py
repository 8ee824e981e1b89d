"""The port's ragged paged attention (paddle_tpu_torch/kernels) against
the JAX package's: its plain PyTorch version is held to the JAX
reference ``paged_attention_reference`` AND to the Pallas kernel run in
interpret mode, on the same seeded numpy inputs.

Tolerance: atol 1e-5, rtol 1e-5 in float32 — the same function, with
sums taken in another order. Dead slots and dead query lanes must be
exactly 0 in every implementation.

The hand-written CUDA kernel runs only on a card; ``chip_smoke.py``
holds it against the plain version there. Here the router must take the
plain version for CPU tensors and count it, and the kernels package must
import with no nvcc in reach.
"""
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.fluid.ops.pallas_kernels.paged_attention import (
    _paged_attention_pallas, paged_attention_reference as jax_reference)
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import paged_attention as pa

ATOL = RTOL = 1e-5


def _case(seed, *, B, C, Hq, Hkv, D, ps, W, P, kv_lens, q_lens):
    """Seeded inputs. Tables name live pages for each slot's visible
    keys and the garbage page 0 past them (the engine's padding); a
    dead slot's row is all garbage."""
    rng = np.random.RandomState(seed)
    shape_q = (B, Hq, D) if C is None else (B, C, Hq, D)
    q = rng.randn(*shape_q).astype(np.float32)
    kp = rng.randn(P, ps, Hkv, D).astype(np.float32)
    vp = rng.randn(P, ps, Hkv, D).astype(np.float32)
    kv_lens = np.asarray(kv_lens, np.int32)
    tables = np.zeros((B, W), np.int32)
    for b in range(B):
        n = -(-int(kv_lens[b]) // ps)
        tables[b, :n] = rng.randint(1, P, size=n)
    q_lens = None if q_lens is None else np.asarray(q_lens, np.int32)
    return q, kp, vp, tables, kv_lens, q_lens


CASES = {
    # single-token form: ragged lengths, a dead slot (kv_len 0)
    "single_mha_ps4": dict(B=4, C=None, Hq=4, Hkv=4, D=8, ps=4, W=5, P=20,
                           kv_lens=[1, 7, 0, 20], q_lens=None),
    "single_gqa2_ps16": dict(B=3, C=None, Hq=4, Hkv=2, D=16, ps=16, W=3,
                             P=8, kv_lens=[40, 0, 17], q_lens=None),
    "single_gqa4_ps4": dict(B=3, C=None, Hq=8, Hkv=2, D=8, ps=4, W=6,
                            P=20, kv_lens=[24, 0, 13], q_lens=None),
    # chunked form: ragged q_lens (dead lanes), q_len 0 (dead slot), a
    # chunk crossing a page boundary, a pure-prefill chunk
    "chunk_mha_ps4": dict(B=3, C=6, Hq=4, Hkv=4, D=8, ps=4, W=5, P=20,
                          kv_lens=[20, 5, 0], q_lens=[6, 5, 0]),
    "chunk_gqa2_ps16": dict(B=4, C=5, Hq=4, Hkv=2, D=16, ps=16, W=3, P=10,
                            kv_lens=[33, 5, 40, 9], q_lens=[5, 5, 1, 0]),
    "chunk_gqa4_ps4": dict(B=2, C=8, Hq=8, Hkv=2, D=8, ps=4, W=6, P=20,
                           kv_lens=[23, 8], q_lens=[3, 8]),
}


def _dead_mask(case, shape):
    """[B, C] True where a row must be exactly 0."""
    kv = np.asarray(case["kv_lens"])
    if case["q_lens"] is None:
        return (kv == 0)[:, None]
    ql = np.asarray(case["q_lens"])
    return np.arange(shape[1])[None, :] >= ql[:, None]


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_matches_jax_reference_and_pallas(name):
    case = CASES[name]
    q, kp, vp, tables, kv_lens, q_lens = _case(7, **case)
    t = {k: (None if a is None else torch.from_numpy(a))
         for k, a in dict(q=q, kp=kp, vp=vp, tables=tables, kv=kv_lens,
                          ql=q_lens).items()}
    got = pa.paged_attention_reference(
        t["q"], t["kp"], t["vp"], t["tables"], t["kv"],
        q_lens=t["ql"]).numpy()
    jq = None if q_lens is None else jnp.asarray(q_lens)
    ref = np.asarray(jax_reference(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(kv_lens), q_lens=jq))
    pal = np.asarray(_paged_attention_pallas(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(kv_lens), q_lens=jq,
        interpret=True))
    assert got.shape == ref.shape == q.shape
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, pal, rtol=RTOL, atol=ATOL)
    g4 = got if got.ndim == 4 else got[:, None]
    dead = _dead_mask(case, g4.shape)
    assert dead.any()
    # dead rows bitwise 0 (not merely close)
    assert np.all(g4[dead] == 0.0)
    assert np.all(np.isfinite(got))


def test_router_takes_plain_version_on_cpu_and_counts_it():
    q, kp, vp, tables, kv_lens, q_lens = _case(3, **CASES["chunk_gqa2_ps16"])
    before_k = pa.counts.kernel_launches[pa.KERNEL]
    before_p = pa.counts.plain_calls[pa.KERNEL]
    args = [torch.from_numpy(a) for a in (q, kp, vp, tables, kv_lens)]
    out = pa.paged_attention(*args, q_lens=torch.from_numpy(q_lens))
    ref = pa.paged_attention_reference(*args,
                                       q_lens=torch.from_numpy(q_lens))
    assert torch.equal(out, ref)
    assert pa.counts.plain_calls[pa.KERNEL] == before_p + 1
    assert pa.counts.kernel_launches[pa.KERNEL] == before_k


def test_shape_checks_refuse_bad_layouts():
    q, kp, vp, tables, kv_lens, _ = _case(1, **CASES["single_mha_ps4"])
    args = [torch.from_numpy(a) for a in (q, kp, vp, tables, kv_lens)]
    with pytest.raises(ValueError, match="q_lens only applies"):
        pa.paged_attention(*args, q_lens=torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="requires q_lens"):
        pa.paged_attention(args[0][:, None], *args[1:])
    with pytest.raises(ValueError, match="not a multiple"):
        pa.paged_attention(args[0][:, :3], *args[1:])


def test_kernels_import_without_nvcc_and_build_fails_clearly(monkeypatch):
    """Importing the kernels starts no build; asking for a build with
    no nvcc in reach names the problem instead of a deep OSError."""
    code = ("import paddle_tpu_torch.kernels as k, "
            "paddle_tpu_torch.kernels._build as b; "
            "print(sorted(b._libs))")
    out = subprocess.run([sys.executable, "-c", code], env={"PATH": ""},
                         capture_output=True, text=True, timeout=120,
                         cwd=_build._PKG + "/..")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "NVCC_FALLBACK", "/nonexistent/nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert _build.kernel_sources() == ["conv_bn_relu", "flash_attention",
                                       "layer_norm", "paged_attention"]
