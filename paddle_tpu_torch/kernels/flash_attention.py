"""Flash attention, forward and backward — the counterpart of
``paddle_tpu/fluid/ops/pallas_kernels/flash_attention.py``
(``flash_attention``).

Kernel-level functions work on ``[BH, S, D]`` float32 or bfloat16 (batch
and heads folded, as the TPU kernels' grid does); ``flash_attention``
takes the ``[B, S, H, D]`` layout of ``layers.ring_attention`` and is an
``autograd.Function`` whose backward launches the two backward kernels.

Two implementations of each pass:

  - plain PyTorch versions: ``flash_attention_fwd_reference`` (returns
    ``O`` and the row ``LSE``) and ``flash_attention_bwd_reference``
    (dQ, dK, dV from the saved LSE). The CPU tests run them,
    ``chip_smoke.py`` holds the kernels against them, shape inference
    runs them on ``meta`` tensors. On float32 they are the dense
    formulas in float32. On bfloat16 they compute the TPU kernels'
    bfloat16 branch (``lowp``), which is another function: products of
    bfloat16 operands summed in float32, an online softmax whose running
    max moves at ``BLOCK_K`` = 128-key boundaries, P rounded to bfloat16
    before P V and dV, dS rounded to bfloat16 before dK and dQ, O, dQ,
    dK and dV rounded once to bfloat16, LSE float32;
  - hand-written Hopper kernels, built by ``nvcc`` at first use and
    bound with ``ctypes``: in ``paddle_tpu_torch/csrc/flash_attention.cu``
    ``flash_fwd_f32`` (K2), ``flash_bwd_dkdv_f32`` (K3a) and
    ``flash_bwd_dq_f32`` (K3b); in
    ``paddle_tpu_torch/csrc/flash_attention_bf16.cuh`` (built into the
    same library) their bfloat16 forms ``flash_fwd_bf16``,
    ``flash_bwd_dkdv_bf16`` and ``flash_bwd_dq_bf16``. They take every
    head_dim: up to 128 on the tensor cores (3xTF32, or bf16
    ``mma.sync``), above that on CUDA cores (``csrc/flash_wide.cuh``;
    above 256 each block computes one 256-column slice of the output); a
    head_dim that is not a multiple of 4 (float32) or 8 (bfloat16) is
    zero-padded to one (``pad_head_dim``, exact). The bfloat16 forward
    and backward up to head_dim 64 run on ``wgmma`` fed by TMA
    (``csrc/flash_fwd_wgmma.cuh``, ``csrc/flash_bwd_wgmma.cuh``).

The backward's ``delta = rowsum(dO * O)`` (float32) is one pass too:
``flash_delta`` (``csrc/flash_delta.cuh``, in the same library) on a
card, ``flash_delta_reference`` on the CPU; it counts in
``counts_delta``. It stands for the JAX ``_flash_bwd``'s jnp line, which
XLA fuses; it replaces no TPU kernel.

The routers ``flash_attention_fwd`` and ``flash_attention_bwd`` route on
the tensor's device only: a CPU tensor takes the plain version (counted
in ``plain_calls``), a CUDA tensor launches the kernels
(``kernel_launches``, per kernel) or raises, a ``meta`` tensor takes the
plain version uncounted. The float32 kernels count in ``counts``, the
bfloat16 ones in ``counts_bf16``.

Causal masking keeps key ``t`` for query row ``i`` when ``t <= i``
(absolute positions, also when ``Sq != Sk``), as the TPU kernels do.
"""
from __future__ import annotations

from typing import Optional

import torch

from .counts import LaunchCounts

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_fwd_reference", "flash_attention_bwd_reference",
           "counts", "counts_bf16", "FWD", "BWD_DKDV", "BWD_DQ", "FWD_BF16",
           "BWD_DKDV_BF16", "BWD_DQ_BF16", "BLOCK_K", "NEG_INF",
           "flash_delta", "flash_delta_reference", "counts_delta", "DELTA"]

NEG_INF = -1e30
FWD, BWD_DKDV, BWD_DQ = "flash_fwd_f32", "flash_bwd_dkdv_f32", \
    "flash_bwd_dq_f32"
FWD_BF16, BWD_DKDV_BF16, BWD_DQ_BF16 = "flash_fwd_bf16", \
    "flash_bwd_dkdv_bf16", "flash_bwd_dq_bf16"
counts = LaunchCounts(FWD, BWD_DKDV, BWD_DQ)
counts_bf16 = LaunchCounts(FWD_BF16, BWD_DKDV_BF16, BWD_DQ_BF16)
DELTA = "flash_delta"
counts_delta = LaunchCounts(DELTA)
# the bfloat16 forward's softmax block: the JAX flash_attention's default
# block_k, the one layers.ring_attention runs (a shorter key sequence is
# one block)
BLOCK_K = 128


def _causal_keep(sq: int, sk: int, device):
    return (torch.arange(sq, device=device)[:, None]
            >= torch.arange(sk, device=device)[None, :])


def _check(q, k, v):
    if q.ndim != 3 or k.ndim != 3 or k.shape != v.shape or \
            q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"flash attention takes q [BH, Sq, D] and k, v "
                         f"[BH, Sk, D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")


def flash_attention_fwd_reference(q, k, v, causal: bool, scale: float):
    """The plain forward. Returns ``(O, LSE)``, O ``[BH, Sq, D]`` in q's
    dtype, LSE ``[BH, Sq]`` float32. float32: a dense softmax in float32;
    bfloat16: the TPU kernel's bfloat16 function (``_fwd_bf16``). A row
    with no visible key gives O = 0 and LSE ~ -1e30, as the TPU kernel."""
    _check(q, k, v)
    if q.dtype == torch.bfloat16:
        return _fwd_bf16(q, k, v, causal, scale)
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    keep = _causal_keep(q.shape[1], k.shape[1], q.device) if causal \
        else None
    if keep is not None:
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if keep is not None:
        p = p * keep
    l = p.sum(dim=-1, keepdim=True).clamp(min=torch.finfo(torch.float32).tiny)
    o = torch.matmul(p, v.float()) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_attention_bwd_reference(q, k, v, dout, lse, delta, causal: bool,
                                  scale: float):
    """The plain backward: ``(dQ, dK, dV)`` from the saved LSE and
    ``delta = rowsum(dO * O)``, with P recomputed densely and zeroed where
    causal masking removed a key (bfloat16: ``_bwd_bf16``)."""
    _check(q, k, v)
    if q.dtype == torch.bfloat16:
        return _bwd_bf16(q, k, v, dout, lse, delta, causal, scale)
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), dout.float()
    s = torch.matmul(q32, k32.transpose(1, 2)) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        p = p * _causal_keep(q.shape[1], k.shape[1], q.device)
    dv = torch.matmul(p.transpose(1, 2), do32)
    dp = torch.matmul(do32, v32.transpose(1, 2))
    ds = p * (dp - delta[..., None])
    dq = torch.matmul(ds, k32) * scale
    dk = torch.matmul(ds.transpose(1, 2), q32) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bf16(x):
    """x rounded to bfloat16 (to nearest even) and widened back: what the
    TPU kernel's ``astype(bfloat16)`` feeds a product."""
    return x.to(torch.bfloat16).float()


def _fwd_bf16(q, k, v, causal: bool, scale: float):
    """The TPU forward kernel's bfloat16 branch, block by block: scores of
    the widened operands (exact products, float32 sums), an online softmax
    over key blocks of ``BLOCK_K`` with the running max and sum in
    float32, P = exp(s - m_new) rounded to bfloat16 for P V (the sum l
    adds the unrounded P), O rounded once to bfloat16, LSE float32."""
    bh, sq, d = q.shape
    q32, k32, v32 = q.float(), k.float(), v.float()
    m = torch.full((bh, sq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((bh, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((bh, sq, d), dtype=torch.float32, device=q.device)
    for t0 in range(0, k.shape[1], BLOCK_K):
        kb, vb = k32[:, t0:t0 + BLOCK_K], v32[:, t0:t0 + BLOCK_K]
        s = torch.matmul(q32, kb.transpose(1, 2)) * scale
        keep = None
        if causal:
            keep = (torch.arange(sq, device=q.device)[:, None]
                    >= torch.arange(t0, t0 + kb.shape[1],
                                    device=q.device)[None, :])
            s = torch.where(keep, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        if keep is not None:
            p = torch.where(keep, p, torch.zeros_like(p))
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(_bf16(p), vb)
        m = m_new
    l = l.clamp(min=torch.finfo(torch.float32).tiny)
    return (acc / l).to(torch.bfloat16), (m + torch.log(l))[..., 0]


def _bwd_bf16(q, k, v, dout, lse, delta, causal: bool, scale: float):
    """The TPU backward kernels' bfloat16 branch: P = exp(s - LSE), zeroed
    where masked, rounded to bfloat16 for dV only; dS = P (dP - delta) in
    float32, rounded to bfloat16 for dK and dQ; dK and dQ scaled, then
    every gradient rounded once to bfloat16."""
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), dout.float()
    s = torch.matmul(q32, k32.transpose(1, 2)) * scale
    p = torch.exp(s - lse[..., None])
    if causal:
        p = torch.where(_causal_keep(q.shape[1], k.shape[1], q.device), p,
                        torch.zeros_like(p))
    dv = torch.matmul(_bf16(p).transpose(1, 2), do32)
    dp = torch.matmul(do32, v32.transpose(1, 2))
    ds = _bf16(p * (dp - delta[..., None]))
    dq = torch.matmul(ds, k32) * scale
    dk = torch.matmul(ds.transpose(1, 2), q32) * scale
    return (dq.to(torch.bfloat16), dk.to(torch.bfloat16),
            dv.to(torch.bfloat16))


def _check_cuda(lse=None, delta=None, **ts):
    """The device of q, k, v (and dout): one dtype, float32 or bfloat16,
    contiguous, 16-byte aligned; lse and delta float32."""
    dtype = next(iter(ts.values())).dtype
    if dtype not in (torch.float32, torch.bfloat16) or \
            any(t.dtype != dtype for t in ts.values()):
        raise TypeError(
            f"flash attention kernels take {', '.join(ts)} of one dtype, "
            f"float32 or bfloat16; got "
            + ", ".join(f"{n} {t.dtype}" for n, t in ts.items()))
    for name, t in (("lse", lse), ("delta", delta)):
        if t is not None:
            if t.dtype != torch.float32:
                raise TypeError(f"flash attention kernels take float32 "
                                f"{name}, got {t.dtype}")
            ts[name] = t
    dev = next(iter(ts.values())).device
    for name, t in ts.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, not {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash attention kernels need a contiguous, "
                             f"16-byte aligned {name}")
    return dev


def pad_head_dim(*ts):
    """The kernels stage rows with 16-byte copies, so head_dim must be a
    multiple of 4 float32 or 8 bfloat16 values: zero columns are appended
    up to the next multiple. This is exact: a zero column adds exact
    zeros to every dot product (q.k, dO.v) and to delta = rowsum(dO * O),
    and the padded output columns are sliced away. ``scale`` always comes
    from the true head_dim (the caller passes it)."""
    d = ts[0].shape[-1]
    pad = -d % (16 // ts[0].element_size())
    if pad == 0:
        return ts
    return tuple(torch.nn.functional.pad(t, (0, pad)) for t in ts)


def _unpad(d, *ts):
    return tuple(t if t.shape[-1] == d else t[..., :d].contiguous()
                 for t in ts)


def _fwd_cuda(q, k, v, causal: bool, scale: float):
    from ._build import launch

    _check(q, k, v)
    dev = _check_cuda(q=q, k=k, v=v)
    name = _counts(q).names[0]
    bh, sq, d = q.shape
    q, k, v = pad_head_dim(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=dev)
    launch("flash_attention", name, dev, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), o.data_ptr(), lse.data_ptr(), bh, sq, k.shape[1],
           q.shape[-1], int(causal), float(scale))
    _counts(q).kernel_launches[name] += 1
    return _unpad(d, o)[0], lse


def _bwd_dkdv_cuda(q, k, v, dout, lse, delta, causal: bool, scale: float):
    from ._build import launch

    _check(q, k, v)
    dev = _check_cuda(q=q, k=k, v=v, dout=dout, lse=lse, delta=delta)
    name = _counts(q).names[1]
    bh, sq, d = q.shape
    q, k, v, dout = pad_head_dim(q, k, v, dout)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    launch("flash_attention", name, dev, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
           dk.data_ptr(), dv.data_ptr(), bh, sq, k.shape[1], q.shape[-1],
           int(causal), float(scale))
    _counts(q).kernel_launches[name] += 1
    return _unpad(d, dk, dv)


def _bwd_dq_cuda(q, k, v, dout, lse, delta, causal: bool, scale: float):
    from ._build import launch

    _check(q, k, v)
    dev = _check_cuda(q=q, k=k, v=v, dout=dout, lse=lse, delta=delta)
    name = _counts(q).names[2]
    bh, sq, d = q.shape
    q, k, v, dout = pad_head_dim(q, k, v, dout)
    dq = torch.empty_like(q)
    launch("flash_attention", name, dev, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
           dq.data_ptr(), bh, sq, k.shape[1], q.shape[-1], int(causal),
           float(scale))
    _counts(q).kernel_launches[name] += 1
    return _unpad(d, dq)[0]


def _counts(t) -> LaunchCounts:
    """The tally of ``t``'s kernels, whose names are the (forward, dK/dV,
    dQ) kernels: ``counts_bf16`` for bfloat16, else ``counts``."""
    return counts_bf16 if t.dtype == torch.bfloat16 else counts


def _plain_route(t, *kernels) -> bool:
    """True when ``t`` takes the plain version (cpu counted, meta not);
    False for a CUDA tensor; raises for any other device. ``kernels``
    are indices into the (forward, dK/dV, dQ) names of t's dtype."""
    kind = t.device.type
    if kind == "cuda":
        return False
    if kind == "cpu":
        tally = _counts(t)
        for i in kernels:
            tally.plain_calls[tally.names[i]] += 1
    elif kind != "meta":
        raise ValueError(f"flash attention runs on cpu (plain version) or "
                         f"cuda (kernels), not {t.device}")
    return True


def flash_attention_fwd(q, k, v, causal: bool, scale: float):
    """``(O, LSE)`` of ``[BH, S, D]`` inputs: the plain version on the
    CPU, the K2 kernel of their dtype on a card (launches or raises)."""
    if _plain_route(q, 0):
        return flash_attention_fwd_reference(q, k, v, causal, scale)
    return _fwd_cuda(q, k, v, causal, scale)


def flash_attention_bwd(q, k, v, dout, lse, delta, causal: bool,
                        scale: float):
    """``(dQ, dK, dV)``: the plain version on the CPU; on a card the K3a
    kernel (dK, dV), then the K3b kernel (dQ)."""
    if _plain_route(q, 1, 2):
        return flash_attention_bwd_reference(q, k, v, dout, lse, delta,
                                             causal, scale)
    dk, dv = _bwd_dkdv_cuda(q, k, v, dout, lse, delta, causal, scale)
    dq = _bwd_dq_cuda(q, k, v, dout, lse, delta, causal, scale)
    return dq, dk, dv


def flash_delta_reference(dout, o):
    """The plain delta: ``rowsum(dO * O)`` in float32 over the last dim
    (bfloat16 inputs widened, so each product is exact)."""
    return (dout.float() * o.float()).sum(dim=-1)


def _delta_cuda(dout, o):
    from ._build import launch

    if dout.shape != o.shape:
        raise ValueError(f"flash delta takes dout and o of one shape; got "
                         f"{tuple(dout.shape)}, {tuple(o.shape)}")
    dev = _check_cuda(dout=dout, o=o)
    dout, o = pad_head_dim(dout, o)
    d = dout.shape[-1]
    delta = torch.empty(dout.shape[:-1], dtype=torch.float32, device=dev)
    launch("flash_attention", DELTA, dev, dout.data_ptr(), o.data_ptr(),
           delta.data_ptr(), delta.numel(), d,
           int(dout.dtype == torch.bfloat16))
    counts_delta.kernel_launches[DELTA] += 1
    return delta


def flash_delta(dout, o):
    """``delta = rowsum(dO * O)``, float32, of the backward: the plain
    version on the CPU (counted) and on ``meta`` (uncounted), the
    ``flash_delta`` kernel on a card (launches or raises)."""
    kind = dout.device.type
    if kind == "cuda":
        return _delta_cuda(dout, o)
    if kind == "cpu":
        counts_delta.plain_calls[DELTA] += 1
    elif kind != "meta":
        raise ValueError(f"flash delta runs on cpu (plain version) or cuda "
                         f"(kernel), not {dout.device}")
    return flash_delta_reference(dout, o)


class _Flash(torch.autograd.Function):
    """[BH, S, D] attention; saves q, k, v, O and LSE for the backward,
    which computes delta = rowsum(dO * O) (``flash_delta``) and launches
    K3a then K3b."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = flash_delta(dout, o)
        dq, dk, dv = flash_attention_bwd(q, k, v, dout, lse, delta,
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None):
    """q/k/v: ``[B, S, H, D]`` (the layout of ``layers.ring_attention``).
    Returns ``[B, Sq, H, D]``; differentiable in q, k and v."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = float(scale) if scale else d ** -0.5

    def to_bhsd(x, s):
        return x.permute(0, 2, 1, 3).reshape(b * h, s, d).contiguous()

    out = _Flash.apply(to_bhsd(q, sq), to_bhsd(k, sk), to_bhsd(v, sk),
                       bool(causal), scale)
    return out.reshape(b, h, sq, d).permute(0, 2, 1, 3)
