"""Flash attention, forward and backward — the counterpart of
``paddle_tpu/fluid/ops/pallas_kernels/flash_attention.py``
(``flash_attention``).

Kernel-level functions work on ``[BH, S, D]`` float32 (batch and heads
folded, as the TPU kernels' grid does); ``flash_attention`` takes the
``[B, S, H, D]`` layout of ``layers.ring_attention`` and is an
``autograd.Function`` whose backward launches the two backward kernels.

Two implementations of each pass:

  - plain PyTorch versions: ``flash_attention_fwd_reference`` (dense
    softmax in float32, returns ``O`` and the row ``LSE``) and
    ``flash_attention_bwd_reference`` (the dense formulas for dQ, dK,
    dV from the saved LSE). The CPU tests run them, ``chip_smoke.py``
    holds the kernels against them, shape inference runs them on
    ``meta`` tensors;
  - hand-written Hopper kernels in
    ``paddle_tpu_torch/csrc/flash_attention.cu``: ``flash_fwd_f32``
    (K2), ``flash_bwd_dkdv_f32`` (K3a) and ``flash_bwd_dq_f32`` (K3b),
    built by ``nvcc`` at first use and bound with ``ctypes``.

The routers ``flash_attention_fwd`` and ``flash_attention_bwd`` route on
the tensor's device only: a CPU tensor takes the plain version (counted
in ``counts.plain_calls``), a CUDA tensor launches the kernels
(``counts.kernel_launches``, per kernel) or raises, a ``meta`` tensor
takes the plain version uncounted.

Causal masking keeps key ``t`` for query row ``i`` when ``t <= i``
(absolute positions, also when ``Sq != Sk``), as the TPU kernels do.
"""
from __future__ import annotations

from typing import Optional

import torch

from .counts import LaunchCounts

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_fwd_reference", "flash_attention_bwd_reference",
           "counts", "FWD", "BWD_DKDV", "BWD_DQ", "MAX_HEAD_DIM", "NEG_INF"]

NEG_INF = -1e30
FWD, BWD_DKDV, BWD_DQ = "flash_fwd_f32", "flash_bwd_dkdv_f32", \
    "flash_bwd_dq_f32"
# head_dim bound of the kernels (the largest head_dim bucket, 128)
MAX_HEAD_DIM = 128
counts = LaunchCounts(FWD, BWD_DKDV, BWD_DQ)


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
    """The plain forward: dense softmax in float32. Returns ``(O, LSE)``,
    O ``[BH, Sq, D]`` in q's dtype, LSE ``[BH, Sq]`` float32. A row with
    no visible key gives O = 0 and LSE ~ -1e30, as the TPU kernel."""
    _check(q, k, v)
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
    causal masking removed a key."""
    _check(q, k, v)
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


def _check_cuda(**ts):
    dev = next(iter(ts.values())).device
    for name, t in ts.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, not {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"flash attention kernels take float32 {name}, "
                            f"got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash attention kernels need a contiguous, "
                             f"16-byte aligned {name}")
    d = ts["q"].shape[-1]
    if d > MAX_HEAD_DIM or d % 4:
        raise ValueError(f"flash attention kernels take head_dim <= "
                         f"{MAX_HEAD_DIM} and a multiple of 4, got {d}")
    return dev


def _fwd_cuda(q, k, v, causal: bool, scale: float):
    from ._build import launch

    _check(q, k, v)
    dev = _check_cuda(q=q, k=k, v=v)
    bh, sq, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=dev)
    launch("flash_attention", FWD, dev, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), o.data_ptr(), lse.data_ptr(), bh, sq, k.shape[1],
           d, int(causal), float(scale))
    counts.kernel_launches[FWD] += 1
    return o, lse


def _bwd_dkdv_cuda(q, k, v, dout, lse, delta, causal: bool, scale: float):
    from ._build import launch

    _check(q, k, v)
    dev = _check_cuda(q=q, k=k, v=v, dout=dout, lse=lse, delta=delta)
    bh, sq, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    launch("flash_attention", BWD_DKDV, dev, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
           dk.data_ptr(), dv.data_ptr(), bh, sq, k.shape[1], d,
           int(causal), float(scale))
    counts.kernel_launches[BWD_DKDV] += 1
    return dk, dv


def _bwd_dq_cuda(q, k, v, dout, lse, delta, causal: bool, scale: float):
    from ._build import launch

    _check(q, k, v)
    dev = _check_cuda(q=q, k=k, v=v, dout=dout, lse=lse, delta=delta)
    bh, sq, d = q.shape
    dq = torch.empty_like(q)
    launch("flash_attention", BWD_DQ, dev, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
           dq.data_ptr(), bh, sq, k.shape[1], d, int(causal), float(scale))
    counts.kernel_launches[BWD_DQ] += 1
    return dq


def _plain_route(t, *kernels) -> bool:
    """True when ``t`` takes the plain version (cpu counted, meta not);
    False for a CUDA tensor; raises for any other device."""
    kind = t.device.type
    if kind == "cuda":
        return False
    if kind == "cpu":
        for name in kernels:
            counts.plain_calls[name] += 1
    elif kind != "meta":
        raise ValueError(f"flash attention runs on cpu (plain version) or "
                         f"cuda (kernels), not {t.device}")
    return True


def flash_attention_fwd(q, k, v, causal: bool, scale: float):
    """``(O, LSE)`` of ``[BH, S, D]`` inputs: the plain version on the
    CPU, the K2 kernel on a card (launches or raises)."""
    if _plain_route(q, FWD):
        return flash_attention_fwd_reference(q, k, v, causal, scale)
    return _fwd_cuda(q, k, v, causal, scale)


def flash_attention_bwd(q, k, v, dout, lse, delta, causal: bool,
                        scale: float):
    """``(dQ, dK, dV)``: the plain version on the CPU; on a card the K3a
    kernel (dK, dV), then the K3b kernel (dQ)."""
    if _plain_route(q, BWD_DKDV, BWD_DQ):
        return flash_attention_bwd_reference(q, k, v, dout, lse, delta,
                                             causal, scale)
    dk, dv = _bwd_dkdv_cuda(q, k, v, dout, lse, delta, causal, scale)
    dq = _bwd_dq_cuda(q, k, v, dout, lse, delta, causal, scale)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """[BH, S, D] attention; saves q, k, v, O and LSE for the backward,
    which computes delta = rowsum(dO * O) and launches K3a then K3b."""

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
        delta = (dout.float() * o.float()).sum(dim=-1)
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
