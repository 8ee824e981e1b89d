"""Fused conv2d + folded batch norm + relu — the counterpart of
``paddle_tpu/fluid/ops/pallas_kernels/conv_bn_relu.py``
(``fused_conv_bn_relu``, ``fold_bn``).

``y = act(conv2d(x, w, stride, padding) * scale + shift)`` in NCHW, with
``scale``/``shift`` the frozen batch-norm statistics folded into one
per-output-channel affine (``fold_bn``) and ``act`` relu or the
identity. Two implementations of the forward, for float32 ``x``/``w``
and for bfloat16 ``x``/``w`` (``FLAGS['amp']``; ``scale``/``shift`` stay
float32):

  - ``fused_conv_bn_relu_reference`` — the plain PyTorch version, what
    the TPU kernel computes: im2col with ``F.unfold`` in the channel-major
    patch order of the JAX ``_patches`` (``P [M, K]``, ``M = N*OH*OW``,
    ``K = C*KH*KW``), then ``P @ Wt``, then ``* scale + shift``, then
    relu, all on the float32 accumulator (bfloat16 operands upcast
    exactly), then one rounding to ``x``'s dtype. The CPU tests run it,
    ``chip_smoke.py`` holds the kernels against it, and build-time shape
    inference runs it on ``meta`` tensors.
  - ``_conv_cuda`` — the hand-written Hopper kernels (K5) in
    ``paddle_tpu_torch/csrc/conv_bn_relu.cu``: ``conv_bn_relu_f32``
    (3xTF32) for float32 and ``conv_bn_relu_bf16`` (bf16 ``mma.sync``,
    float32 accumulation, a bfloat16 output) for bfloat16, implicit GEMMs
    that gather their patch tiles straight from ``x``; built by ``nvcc``
    at first use and bound with ``ctypes``.

``fused_conv_bn_relu_fwd`` routes on the tensor's device only: a CPU
tensor takes the plain version (counted in ``counts.plain_calls`` under
the kernel of its dtype), a CUDA tensor launches the kernel of its dtype
(``counts.kernel_launches``) or raises, a ``meta`` tensor takes the
plain version uncounted.

The backward is PyTorch code on every device, as the JAX package's is
jnp under ``custom_vjp`` (``_fused_conv_bwd``): one shared GEMM
``A = Pᵀ·dZ`` gives both the weight and the scale cotangents, and dx goes
through the adjoint of unfold (``F.fold``), with ``dP`` rounded to the
patches' dtype first, as the JAX backward rounds it.
``fused_conv_bn_relu`` wraps the routed forward and that backward in one
``autograd.Function``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .counts import LaunchCounts

__all__ = ["fused_conv_bn_relu", "fused_conv_bn_relu_fwd",
           "fused_conv_bn_relu_reference", "fused_conv_bn_relu_backward",
           "fold_bn", "conv_out_hw", "counts", "KERNEL", "KERNEL_BF16",
           "kernel_for"]

KERNEL = "conv_bn_relu_f32"
KERNEL_BF16 = "conv_bn_relu_bf16"
# the kernel of each operand dtype
_KERNELS = {torch.float32: KERNEL, torch.bfloat16: KERNEL_BF16}
counts = LaunchCounts(KERNEL, KERNEL_BF16)


def kernel_for(x, w):
    """The kernel's name for operands ``x``/``w``: float32 or bfloat16,
    the same for both; raises for any other dtype."""
    name = _KERNELS.get(x.dtype)
    if name is None or w.dtype != x.dtype:
        raise TypeError(f"fused conv kernels take float32 or bfloat16 x "
                        f"and w of one dtype, got {x.dtype} and {w.dtype}")
    return name


def conv_out_hw(h: int, w: int, kh: int, kw: int, stride: int,
                padding: int):
    """Output spatial size of the convolution."""
    return ((h + 2 * padding - kh) // stride + 1,
            (w + 2 * padding - kw) // stride + 1)


def _check(x, w, scale, shift):
    if x.ndim != 4 or w.ndim != 4 or x.shape[1] != w.shape[1]:
        raise ValueError(f"fused conv takes x [N, C, H, W] and w [F, C, KH, "
                         f"KW]; got {tuple(x.shape)}, {tuple(w.shape)}")
    f = w.shape[0]
    for name, t in (("scale", scale), ("shift", shift)):
        if tuple(t.shape) != (f,):
            raise ValueError(f"{name} {tuple(t.shape)} != ({f},)")


def _patches(x, kh: int, kw: int, stride: int, padding: int):
    """im2col: [N, C, H, W] -> [N*OH*OW, C*kh*kw], channel-major patch
    order (matches ``w.reshape(F, C*kh*kw)``), as the JAX ``_patches``."""
    p = F.unfold(x, (kh, kw), padding=padding, stride=stride)  # [N, K, L]
    return p.transpose(1, 2).reshape(-1, p.shape[1])


def fused_conv_bn_relu_reference(x, w, scale, shift, stride: int,
                                 padding: int, relu: bool):
    """The plain version: im2col GEMM in float32, the affine and relu on
    the accumulator, back to NCHW in x's dtype."""
    _check(x, w, scale, shift)
    n, _, h, wd = x.shape
    f, _, kh, kw = w.shape
    oh, ow = conv_out_hw(h, wd, kh, kw, stride, padding)
    p = _patches(x.float(), kh, kw, stride, padding)
    acc = p @ w.float().reshape(f, -1).T
    acc = acc * scale.float() + shift.float()
    if relu:
        acc = torch.clamp_min(acc, 0.0)
    return acc.reshape(n, oh, ow, f).permute(0, 3, 1, 2).to(x.dtype)


def _conv_cuda(x, w, scale, shift, stride: int, padding: int, relu: bool):
    """Launch the hand-written kernel of the operands' dtype:
    ``conv_bn_relu_f32`` for float32 ``x``/``w``, ``conv_bn_relu_bf16``
    (a bfloat16 ``y``) for bfloat16 ones; ``scale``/``shift`` are float32
    for both. Raises on what they do not take: a device other than the
    one CUDA device of ``x``, another dtype, a non-contiguous operand."""
    from ._build import launch

    _check(x, w, scale, shift)
    kernel = kernel_for(x, w)
    for name, t in (("x", x), ("w", w), ("scale", scale), ("shift", shift)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused conv kernel needs a contiguous {name}")
    for name, t in (("scale", scale), ("shift", shift)):
        if t.dtype != torch.float32:
            raise TypeError(f"fused conv kernels take float32 {name}, got "
                            f"{t.dtype}")
    n, c, h, wd = x.shape
    f, _, kh, kw = w.shape
    oh, ow = conv_out_hw(h, wd, kh, kw, stride, padding)
    y = torch.empty((n, f, oh, ow), dtype=x.dtype, device=x.device)
    launch("conv_bn_relu", kernel, x.device, x.data_ptr(), w.data_ptr(),
           scale.data_ptr(), shift.data_ptr(), y.data_ptr(), n, c, h, wd, f,
           kh, kw, int(stride), int(padding), oh, ow, int(bool(relu)))
    counts.kernel_launches[kernel] += 1
    return y


def fused_conv_bn_relu_fwd(x, w, scale, shift, stride: int, padding: int,
                           relu: bool):
    """Route on the device of ``x``: the plain version on the CPU (and,
    uncounted, on ``meta``), the kernel on a card — which launches or
    raises; there is no fallback."""
    kind = x.device.type
    if kind == "cuda":
        return _conv_cuda(x, w, scale, shift, stride, padding, relu)
    if kind == "cpu":
        counts.plain_calls[_KERNELS.get(x.dtype, KERNEL)] += 1
    elif kind != "meta":
        raise ValueError(f"fused conv runs on cpu (plain version) or cuda "
                         f"(kernel), not {x.device}")
    return fused_conv_bn_relu_reference(x, w, scale, shift, stride, padding,
                                        relu)


def fused_conv_bn_relu_backward(x, w, scale, y, dy, stride: int,
                                padding: int, relu: bool):
    """``(dx, dw, dscale, dshift)`` — the JAX package's ``_fused_conv_bwd``
    in PyTorch. One shared GEMM ``A = Pᵀ·dZ [K, F]`` gives
    ``dW = A * scale`` and ``dscale = sum_k Wt * A`` (the forward GEMM is
    never recomputed); ``dx`` folds ``dP = dZ·scale·W``, rounded to x's
    dtype as the JAX backward rounds it (``dp.astype(p.dtype)``), back
    through the adjoint of unfold in float32, and rounds once more at the
    end. For float32 operands both roundings are the identity."""
    n, _, h, wd = x.shape
    f, _, kh, kw = w.shape
    dz = dy.float()
    if relu:
        dz = dz * (y > 0)
    dz = dz.permute(0, 2, 3, 1).reshape(-1, f)
    p = _patches(x.float(), kh, kw, stride, padding)
    wt = w.float().reshape(f, -1).T
    s32 = scale.float()
    a = p.T @ dz
    dscale = (wt * a).sum(dim=0)
    dshift = dz.sum(dim=0)
    dw = (a * s32[None, :]).T.reshape(w.shape)
    dp = ((dz * s32[None, :]) @ wt.T).to(x.dtype).float()  # [M, K]
    k = dp.shape[1]
    dx = F.fold(dp.reshape(n, -1, k).transpose(1, 2), (h, wd), (kh, kw),
                padding=padding, stride=stride)
    return (dx.to(x.dtype), dw.to(w.dtype), dscale.to(scale.dtype),
            dshift.to(scale.dtype))


class _FusedConv(torch.autograd.Function):
    """Forward through the router; the backward of the JAX custom_vjp."""

    @staticmethod
    def forward(ctx, x, w, scale, shift, stride, padding, relu):
        y = fused_conv_bn_relu_fwd(x, w, scale, shift, stride, padding, relu)
        ctx.save_for_backward(x, w, scale, y)
        ctx.conf = (stride, padding, relu)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, scale, y = ctx.saved_tensors
        dx, dw, dscale, dshift = fused_conv_bn_relu_backward(
            x, w, scale, y, dy, *ctx.conf)
        return dx, dw, dscale, dshift, None, None, None


def fused_conv_bn_relu(x, w, scale: Optional[torch.Tensor] = None,
                       shift: Optional[torch.Tensor] = None, stride: int = 1,
                       padding: int = 0, relu: bool = True):
    """y = relu(conv2d(x, w, stride, padding) * scale + shift), NCHW.

    scale/shift are the FOLDED inference-bn parameters per output channel
    (``fold_bn``); None means identity (plain conv, or conv + bias with
    shift). Differentiable in x, w, scale and shift."""
    f = w.shape[0]
    if scale is None:
        scale = torch.ones(f, dtype=torch.float32, device=w.device)
    if shift is None:
        shift = torch.zeros(f, dtype=torch.float32, device=w.device)
    return _FusedConv.apply(x.contiguous(), w.contiguous(),
                            scale.reshape(f).contiguous(),
                            shift.reshape(f).contiguous(), int(stride),
                            int(padding), bool(relu))


def fold_bn(gamma, beta, mean, var, eps: float = 1e-5):
    """Fold frozen batch-norm statistics into the per-channel affine the
    kernel's epilogue applies (the reference's conv+bn fusion rewrite)."""
    gamma, beta, mean, var = (torch.as_tensor(t).float()
                              for t in (gamma, beta, mean, var))
    rstd = torch.rsqrt(var + eps)
    scale = gamma * rstd
    shift = beta - mean * scale
    return scale, shift
