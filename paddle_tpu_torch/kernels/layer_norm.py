"""Layer norm over the trailing dims — the counterpart of
``paddle_tpu/fluid/ops/pallas_kernels/layer_norm.py`` (``fused_layer_norm``).

Two implementations of the forward over rows ``x [N, F]`` (float32 or
bfloat16; scale and bias of x's dtype):

  - ``layer_norm_reference`` — the plain PyTorch version: mean, biased
    variance of ``x - mean``, ``rstd = 1 / sqrt(var + eps)``, normalize,
    scale and bias, in float32 (bfloat16 inputs widened), ``y`` rounded
    once to x's dtype; returns ``(y, mean, rstd)``. The CPU tests run it,
    ``chip_smoke.py`` holds the kernel against it, and build-time shape
    inference runs it on ``meta`` tensors.
  - ``_layer_norm_cuda`` — the hand-written Hopper kernel (K1) in
    ``paddle_tpu_torch/csrc/layer_norm.cu``: ``layer_norm_f32``, and its
    bfloat16 form ``layer_norm_bf16``, built by ``nvcc`` at first use and
    bound with ``ctypes``.

``layer_norm_fwd`` routes on the tensor's device only: a CPU tensor takes
the plain version (counted in ``counts.plain_calls`` under the kernel of
its dtype), a CUDA tensor launches the kernel (``counts.kernel_launches``)
or raises, a ``meta`` tensor takes the plain version uncounted.

The backward is PyTorch code on every device (``layer_norm_backward``),
as the JAX package's is jnp under ``custom_vjp``: ``fused_layer_norm``
wraps the routed forward and that backward in one ``autograd.Function``.
"""
from __future__ import annotations

from typing import Optional

import torch

from .counts import LaunchCounts

__all__ = ["fused_layer_norm", "layer_norm_fwd", "layer_norm_reference",
           "layer_norm_backward", "counts", "KERNEL", "KERNEL_BF16"]

KERNEL, KERNEL_BF16 = "layer_norm_f32", "layer_norm_bf16"
counts = LaunchCounts(KERNEL, KERNEL_BF16)
# the kernel of each dtype it takes
_KERNELS = {torch.float32: KERNEL, torch.bfloat16: KERNEL_BF16}


def _check(x, scale, bias):
    if x.ndim != 2:
        raise ValueError(f"layer norm takes rows x [N, F], got "
                         f"{tuple(x.shape)}")
    f = x.shape[1]
    for name, t in (("scale", scale), ("bias", bias)):
        if tuple(t.shape) != (f,):
            raise ValueError(f"{name} {tuple(t.shape)} != ({f},)")


def layer_norm_reference(x, scale, bias, eps: float):
    """The plain version: ``(y, mean, rstd)`` of the rows of ``x [N, F]``
    in float32, the variance biased and centred (two passes, as the TPU
    kernel)."""
    _check(x, scale, bias)
    x32 = x.float()
    mean = x32.mean(dim=1, keepdim=True)
    xc = x32 - mean
    var = (xc * xc).mean(dim=1, keepdim=True)
    rstd = 1.0 / torch.sqrt(var + eps)
    y = xc * rstd * scale.float() + bias.float()
    return y.to(x.dtype), mean[:, 0], rstd[:, 0]


def _layer_norm_cuda(x, scale, bias, eps: float):
    """Launch the hand-written kernel of x's dtype. Raises on what it does
    not take: a device other than the one CUDA device of ``x``, x, scale
    and bias not of one dtype, float32 or bfloat16, a non-contiguous
    operand."""
    from ._build import launch

    _check(x, scale, bias)
    kernel = _KERNELS.get(x.dtype)
    if kernel is None or scale.dtype != x.dtype or bias.dtype != x.dtype:
        raise TypeError(f"layer norm kernel takes x, scale and bias of one "
                        f"dtype, float32 or bfloat16; got x {x.dtype}, "
                        f"scale {scale.dtype}, bias {bias.dtype}")
    for name, t in (("x", x), ("scale", scale), ("bias", bias)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"layer norm kernel needs a contiguous {name}")
    n, f = x.shape
    y = torch.empty_like(x)
    mean = torch.empty(n, dtype=torch.float32, device=x.device)
    rstd = torch.empty(n, dtype=torch.float32, device=x.device)
    launch("layer_norm", kernel, x.device, x.data_ptr(), scale.data_ptr(),
           bias.data_ptr(), y.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
           n, f, float(eps))
    counts.kernel_launches[kernel] += 1
    return y, mean, rstd


def layer_norm_fwd(x, scale, bias, eps: float):
    """Route on the device of ``x``: the plain version on the CPU (and,
    uncounted, on ``meta``), the kernel on a card — which launches or
    raises; there is no fallback."""
    kind = x.device.type
    if kind == "cuda":
        return _layer_norm_cuda(x, scale, bias, eps)
    if kind == "cpu":
        counts.plain_calls[_KERNELS.get(x.dtype, KERNEL)] += 1
    elif kind != "meta":
        raise ValueError(f"layer norm runs on cpu (plain version) or cuda "
                         f"(kernel), not {x.device}")
    return layer_norm_reference(x, scale, bias, eps)


def layer_norm_backward(x, scale, mean, rstd, dy):
    """``(dx, dscale, dbias)`` from the saved row statistics — the JAX
    package's ``_fused_ln_bwd`` formula, in PyTorch."""
    x32, dy32 = x.float(), dy.float()
    xhat = (x32 - mean[:, None]) * rstd[:, None]
    dscale = (dy32 * xhat).sum(dim=0)
    dbias = dy32.sum(dim=0)
    dxhat = dy32 * scale.float()[None, :]
    dx = (dxhat - dxhat.mean(dim=1, keepdim=True)
          - xhat * (dxhat * xhat).mean(dim=1, keepdim=True)) * rstd[:, None]
    return dx.to(x.dtype), dscale.to(scale.dtype), dbias.to(scale.dtype)


class _LayerNorm(torch.autograd.Function):
    """Forward through the router; the row statistics are outputs, not
    differentiable paths (their cotangents are ignored, as in the JAX
    package's custom_vjp)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        y, mean, rstd = layer_norm_fwd(x, scale, bias, eps)
        ctx.save_for_backward(x, scale, mean, rstd)
        ctx.mark_non_differentiable(mean, rstd)
        return y, mean, rstd

    @staticmethod
    def backward(ctx, dy, _dmean, _drstd):
        x, scale, mean, rstd = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_backward(x, scale, mean, rstd, dy)
        return dx, dscale, dbias, None


def fused_layer_norm(x, scale: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None, eps: float = 1e-5,
                     begin_norm_axis: int = 1):
    """x: any rank; normalized over dims ``[begin_norm_axis:)``. Returns
    ``(y, mean, variance)`` as the JAX package's ``fused_layer_norm``:
    mean and variance flattened over the leading dims, the variance
    rebuilt from the kernel's rstd as ``1 / rstd**2 - eps``."""
    lead = 1
    for s in x.shape[:begin_norm_axis]:
        lead *= s
    f = 1
    for s in x.shape[begin_norm_axis:]:
        f *= s
    x2 = x.reshape(lead, f).contiguous()
    if scale is None:
        scale = torch.ones(f, dtype=x.dtype, device=x.device)
    if bias is None:
        bias = torch.zeros(f, dtype=x.dtype, device=x.device)
    y, mean, rstd = _LayerNorm.apply(x2, scale.reshape(f).contiguous(),
                                     bias.reshape(f).contiguous(),
                                     float(eps))
    var = 1.0 / (rstd * rstd) - eps
    return y.reshape(x.shape), mean, var
