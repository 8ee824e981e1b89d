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
    (3xTF32) for float32 and ``conv_bn_relu_bf16`` (float32
    accumulation, a bfloat16 output) for bfloat16, implicit GEMMs that
    gather their patch tiles straight from ``x``; built by ``nvcc`` at
    first use and bound with ``ctypes``. The bfloat16 kernel follows a
    plan (``_plan``), a pure function of the convolution's shape without
    its batch: the body (``wgmma`` with TMA weight tiles,
    ``csrc/conv_wgmma.cuh``, at stride 1; else the ``mma.sync`` body), a
    split of K into S parts whose float32 partials
    ``conv_split_combine_bf16`` adds in split order, and the output tile.

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

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .counts import LaunchCounts

__all__ = ["fused_conv_bn_relu", "fused_conv_bn_relu_fwd",
           "fused_conv_bn_relu_reference", "fused_conv_bn_relu_backward",
           "fold_bn", "conv_out_hw", "counts", "KERNEL", "KERNEL_BF16",
           "KERNEL_COMBINE", "kernel_for", "Plan", "plan_for",
           "split_combine_reference"]

KERNEL = "conv_bn_relu_f32"
KERNEL_BF16 = "conv_bn_relu_bf16"
# the bfloat16 kernel's split-K combine: launched after it when its plan
# splits K
KERNEL_COMBINE = "conv_split_combine_bf16"
# the kernel of each operand dtype
_KERNELS = {torch.float32: KERNEL, torch.bfloat16: KERNEL_BF16}
counts = LaunchCounts(KERNEL, KERNEL_BF16, KERNEL_COMBINE)


class Plan(NamedTuple):
    """How ``conv_bn_relu_bf16`` computes one convolution shape."""
    body: str    # "mma" (mma.sync), "gather" or "1x1" (wgmma + TMA)
    splits: int  # K cut into this many parts, combined in split order
    bn: int      # output channels of a 64-row tile


# the C entry's body codes
BODIES = ("mma", "gather", "1x1")
# K of one pipeline stage of the wgmma bodies (four k-steps of 16)
STAGE_K = 64
# the split rule's yardstick: blocks of a batch of this many images in
# one wave of two blocks on each of the H100's 132 SMs, each split at
# least PLAN_MIN_STAGES stages deep. A constant, not the batch: the plan
# never sees N
PLAN_IMAGES = 16
PLAN_SLOTS = 2 * 132
PLAN_MIN_STAGES = 4


def _m_tiles(n: int, oh: int, ow: int, body: str) -> int:
    """Output tiles of 64 rows along m, as the wgmma bodies cut them:
    "1x1" 64 consecutive m; "gather" 64 // Wb whole output rows of Wb
    columns (Wb the least power of two >= OW, at least 8), or 64 columns
    of one row where OW > 64."""
    if body == "1x1":
        return -(-n * oh * ow // 64)
    if ow > 64:
        return n * oh * -(-ow // 64)
    wb = max(8, 1 << (ow - 1).bit_length())
    return -(-n * oh // (64 // wb))


def _plan(c: int, h: int, w: int, f: int, kh: int, kw: int, stride: int,
          padding: int) -> Plan:
    """The bfloat16 kernel's plan for a convolution of this shape: a pure
    function of (C, H, W, F, KH, KW, stride, padding), never of the batch
    N or of M = N*OH*OW, so that every output sums its K products in one
    order whatever batch its image is served in.

    - Stride 1 and K (= C*KH*KW) a multiple of 8 (whole 16-byte weight
      rows for TMA): a ``wgmma`` body, ``1x1`` (flat tiles, 16-byte patch
      loads) for a 1x1 without padding, else ``gather`` (tiles of whole
      output rows).
    - Anything else: the ``mma.sync`` body: the stem (K = 147) and the
      strided 1x1 reductions and projections, two of which ran slower on
      a wgmma gather of whole output rows (PERF.md).
    - Tile 64 (m) x 128 (f), 64 x 64 for F <= 64 (and the mma.sync body).
    - Splits: as many as keep each split PLAN_MIN_STAGES stages of 64 k
      deep and PLAN_IMAGES images' blocks within one wave of PLAN_SLOTS
      (res4/res5, where M is small and K long)."""
    k = c * kh * kw
    if k % 8 or stride != 1:
        return Plan("mma", 1, 64)
    body = "1x1" if (kh, kw, padding) == (1, 1, 0) else "gather"
    bn = 128 if f > 64 else 64
    oh, ow = conv_out_hw(h, w, kh, kw, stride, padding)
    tiles = _m_tiles(PLAN_IMAGES, oh, ow, body) * -(-f // bn)
    stages = -(-k // STAGE_K)
    splits = max(1, min(stages // PLAN_MIN_STAGES, PLAN_SLOTS // tiles))
    return Plan(body, splits, bn)


def plan_for(x_shape, w_shape, stride: int, padding: int) -> Plan:
    """The plan of x [N, C, H, W] and w [F, C, KH, KW] (their shapes):
    ``_plan`` of everything but N."""
    _, c, h, w = x_shape
    f, _, kh, kw = w_shape
    return _plan(int(c), int(h), int(w), int(f), int(kh), int(kw),
                 int(stride), int(padding))


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
    if kernel == KERNEL:
        launch("conv_bn_relu", kernel, x.device, x.data_ptr(), w.data_ptr(),
               scale.data_ptr(), shift.data_ptr(), y.data_ptr(), n, c, h, wd,
               f, kh, kw, int(stride), int(padding), oh, ow, int(bool(relu)))
        counts.kernel_launches[kernel] += 1
        return y
    plan = plan_for(x.shape, w.shape, stride, padding)
    if plan.body != "mma" and w.data_ptr() % 16:
        w = w.clone()  # a TMA map starts 16-byte aligned
    # the wgmma bodies index x and m in 32 bits: a batch beyond that runs
    # in chunks of whole images (each image's output is the same alone)
    step = n
    if plan.body != "mma":
        step = max(1, min((2 ** 31 - 1) // (c * h * wd),
                          (2 ** 31 - 256) // (oh * ow)))
    for lo in range(0, n, step):
        _launch_bf16(x[lo:lo + step], w, scale, shift, y[lo:lo + step], plan,
                     int(stride), int(padding), int(bool(relu)))
    return y


def _launch_bf16(x, w, scale, shift, y, plan: Plan, stride: int,
                 padding: int, relu: int):
    """``conv_bn_relu_bf16`` on one chunk of images, then, when the plan
    splits K, ``conv_split_combine_bf16`` on its partials (a float32
    workspace of [splits, F, M rounded up to 4])."""
    from ._build import launch

    n, c, h, wd = x.shape
    f, _, kh, kw = w.shape
    oh, ow = y.shape[2:]
    m = n * oh * ow
    ws = None
    if plan.splits > 1:
        ws = torch.empty(plan.splits * f * (-(-m // 4) * 4),
                         dtype=torch.float32, device=x.device)
    launch("conv_bn_relu", KERNEL_BF16, x.device, x.data_ptr(), w.data_ptr(),
           scale.data_ptr(), shift.data_ptr(), y.data_ptr(),
           None if ws is None else ws.data_ptr(), n, c, h, wd, f, kh, kw,
           stride, padding, oh, ow, relu, BODIES.index(plan.body),
           plan.splits, plan.bn)
    counts.kernel_launches[KERNEL_BF16] += 1
    if ws is not None:
        _combine_launch(ws, scale, shift, y, m, f, oh * ow, plan.splits,
                        relu)


def _combine_launch(ws, scale, shift, y, m: int, f: int, ohw: int,
                    splits: int, relu: int):
    from ._build import launch

    launch("conv_bn_relu", KERNEL_COMBINE, y.device, ws.data_ptr(),
           scale.data_ptr(), shift.data_ptr(), y.data_ptr(), m, f, ohw,
           splits, relu)
    counts.kernel_launches[KERNEL_COMBINE] += 1


def split_combine_reference(ws, scale, shift, n: int, oh: int, ow: int,
                            relu: bool):
    """The plain version of ``conv_split_combine_bf16``: ``ws`` [S, F,
    Mpad] float32 partials summed in split order (partial 0 + partial 1
    + ...), ``* scale + shift`` and relu, rounded once to bfloat16, as
    NCHW ``[n, F, oh, ow]`` (the first M = n*oh*ow of each row)."""
    m = n * oh * ow
    acc = ws[0, :, :m].float()
    for s in range(1, ws.shape[0]):
        acc = acc + ws[s, :, :m].float()
    acc = acc * scale.float()[:, None] + shift.float()[:, None]
    if relu:
        acc = torch.clamp_min(acc, 0.0)
    return acc.reshape(-1, n, oh, ow).permute(1, 0, 2, 3).bfloat16() \
        .contiguous()


def _combine_cuda(ws, scale, shift, n: int, oh: int, ow: int, relu: bool):
    """Launch ``conv_split_combine_bf16`` alone on ``ws`` [S, F, Mpad]
    float32 (what a split launch of ``conv_bn_relu_bf16`` leaves): the
    bfloat16 y [n, F, oh, ow]."""
    s, f, mpad = ws.shape
    m = n * oh * ow
    if ws.dtype != torch.float32 or not ws.is_contiguous() or \
            mpad != -(-m // 4) * 4 or ws.device.type != "cuda":
        raise ValueError(f"combine takes contiguous float32 partials "
                         f"[S, F, {-(-m // 4) * 4}] on a card, got "
                         f"{ws.dtype} {tuple(ws.shape)} on {ws.device}")
    y = torch.empty((n, f, oh, ow), dtype=torch.bfloat16, device=ws.device)
    _combine_launch(ws, scale, shift, y, m, f, oh * ow, s, int(bool(relu)))
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
