"""K5's bfloat16 form (conv_bn_relu_bf16) on the CPU: its arithmetic and
its plan (paddle_tpu_torch/kernels/conv_bn_relu.py:_plan).

The CUDA kernels run only on a card (chip_smoke.py's amp kernels phase
holds them against the plain version there, and k5_bf16_vs_old.py
against the previous kernel). Here:

  - test_k5_bf16_arithmetic_emulated runs the kernel's fixed summation
    order in float32 on the CPU: the wgmma bodies' k-steps of 16 in k
    order, accumulated in place over each split of K, the split partials
    added in split order by the combine's plain version, the epilogue's
    two roundings and one rounding to bfloat16; the mma.sync body's
    slices of 32 k in two k-groups at the stem and strided shapes. Each k-step's 16
    products are summed exactly and rounded once to float32 (the tensor
    core's truncating sums are not modelled). It must land within one
    bfloat16 ulp of the output's max of the JAX kernel under amp (its
    Pallas kernel in interpret mode, bfloat16 x and w) and give an
    image's output bitwise the same at batch 4 and alone;
  - test_plan_is_a_function_of_the_shape pins the plan of the 20
    convolutions of a ResNet-50 forward: the same body, splits and tile
    at N in {1, 2, 4, 8, 16}, the values in PLANS, and the stem (K = 147)
    on the mma.sync body, which needs no 16-byte weight rows.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.fluid.ops.pallas_kernels import conv_bn_relu as jk5
from paddle_tpu_torch.kernels import conv_bn_relu as k5


def _inputs(seed, shape, f, k):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    w = (rng.randn(f, shape[1], k, k) / np.sqrt(shape[1] * k * k)) \
        .astype(np.float32)
    scale = (rng.rand(f) + 0.5).astype(np.float32)
    shift = (rng.randn(f) * 0.1).astype(np.float32)
    return x, w, scale, shift


def _steps(p, wt, ks, acc):
    """acc + the products of the k-steps of 16 in ``ks`` (k order), each
    step's 16 products summed exactly and added in float32."""
    for k0 in ks:
        part = p[:, k0:k0 + 16] @ wt[:, k0:k0 + 16].T  # float64: exact
        acc = (acc.double() + part).float()
    return acc


def _epilogue(z, scale, shift, relu):
    z = z * scale.float()
    z = z + shift.float()
    return torch.clamp_min(z, 0.0) if relu else z


def _k5_bf16_emulated(x, w, scale, shift, stride, padding, relu):
    """conv_bn_relu_bf16's arithmetic for the plan of this shape:
    bfloat16 NCHW y."""
    n, c, h, wd = x.shape
    f, _, kh, kw = w.shape
    oh, ow = k5.conv_out_hw(h, wd, kh, kw, stride, padding)
    plan = k5.plan_for(x.shape, w.shape, stride, padding)
    p = k5._patches(x.float(), kh, kw, stride, padding).double()
    wt = w.float().reshape(f, -1).double()
    m, kk = p.shape
    if plan.body == "mma":
        # slices of 32 k, slice s to k-group s % 2; a slice's two k-steps
        # in a fresh fragment, added to its group; group 1 added to 0
        pad = -kk % 32
        p, wt = (torch.nn.functional.pad(a, (0, pad)) for a in (p, wt))
        acc = [torch.zeros(m, f), torch.zeros(m, f)]
        for s in range((kk + pad) // 32):
            frag = _steps(p, wt, (32 * s, 32 * s + 16), torch.zeros(m, f))
            acc[s % 2] = acc[s % 2] + frag
        y = _epilogue(acc[0] + acc[1], scale, shift, relu)
        return y.reshape(n, oh, ow, f).permute(0, 3, 1, 2).bfloat16()
    # stages of 64 k; split s takes stages [s T / S, (s + 1) T / S)
    t = -(-kk // k5.STAGE_K)
    pad = t * k5.STAGE_K - kk
    p, wt = (torch.nn.functional.pad(a, (0, pad)) for a in (p, wt))
    parts = []
    for s in range(plan.splits):
        lo, hi = s * t // plan.splits, (s + 1) * t // plan.splits
        parts.append(_steps(p, wt, range(lo * 64, hi * 64, 16),
                            torch.zeros(m, f)))
    ws = torch.zeros(plan.splits, f, -(-m // 4) * 4)
    for s, part in enumerate(parts):
        ws[s, :, :m] = part.T
    return k5.split_combine_reference(ws, scale, shift, n, oh, ow, relu)


# (x shape, F, k, stride, padding, relu, body): the stem (K = 147) and a
# strided 3x3 (the mma.sync body), a 1x1 with K = 512 (the 1x1 body, K
# split in two) and a padded 3x3 at stride 1 (the gather body)
K5_BF16_EMULATED = [((4, 3, 30, 30), 8, 7, 2, 3, True, "mma"),
                    ((4, 8, 9, 9), 12, 3, 2, 0, True, "mma"),
                    ((4, 512, 7, 7), 32, 1, 1, 0, False, "1x1"),
                    ((4, 16, 9, 9), 24, 3, 1, 1, True, "gather")]


@pytest.mark.parametrize("case", range(len(K5_BF16_EMULATED)),
                         ids=["stem", "3x3s2", "1x1split", "3x3"])
def test_k5_bf16_arithmetic_emulated(case):
    """The bf16 kernel's order of sums stays within one bf16 ulp of the
    output's max of the JAX kernel under amp, and an image's output is
    bitwise the same at batch 4 and alone."""
    shape, f, k, stride, padding, relu, body = K5_BF16_EMULATED[case]
    arrs = _inputs(11 + case, shape, f, k)
    xb, wb = (torch.from_numpy(a).bfloat16() for a in arrs[:2])
    sc, sh = (torch.from_numpy(a) for a in arrs[2:])
    plan = k5.plan_for(xb.shape, wb.shape, stride, padding)
    assert plan.body == body
    assert (plan.splits > 1) == (body == "1x1")
    got = _k5_bf16_emulated(xb, wb, sc, sh, stride, padding, relu)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jk5.fused_conv_bn_relu(
        jnp.asarray(arrs[0], jnp.bfloat16), jnp.asarray(arrs[1], jnp.bfloat16),
        jnp.asarray(arrs[2]), jnp.asarray(arrs[3]), stride=stride,
        padding=padding, relu=relu, block_m=32, interpret=True)
    ).astype(np.float32)
    vmax = float(np.abs(want).max())
    ulp = 2.0 ** (math.floor(math.log2(vmax)) - 7)
    err = float(np.abs(got.float().numpy() - want).max())
    assert got.shape == want.shape and err <= ulp, (err, ulp)
    alone = _k5_bf16_emulated(xb[1:2], wb, sc, sh, stride, padding, relu)
    assert torch.equal(got[1:2], alone)


# ResNet-50's 20 distinct fused convolutions (C, H, W, F, k, stride,
# padding) and the plan of each: (body, splits, bn)
PLANS = {
    (3, 224, 224, 64, 7, 2, 3): ("mma", 1, 64),
    (64, 56, 56, 256, 1, 1, 0): ("1x1", 1, 128),
    (64, 56, 56, 64, 1, 1, 0): ("1x1", 1, 64),
    (64, 56, 56, 64, 3, 1, 1): ("gather", 1, 64),
    (256, 56, 56, 64, 1, 1, 0): ("1x1", 1, 64),
    (256, 56, 56, 512, 1, 2, 0): ("mma", 1, 64),
    (256, 56, 56, 128, 1, 2, 0): ("mma", 1, 64),
    (128, 28, 28, 128, 3, 1, 1): ("gather", 1, 128),
    (128, 28, 28, 512, 1, 1, 0): ("1x1", 1, 128),
    (512, 28, 28, 128, 1, 1, 0): ("1x1", 1, 128),
    (512, 28, 28, 1024, 1, 2, 0): ("mma", 1, 64),
    (512, 28, 28, 256, 1, 2, 0): ("mma", 1, 64),
    (256, 14, 14, 256, 3, 1, 1): ("gather", 2, 128),
    (256, 14, 14, 1024, 1, 1, 0): ("1x1", 1, 128),
    (1024, 14, 14, 256, 1, 1, 0): ("1x1", 2, 128),
    (1024, 14, 14, 2048, 1, 2, 0): ("mma", 1, 64),
    (1024, 14, 14, 512, 1, 2, 0): ("mma", 1, 64),
    (512, 7, 7, 512, 3, 1, 1): ("gather", 4, 128),
    (512, 7, 7, 2048, 1, 1, 0): ("1x1", 1, 128),
    (2048, 7, 7, 512, 1, 1, 0): ("1x1", 5, 128),
}


@pytest.mark.parametrize("conv", sorted(PLANS), ids=lambda c: "c{}h{}w{}f{}k{}s{}p{}".format(*c))
def test_plan_is_a_function_of_the_shape(conv):
    """The plan of each ResNet-50 convolution is the same at every batch
    and is the pinned one; K = 147 (no whole 16-byte weight rows) takes
    the mma.sync body."""
    c, h, w, f, k, stride, padding = conv
    plans = {n: tuple(k5.plan_for((n, c, h, w), (f, c, k, k), stride,
                                  padding)) for n in (1, 2, 4, 8, 16)}
    assert set(plans.values()) == {PLANS[conv]}
    if (c * k * k) % 8:
        assert PLANS[conv][0] == "mma"
