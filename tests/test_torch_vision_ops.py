"""The port's image and vision ops (``fluid/ops/nn_ops.py``: the conv
family, ``lrn``, ``l2_normalize``; ``tensor_ops.py``: ``pad``, ``crop``;
``vision_ops.py``: ``maxout``, the 3-D and indexed pools, ``unpool``,
``spp``, ``roi_pool``, the resizes; ``loss_ops.py``: ``smooth_l1_loss``,
``huber_loss``) against the JAX package's, on the CPU.

Each op alone on seeded numpy inputs: the outputs, and the input
gradients through the port's record-and-grad path against the JAX op's
``jax.vjp`` for seeded cotangents. The cases cover groups and dilation
for the transposes, ceil mode and both averages for ``pool3d``, an even
``n`` for ``lrn``, ``spp`` on a map smaller than its finest bins (padding
above half the window), ties for ``maxout`` and the indexed pools, and
padding that leaves a window wholly outside the map. The JAX op's
indexed pools have no gradient (a reduce over (value, position) pairs):
their gradient is held against the one their Mask implies, the cotangent
added at each window's recorded position.

Tolerances (float32; XLA and PyTorch sum in other orders): outputs rtol
1e-5 / atol 1e-6, gradients rtol 1e-4 / atol 1e-5. Index outputs exactly
equal. Under FLAGS['amp'] the conv family is held within 1 U (U = 2^-8,
the bfloat16 resolution) of the largest value, as ``conv2d`` is in
``tests/test_torch_amp.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.fluid.flags import FLAGS as JFLAGS, set_flags as jset_flags
from paddle_tpu.fluid.registry import get_op_info as jax_op_info
from paddle_tpu_torch.flags import FLAGS as TFLAGS
from paddle_tpu_torch.fluid.registry import (
    FWD_META_ATTR, EmitCtx, forward_with_grad, run_forward, run_grad)

FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
U = 2.0 ** -8


def _port_op(op_type, ins, attrs, dys):
    """Outputs, and with cotangents ``dys`` the input gradients."""
    ctx = EmitCtx(device="cpu", root_seed=1)
    tins = {s: [torch.from_numpy(np.array(v))] for s, v in ins.items()}
    if not dys:
        outs = run_forward(ctx, op_type, tins, attrs)
        return {s: v[0].numpy() for s, v in outs.items()}, {}
    outs, record = forward_with_grad(ctx, op_type, tins, attrs)
    grad_attrs = {FWD_META_ATTR: {"type": op_type, "attrs": attrs,
                                  "in_slots": list(ins),
                                  "out_slots": list(outs)}}
    gins = dict(tins)
    gins.update({"Out@" + s: v for s, v in outs.items()})
    gins.update({"GRAD@" + s: [torch.from_numpy(d)] for s, d in dys.items()})
    grads = run_grad(ctx, gins, grad_attrs, record)
    return ({s: v[0].detach().numpy() for s, v in outs.items()},
            {s[5:]: v[0].numpy() for s, v in grads.items()
             if v and v[0] is not None})


def _jax_op(op_type, ins, attrs, diff_slots, dys, jit=True):
    """The JAX op's outputs and ``jax.vjp`` gradients; ``jit=False`` runs
    it op by op (under amp a jitted block drops the bfloat16 round
    trips, ``tests/test_torch_amp.py``)."""
    fwd = jax_op_info(op_type).forward
    wrap = jax.jit if jit else (lambda f: f)

    def fn(*diffs):
        full = {s: [jnp.asarray(v)] for s, v in ins.items()}
        full.update({s: [d] for s, d in zip(diff_slots, diffs)})
        return fwd(None, full, attrs)

    primals = [jnp.asarray(ins[s]) for s in diff_slots]
    outs = {s: np.asarray(v) for s, v in wrap(fn)(*primals).items()}
    if not dys:
        return outs, {}
    _, vjp = jax.vjp(wrap(lambda *d: {s: fn(*d)[s] for s in dys}), *primals)
    grads = vjp({s: jnp.asarray(d) for s, d in dys.items()})
    return outs, dict(zip(diff_slots, (np.asarray(g) for g in grads)))


def _same(t, j, s):
    if (t.dtype, j.dtype) != (np.int64, np.int32):
        assert t.dtype == j.dtype, (s, t.dtype, j.dtype)
    assert t.shape == j.shape, (s, t.shape, j.shape)
    if t.dtype.kind in "iub":
        np.testing.assert_array_equal(t, j, err_msg=s)
    else:
        np.testing.assert_allclose(t, j, rtol=FWD_RTOL, atol=FWD_ATOL,
                                   err_msg=s)


def _cotangents(tout, out_slots, seed):
    rng = np.random.RandomState(seed + 100)
    return {s: rng.randn(*tout[s].shape).astype(np.float32)
            for s in out_slots if tout[s].dtype.kind == "f"}


def _op_parity(op_type, ins, attrs, diff_slots=(), out_slots=("Out",),
               seed=0, jit=True):
    """Both packages' op on the same inputs: ``out_slots`` within the
    output tolerance (index outputs equal), and for ``diff_slots`` the
    gradients for seeded normal cotangents on the float ``out_slots``."""
    tout0, _ = _port_op(op_type, ins, attrs, {})
    dys = _cotangents(tout0, out_slots, seed) if diff_slots else {}
    tout, tgrads = _port_op(op_type, ins, attrs, dys)
    jout, jgrads = _jax_op(op_type, ins, attrs, list(diff_slots), dys,
                           jit=jit)
    for s in out_slots:
        _same(tout[s], jout[s], s)
    for s in diff_slots:
        np.testing.assert_allclose(tgrads[s], jgrads[s], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg="grad " + s)
    return tout, tgrads


def _randn(rng, *shape, scale=1.0):
    return (scale * rng.randn(*shape)).astype(np.float32)


def _ties(rng, *shape):
    """Small integers as float32: windows and groups hold ties."""
    return rng.randint(-3, 4, shape).astype(np.float32)


# --- the conv family ----------------------------------------------------

def _conv_out(n, k, s, p, d):
    return (n + 2 * p - d * (k - 1) - 1) // s + 1


def _convt_out(n, k, s, p, d):
    return (n - 1) * s - 2 * p + d * (k - 1) + 1


# op, N, C, spatial, F, k, stride, padding, dilation, groups
CONVS = [
    ("conv2d_transpose", 2, 4, (5, 5), 6, 3, 2, 1, 1, 1),
    ("conv2d_transpose", 2, 4, (6, 5), 6, 4, 2, 1, 1, 2),
    ("conv2d_transpose", 2, 3, (5, 4), 4, 3, 1, 2, 2, 1),
    ("conv2d_transpose", 1, 6, (4, 4), 9, 3, 3, 0, 2, 3),
    ("conv3d", 2, 3, (5, 6, 6), 4, 3, 1, 1, 1, 1),
    ("conv3d", 2, 4, (6, 7, 5), 6, 3, 2, 2, 2, 2),
    ("conv3d_transpose", 2, 3, (3, 4, 4), 4, 3, 2, 1, 1, 1),
    ("conv3d_transpose", 1, 4, (3, 3, 4), 6, 2, 2, 0, 2, 2),
    ("depthwise_conv2d", 2, 4, (7, 7), 8, 3, 1, 1, 1, 4),
    ("depthwise_conv2d", 2, 3, (9, 8), 3, 5, 2, 2, 2, 3),
]


def _conv_case(case, rng):
    op, n, c, sp, f, k, s, p, d, g = case
    nd = len(sp)
    if op.endswith("transpose"):
        w = _randn(rng, c, f // g, *[k] * nd)
        out = [_convt_out(x, k, s, p, d) for x in sp]
    else:
        w = _randn(rng, f, c // g, *[k] * nd)
        out = [_conv_out(x, k, s, p, d) for x in sp]
    # depthwise: the op takes its groups from the input; the attr says 1
    attrs = {"strides": [s] * nd, "paddings": [p] * nd,
             "dilations": [d] * nd,
             "groups": 1 if op.startswith("depthwise") else g}
    ins = {"Input": _randn(rng, n, c, *sp), "Filter": w}
    return ins, attrs, [n, f] + out


@pytest.mark.parametrize("case", CONVS, ids=lambda c: "{}-n{}c{}{}f{}k{}s{}p{}d{}g{}".format(
    c[0], c[1], c[2], "x".join(map(str, c[3])), *c[4:]))
def test_conv_family_matches_jax(case):
    ins, attrs, out_shape = _conv_case(case, np.random.RandomState(7))
    out, _ = _op_parity(case[0], ins, attrs, ["Input", "Filter"],
                        ("Output",))
    assert list(out["Output"].shape) == out_shape


@pytest.fixture
def amp():
    jset_flags({"amp": True})
    TFLAGS["amp"] = True
    yield
    jset_flags({"amp": False})
    TFLAGS["amp"] = False


def _units(got, want):
    scale = float(np.abs(want).max()) or 1.0
    return float(np.abs(got - want).max()) / scale / U


@pytest.mark.parametrize("case", [CONVS[1], CONVS[5], CONVS[7], CONVS[8]],
                         ids=lambda c: c[0])
def test_conv_family_matches_jax_under_amp(case, amp):
    """Output, dInput and dFilter within 1 U of the JAX op's run op by
    op; each differs from the float32 op's."""
    assert JFLAGS["amp"]
    rng = np.random.RandomState(12)
    ins, attrs, out_shape = _conv_case(case, rng)
    dys = {"Output": _randn(rng, *out_shape)}
    tout, tgrads = _port_op(case[0], ins, attrs, dys)
    jout, jgrads = _jax_op(case[0], ins, attrs, ["Input", "Filter"], dys,
                           jit=False)
    assert tout["Output"].dtype == np.float32
    assert _units(tout["Output"], jout["Output"]) <= 1
    for s in ("Input", "Filter"):
        assert _units(tgrads[s], jgrads[s]) <= 1, s
    TFLAGS["amp"] = False
    f32, _ = _port_op(case[0], ins, attrs, {})
    assert not np.array_equal(f32["Output"], tout["Output"])


# --- lrn, l2_normalize, pad, crop, maxout, the losses ---------------------

def _cases():
    r = np.random.RandomState(3)
    x4 = _randn(r, 2, 7, 4, 5)
    return [
        ("lrn", {"X": x4}, {"n": 5, "alpha": 1e-2, "beta": 0.75}, ["X"],
         ("Out", "MidOut")),
        ("lrn", {"X": x4}, {"n": 4, "k": 1.0, "alpha": 0.1, "beta": 0.5},
         ["X"], ("Out", "MidOut")),
        ("lrn", {"X": x4}, {"n": 2, "k": 1.0, "alpha": 0.3, "beta": 1.0},
         ["X"], ("Out", "MidOut")),
        ("l2_normalize", {"X": x4}, {"axis": 1}, ["X"], ("Out", "Norm")),
        ("l2_normalize", {"X": _randn(r, 3, 6)}, {"axis": -1,
                                                  "epsilon": 1e-12},
         ["X"], ("Out", "Norm")),
        ("pad", {"X": _randn(r, 2, 3, 4)},
         {"paddings": [0, 1, 2, 0, 1, 3], "pad_value": -0.5}, ["X"],
         ("Out",)),
        ("crop", {"X": x4}, {"offsets": [0, 2, 1, 1],
                             "shape": [-1, 3, 2, -1]}, ["X"], ("Out",)),
        # offsets clamp so the window fits, as dynamic_slice's do
        ("crop", {"X": _randn(r, 3, 5)}, {"offsets": [1, 3],
                                          "shape": [2, 4]}, ["X"],
         ("Out",)),
        ("maxout", {"X": _ties(r, 2, 6, 3, 4)}, {"groups": 2}, ["X"],
         ("Out",)),
        ("maxout", {"X": _ties(r, 2, 6, 3, 4)}, {"groups": 3}, ["X"],
         ("Out",)),
        ("smooth_l1_loss", {"X": _randn(r, 4, 3, 2), "Y": _randn(r, 4, 3, 2)},
         {}, ["X", "Y"], ("Out", "Diff")),
        ("smooth_l1_loss", {"X": _randn(r, 4, 6), "Y": _randn(r, 4, 6),
                            "InsideWeight": r.rand(4, 6).astype(np.float32),
                            "OutsideWeight": r.rand(4, 6).astype(np.float32)},
         {"sigma": 3.0}, ["X", "Y"], ("Out", "Diff")),
        ("huber_loss", {"X": _randn(r, 5, 4, scale=2.0),
                        "Y": _randn(r, 5, 4)}, {}, ["X", "Y"],
         ("Out", "Residual")),
        ("huber_loss", {"X": _randn(r, 8, 3), "Y": _randn(r, 8, 3)},
         {"delta": 0.5}, ["X", "Y"], ("Out", "Residual")),
    ]


CASES = _cases()


@pytest.mark.parametrize("case", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_op_matches_jax(case):
    op, ins, attrs, diff, outs = case
    _op_parity(op, ins, attrs, diff, outs)


def test_maxout_splits_a_tie_evenly():
    """Two tied entries of a group share the gradient half and half."""
    x = np.zeros((1, 2, 1, 1), np.float32)
    _, grads = _port_op("maxout", {"X": x}, {"groups": 2},
                        {"Out": np.ones((1, 1, 1, 1), np.float32)})
    np.testing.assert_array_equal(grads["X"].reshape(-1), [0.5, 0.5])


# --- pools and resizes ----------------------------------------------------

# X shape, attrs
POOL3D = [
    ((2, 3, 5, 6, 7), {"pooling_type": "max", "ksize": [2, 2, 2],
                       "strides": [2, 2, 2]}),
    ((2, 3, 5, 6, 7), {"pooling_type": "max", "ksize": [3, 3, 2],
                       "strides": [2, 2, 2], "paddings": [1, 1, 0],
                       "ceil_mode": True}),
    ((2, 2, 6, 5, 5), {"pooling_type": "avg", "ksize": [3, 3, 3],
                       "strides": [2, 2, 2], "paddings": [1, 1, 1],
                       "exclusive": True}),
    ((2, 2, 6, 5, 5), {"pooling_type": "avg", "ksize": [3, 3, 3],
                       "strides": [2, 2, 2], "paddings": [1, 1, 1],
                       "exclusive": False}),
    ((1, 2, 5, 7, 6), {"pooling_type": "avg", "ksize": [2, 3, 3],
                       "strides": [2, 2, 2], "ceil_mode": True}),
    ((2, 3, 4, 3, 5), {"pooling_type": "avg", "global_pooling": True}),
]


@pytest.mark.parametrize("shape,attrs", POOL3D)
def test_pool3d_matches_jax(shape, attrs):
    x = _randn(np.random.RandomState(len(attrs)), *shape)
    _op_parity("pool3d", {"X": x}, attrs, ["X"])


def _mask_grad(x_shape, mask, dy):
    """The gradient the JAX op's Mask implies: each cotangent added at
    its window's flat position (none for -1)."""
    n, c = x_shape[:2]
    g = np.zeros((n, c, int(np.prod(x_shape[2:]))), np.float32)
    m, d = mask.reshape(n, c, -1), dy.reshape(n, c, -1)
    for i in range(n):
        for j in range(c):
            keep = m[i, j] >= 0
            np.add.at(g[i, j], m[i, j][keep], d[i, j][keep])
    return g.reshape(x_shape)


def _serial_mask(x, ksize, strides, paddings):
    """The reference's serial kernel (pool_with_index_op): each window
    scanned in row-major order, a strictly greater value taking over, so
    the first position of a tie wins; -1 for a window wholly in
    padding."""
    sp = x.shape[2:]
    out = [(n + 2 * p - k) // s + 1
           for n, k, s, p in zip(sp, ksize, strides, paddings)]
    mask = np.full(x.shape[:2] + tuple(out), -1, np.int32)
    for o in np.ndindex(*out):
        lo = [i * s - p for i, s, p in zip(o, strides, paddings)]
        best = np.full(x.shape[:2], -np.inf, np.float32)
        for off in np.ndindex(*ksize):
            at = [a + b for a, b in zip(lo, off)]
            if not all(0 <= a < n for a, n in zip(at, sp)):
                continue
            v = x[(slice(None), slice(None)) + tuple(at)]
            take = v > best
            best = np.where(take, v, best)
            mask[(slice(None), slice(None)) + o][take] = np.ravel_multi_index(
                at, sp)
    return mask


# op, X shape, attrs, whether XLA's reduce breaks ties in another order
INDEXED = [
    ("max_pool2d_with_index", (2, 3, 6, 7), {"ksize": [2, 2],
                                             "strides": [2, 2]}, False),
    ("max_pool2d_with_index", (2, 3, 7, 7), {"ksize": [3, 3],
                                             "strides": [2, 2],
                                             "paddings": [1, 1]}, False),
    # a window wholly in padding: -inf and Mask -1
    ("max_pool2d_with_index", (1, 2, 5, 5), {"ksize": [2, 2],
                                             "strides": [2, 2],
                                             "paddings": [2, 2]}, False),
    ("max_pool2d_with_index", (2, 2, 4, 5), {"global_pooling": True},
     False),
    ("max_pool3d_with_index", (2, 2, 4, 5, 6), {"ksize": [2, 2, 2],
                                                "strides": [2, 2, 2]},
     False),
    ("max_pool3d_with_index", (1, 2, 5, 5, 4), {"ksize": [3, 3, 3],
                                                "strides": [2, 1, 2],
                                                "paddings": [1, 1, 1]},
     False),
    # a window of 2 on the last axis, padded by 1: XLA's CPU reduce takes
    # the tie with the lowest last-axis index first here
    ("max_pool3d_with_index", (1, 2, 5, 5, 4), {"ksize": [3, 3, 2],
                                                "strides": [2, 1, 2],
                                                "paddings": [1, 1, 1]},
     True),
]


@pytest.mark.parametrize("op,shape,attrs,xla_order", INDEXED)
def test_indexed_pools_match_jax_with_ties(op, shape, attrs, xla_order):
    """Out equals the JAX op's on integer-valued maps (ties in most
    windows) and Mask the reference's serial kernel's (the first
    position of a tie), which is the JAX op's wherever XLA reduces the
    window in row-major order; the gradient is the one Mask implies.
    Where XLA's order differs, the JAX op's Mask points at another
    position of the same value (ROADMAP.md, Queue 3)."""
    x = _ties(np.random.RandomState(len(shape) + len(attrs)), *shape)
    tout, _ = _port_op(op, {"X": x}, attrs, {})
    dys = _cotangents(tout, ("Out",), 1)
    tout, tgrads = _port_op(op, {"X": x}, attrs, dys)
    jout, _ = _jax_op(op, {"X": x}, attrs, [], {})
    _same(tout["Out"], jout["Out"], "Out")
    assert tout["Mask"].dtype == jout["Mask"].dtype == np.int32
    nd = x.ndim - 2
    if attrs.get("global_pooling"):
        args = (list(shape[2:]), [1] * nd, [0] * nd)
    else:
        args = (attrs["ksize"], attrs["strides"],
                attrs.get("paddings", [0] * nd))
    np.testing.assert_array_equal(tout["Mask"], _serial_mask(x, *args))
    if xla_order:
        differ = tout["Mask"] != jout["Mask"]
        assert differ.any()
        flat = x.reshape(*shape[:2], -1)
        at = np.take_along_axis(
            flat, jout["Mask"].reshape(*shape[:2], -1).astype(np.int64),
            axis=2)
        np.testing.assert_array_equal(at.reshape(jout["Out"].shape),
                                      jout["Out"])
    else:
        _same(tout["Mask"], jout["Mask"], "Mask")
    want = _mask_grad(shape, tout["Mask"], dys["Out"])
    np.testing.assert_allclose(tgrads["X"], want, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    if attrs.get("paddings") == [2, 2]:
        assert (tout["Mask"] == -1).any()


def test_unpool_matches_jax():
    """Values and positions from a non-overlapping indexed pool (the JAX
    test's setting: ``set`` on a repeated position has no order)."""
    rng = np.random.RandomState(4)
    x = _randn(rng, 2, 3, 8, 6)
    pool = _port_op("max_pool2d_with_index", {"X": x},
                    {"ksize": [2, 2], "strides": [2, 2]}, {})[0]
    _op_parity("unpool", {"X": pool["Out"], "Indices": pool["Mask"]},
               {"ksize": [2, 2], "strides": [2, 2]}, ["X"])


@pytest.mark.parametrize("shape,height,ptype", [
    ((2, 3, 8, 8), 3, "max"), ((2, 3, 7, 5), 3, "avg"),
    ((1, 2, 3, 3), 3, "max"), ((1, 2, 3, 2), 3, "avg")])
def test_spp_matches_jax(shape, height, ptype):
    """The 3x3 and 3x2 maps pool 4x4 bins with windows of 1 padded by 1
    (above half the window)."""
    x = _randn(np.random.RandomState(shape[2]), *shape)
    _op_parity("spp", {"X": x}, {"pyramid_height": height,
                                 "pooling_type": ptype}, ["X"])


@pytest.mark.parametrize("pooled,scale", [((3, 2), 0.5), ((2, 2), 1.0),
                                          ((4, 3), 0.25)])
def test_roi_pool_matches_jax(pooled, scale):
    """ROIs with half-integer edges (rounded half to even), one past the
    map's edge and a degenerate one; Argmax all zero. The JAX op runs op
    by op: jitted, XLA turns the bin size's division by 3 into a product
    with 1/3, which moves a bin edge at pooled width 3 (the op's code
    divides, as the port does)."""
    rng = np.random.RandomState(6)
    x = _randn(rng, 2, 3, 12, 10)
    s = 1.0 / scale
    rois = np.array([[0, 1, 2, 7, 9], [1, 0, 0, 9, 11], [1, 2.5, 3.5, 5.5, 6.5],
                     [0, 6, 8, 14, 15], [1, 4, 4, 4, 4]],
                    np.float32) * np.array([1, s, s, s, s], np.float32)
    out, _ = _op_parity("roi_pool", {"X": x, "ROIs": rois},
                        {"pooled_height": pooled[0],
                         "pooled_width": pooled[1], "spatial_scale": scale},
                        ["X"], ("Out", "Argmax"), jit=False)
    assert not out["Argmax"].any()


@pytest.mark.parametrize("op", ["bilinear_interp", "nearest_interp"])
@pytest.mark.parametrize("shape,out", [((2, 3, 4, 5), (7, 9)),
                                       ((2, 2, 9, 6), (4, 3)),
                                       ((1, 2, 1, 5), (3, 1)),
                                       ((1, 2, 6, 4), (6, 12))])
def test_resizes_match_jax(op, shape, out):
    x = _randn(np.random.RandomState(sum(out)), *shape)
    _op_parity(op, {"X": x}, {"out_h": out[0], "out_w": out[1]}, ["X"])
