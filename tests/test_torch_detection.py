"""The port's SSD detection ops (``fluid/ops/detection_ops.py``) and layers
(``fluid/layers/detection.py``) against the JAX package's, on the CPU.

  (a) the port's modules register the slice's 27 op types more, 180 in
      all;
  (b) each detection op alone on seeded numpy inputs, with tied scores
      and similarities, ``nms_eta`` < 1, ``per_prediction`` matching,
      both ``ap_type``s and the difficult flag. The JAX ops run op by op
      (jitted, XLA turns a division by a constant into a product with its
      reciprocal, which the ops' code does not state);
  (c) an SSD program at ``tests/test_detection_layers.py``'s sizes (32x32
      images, a small conv backbone, ``multi_box_head`` over three maps,
      ``ssd_loss``, SGD) built in both packages, the JAX startup's
      parameters copied across: 3 steps, then ``detection_output`` and
      ``detection_map`` on the trained state.

Tolerances: indices, labels, kept detections and mask-like outputs
exactly equal (an int64 of the port may meet the int32 the JAX package
computes without x64); boxes from the priors, the coder and IoU within
rtol 1e-6 (exp, log and the division order are each package's own);
mAP within 2 float32 ulps: the port sums in float64 and rounds once
(exact, so card and CPU agree bitwise), XLA sums float32 in an order of
its own. SSD losses within rtol 2e-5 (the Transformer test's
LOSS_RTOL; observed bitwise); detections after training: labels equal,
scores and boxes within rtol 1e-6 (softmax and exp round apart by an
ulp).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.fluid.registry import OPS as JAX_OPS
from paddle_tpu.fluid.registry import get_op_info as jax_op_info
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import layers as tlayers
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.fluid.registry import OPS, EmitCtx, run_forward

BOX_RTOL, BOX_ATOL = 1e-6, 1e-7
MAP_ULPS = 2
LOSS_RTOL = 2e-5
DET_RTOL = 1e-6
JAX = (jfluid, jlayers, junique)
PORT = (tfluid, tlayers, tunique)

# the op types this slice adds to the port
NEW_OPS = {
    "depthwise_conv2d", "conv3d", "conv2d_transpose", "conv3d_transpose",
    "lrn", "l2_normalize", "pad", "crop", "maxout", "pool3d",
    "max_pool2d_with_index", "max_pool3d_with_index", "unpool", "spp",
    "roi_pool", "bilinear_interp", "nearest_interp", "iou_similarity",
    "prior_box", "box_coder", "bipartite_match", "target_assign",
    "mine_hard_examples", "multiclass_nms", "detection_map", "huber_loss",
    "smooth_l1_loss",
}
OPS_BEFORE = 153  # op types the port's own modules registered before
# op types the later slices registered: 32 of the rest of Fluid
# (tests/test_torch_fluid_rest.py holds them), 3 of the mesh layer
# (tests/test_torch_mesh.py), 2 of the pipeline region
# (tests/test_torch_pipeline.py)
OPS_AFTER = 32 + 3 + 2


def test_a_registry_gains_the_slice_op_types():
    """Counted over the port's own modules (other test files register
    probe ops of their own in a worker's process)."""
    own = {t for t, info in OPS.items()
           if info.forward.__module__.startswith("paddle_tpu_torch.")}
    assert len(NEW_OPS) == 27
    assert NEW_OPS <= set(JAX_OPS)
    assert NEW_OPS <= own, sorted(NEW_OPS - own)
    assert len(own) == OPS_BEFORE + len(NEW_OPS) + OPS_AFTER == 217


def _port(op, ins, attrs):
    ctx = EmitCtx(device="cpu", root_seed=1)
    outs = run_forward(ctx, op, {s: [torch.from_numpy(np.array(v))]
                                 for s, v in ins.items()}, attrs)
    return {s: v[0].numpy() for s, v in outs.items()}


def _jax(op, ins, attrs):
    outs = jax_op_info(op).forward(
        None, {s: [jnp.asarray(v)] for s, v in ins.items()}, attrs)
    return {s: np.asarray(v) for s, v in outs.items()}


def _check(op, ins, attrs, exact=(), close=(), ulps=()):
    t, j = _port(op, ins, attrs), _jax(op, ins, attrs)
    for s in exact + close + ulps:
        if (t[s].dtype, j[s].dtype) != (np.int64, np.int32):
            assert t[s].dtype == j[s].dtype, (s, t[s].dtype, j[s].dtype)
        assert t[s].shape == j[s].shape, (s, t[s].shape, j[s].shape)
    for s in exact:
        np.testing.assert_array_equal(t[s], j[s], err_msg=s)
    for s in close:
        np.testing.assert_allclose(t[s], j[s], rtol=BOX_RTOL, atol=BOX_ATOL,
                                   err_msg=s)
    for s in ulps:
        np.testing.assert_array_max_ulp(t[s], j[s], maxulp=MAP_ULPS)
    return t, j


def _boxes(rng, *lead, lo=0.0, hi=1.0):
    """Valid (xmin, ymin, xmax, ymax) boxes."""
    a = rng.uniform(lo, hi, lead + (2,)).astype(np.float32)
    wh = rng.uniform(0.05, 0.5, lead + (2,)).astype(np.float32)
    return np.concatenate([a, a + wh], axis=-1).astype(np.float32)


# --- (b) each op ------------------------------------------------------

@pytest.mark.parametrize("batched", [False, True])
def test_b_iou_similarity_matches_jax(batched):
    rng = np.random.RandomState(1)
    x = _boxes(rng, *((3, 5) if batched else (5,)))
    y = _boxes(rng, 7)
    y[2] = x.reshape(-1, 4)[0]  # an IoU of exactly 1
    _check("iou_similarity", {"X": x, "Y": y}, {}, close=("Out",))


PRIOR_ATTRS = [
    {"min_sizes": [8.0], "max_sizes": [16.0], "aspect_ratios": [2.0],
     "flip": True},
    {"min_sizes": [30.0, 60.0], "aspect_ratios": [2.0, 3.0, 1.0],
     "flip": False, "clip": True, "variances": [0.1, 0.1, 0.2, 0.2]},
    {"min_sizes": [20.0], "max_sizes": [45.0], "aspect_ratios": [1.0, 2.0],
     "flip": True, "clip": True, "step_w": 8.0, "step_h": 6.0,
     "offset": 0.25},
]


@pytest.mark.parametrize("attrs", PRIOR_ATTRS)
def test_b_prior_box_matches_jax(attrs):
    feat = np.zeros((1, 4, 5, 6), np.float32)
    image = np.zeros((1, 3, 37, 45), np.float32)
    t, _ = _check("prior_box", {"Input": feat, "Image": image}, attrs,
                  exact=("Variances",), close=("Boxes",))
    assert t["Boxes"].shape[:2] == (5, 6)


def _coder_cases():
    r = np.random.RandomState(2)
    prior = _boxes(r, 6)
    pvar = np.tile(np.array([0.1, 0.1, 0.2, 0.2], np.float32), (6, 1))
    return [
        ({"PriorBox": prior, "PriorBoxVar": pvar, "TargetBox": _boxes(r, 4)},
         {"code_type": "encode_center_size"}),
        ({"PriorBox": prior, "PriorBoxVar": pvar,
          "TargetBox": _boxes(r, 3, 6)}, {"code_type": "encode_center_size"}),
        ({"PriorBox": prior * 30, "TargetBox": _boxes(r, 4) * 30},
         {"code_type": "encode_center_size", "box_normalized": False}),
        ({"PriorBox": prior, "PriorBoxVar": pvar,
          "TargetBox": (0.5 * r.randn(3, 6, 4)).astype(np.float32)},
         {"code_type": "decode_center_size"}),
        ({"PriorBox": prior * 30, "PriorBoxVar": pvar,
          "TargetBox": (0.5 * r.randn(6, 4)).astype(np.float32)},
         {"code_type": "decode_center_size", "box_normalized": False}),
    ]


@pytest.mark.parametrize("case", range(5))
def test_b_box_coder_matches_jax(case):
    ins, attrs = _coder_cases()[case]
    _check("box_coder", ins, attrs, close=("OutputBox",))


@pytest.mark.parametrize("match_type", ["bipartite", "per_prediction"])
@pytest.mark.parametrize("batched", [False, True])
def test_b_bipartite_match_matches_jax_with_ties(match_type, batched):
    """Similarities on a coarse grid: equal maxima are common, and the
    first in row-major order wins in both; one all-zero row matches
    nothing."""
    rng = np.random.RandomState(3)
    d = (rng.randint(0, 6, (3, 4, 9)) / 5.0).astype(np.float32)
    d[:, 2] = 0.0
    d = d if batched else d[0]
    t, _ = _check("bipartite_match", {"DistMat": d},
                  {"match_type": match_type, "dist_threshold": 0.3},
                  exact=("ColToRowMatchIndices", "ColToRowMatchDist"))
    assert t["ColToRowMatchIndices"].dtype == np.int32
    assert (t["ColToRowMatchIndices"] == -1).any()


@pytest.mark.parametrize("with_neg", [False, True])
@pytest.mark.parametrize("kind", ["label", "box"])
def test_b_target_assign_matches_jax(with_neg, kind):
    rng = np.random.RandomState(4)
    b, m, p = 2, 3, 8
    x = (rng.randint(1, 5, (b, m, 1)).astype(np.int64) if kind == "label"
         else _boxes(rng, b, m))
    ins = {"X": x, "MatchIndices": rng.randint(-1, m, (b, p)).astype(
        np.int32)}
    if with_neg:
        ins["NegIndices"] = np.array([[0, 5, -1, -1], [7, 7, 2, -1]],
                                     np.int32)
    _check("target_assign", ins, {"mismatch_value": 0 if kind == "label"
                                  else 0},
           exact=("Out", "OutWeight"))


@pytest.mark.parametrize("extra", [(), ("MatchDist",), ("MatchDist",
                                                        "LocLoss")])
def test_b_mine_hard_examples_matches_jax_with_ties(extra):
    """Losses on a coarse grid (ties among the negatives: the lower index
    first, as ``jnp.argsort``)."""
    rng = np.random.RandomState(5)
    b, p = 3, 12
    ins = {"ClsLoss": (rng.randint(0, 4, (b, p)) / 2.0).astype(np.float32),
           "MatchIndices": np.where(rng.rand(b, p) < 0.25,
                                    rng.randint(0, 3, (b, p)),
                                    -1).astype(np.int32)}
    if "MatchDist" in extra:
        ins["MatchDist"] = rng.rand(b, p).astype(np.float32)
    if "LocLoss" in extra:
        ins["LocLoss"] = (rng.randint(0, 3, (b, p)) / 4.0).astype(np.float32)
    t, _ = _check("mine_hard_examples", ins,
                  {"neg_pos_ratio": 2.0, "neg_dist_threshold": 0.5},
                  exact=("NegIndices", "UpdatedMatchIndices"))
    assert (t["NegIndices"] >= 0).any()


NMS_ATTRS = [
    {"score_threshold": 0.05, "nms_threshold": 0.3, "nms_top_k": 6,
     "keep_top_k": 10},
    # eta < 1 shrinks the threshold after each kept box
    {"score_threshold": 0.01, "nms_threshold": 0.7, "nms_top_k": 9,
     "keep_top_k": 7, "nms_eta": 0.8},
    # keep_top_k above the C' x k candidates: padded rows
    {"score_threshold": 0.2, "nms_threshold": 0.45, "nms_top_k": 3,
     "keep_top_k": 20, "background_label": 2},
]


@pytest.mark.parametrize("attrs", NMS_ATTRS)
def test_b_multiclass_nms_matches_jax_with_ties(attrs):
    """Boxes clustered so they overlap; scores on a coarse grid, so equal
    scores meet in one class and across classes."""
    rng = np.random.RandomState(6)
    b, c, p = 2, 4, 10
    boxes = _boxes(rng, b, p, hi=0.4)
    scores = (rng.randint(0, 8, (b, c, p)) / 8.0).astype(np.float32)
    t, _ = _check("multiclass_nms", {"BBoxes": boxes, "Scores": scores},
                  attrs, exact=("Out",))
    assert t["Out"].shape == (b, attrs["keep_top_k"], 6)
    assert (t["Out"][..., 0] >= 0).any()
    if attrs["keep_top_k"] > (c - 1) * attrs["nms_top_k"]:
        assert (t["Out"][..., 0] == -1).any()


def _map_case(rng, label_cols):
    b, d, g, classes = 3, 8, 4, 4
    gt = np.full((b, g, label_cols), -1.0, np.float32)
    det = np.full((b, d, 6), -1.0, np.float32)
    for i in range(b):
        n = rng.randint(2, g + 1)
        gt[i, :n, 0] = rng.randint(1, classes, n)
        gt[i, :n, 1:5] = _boxes(rng, n)
        if label_cols == 6:
            gt[i, :n, 5] = rng.rand(n) < 0.3
        k = rng.randint(4, d + 1)
        src = rng.randint(0, n, k)
        det[i, :k, 0] = np.where(rng.rand(k) < 0.8, gt[i, src, 0],
                                 rng.randint(1, classes, k))
        det[i, :k, 1] = rng.randint(1, 9, k) / 8.0  # tied scores
        jitter = rng.uniform(-0.06, 0.06, (k, 4)).astype(np.float32)
        det[i, :k, 2:6] = gt[i, src, 1:5] + jitter
    return {"DetectRes": det, "Label": gt}, classes


@pytest.mark.parametrize("ap_type", ["integral", "11point"])
@pytest.mark.parametrize("label_cols,difficult", [(6, True), (6, False),
                                                  (5, True)])
def test_b_detection_map_matches_jax(ap_type, label_cols, difficult):
    ins, classes = _map_case(np.random.RandomState(7), label_cols)
    t, _ = _check("detection_map", ins,
                  {"ap_type": ap_type, "class_num": classes,
                   "overlap_threshold": 0.5,
                   "evaluate_difficult": difficult},
                  exact=("AccumPosCount", "AccumTruePos", "AccumFalsePos"),
                  ulps=("MAP",))
    assert 0 < float(t["MAP"][0]) < 1


# --- (c) the SSD program ----------------------------------------------

N, G, C = 2, 3, 4
HW = 32


def _ssd_program(pkg, lr=0.05):
    """A 32x32 SSD: three conv stages (16, 8, 4), ``multi_box_head`` over
    the three maps, ``ssd_loss`` with the prior variances, SGD; the
    ``detection_output`` / ``detection_map`` program shares the
    parameters (the test clone, taken before minimize)."""
    fluid, layers, unique_name = pkg
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with unique_name.guard(), fluid.program_guard(main, startup):
        img = layers.data(name="img", shape=[3, HW, HW], dtype="float32")
        gt_box = layers.data(name="gt_box", shape=[G, 4], dtype="float32")
        gt_label = layers.data(name="gt_label", shape=[G], dtype="int64")
        gt = layers.data(name="gt", shape=[G, 6], dtype="float32")
        x = img
        maps = []
        for ch in (8, 16, 16):
            x = layers.conv2d(x, num_filters=ch, filter_size=3, padding=1,
                              act="relu")
            x = layers.pool2d(x, pool_size=2, pool_stride=2)
            maps.append(x)
        loc, conf, box, var = layers.multi_box_head(
            maps, img, base_size=HW, num_classes=C,
            aspect_ratios=[[2.0], [2.0], [2.0]], min_ratio=20,
            max_ratio=90, flip=True)
        loss = layers.mean(layers.ssd_loss(loc, conf, gt_box, gt_label, box,
                                           var))
        test = main.clone(for_test=True)
        fluid.optimizer.SGD(learning_rate=lr).minimize(loss)
    with unique_name.guard(), fluid.program_guard(test, startup):
        dets = layers.detection_output(loc, conf, box, var,
                                       nms_threshold=0.45, nms_top_k=50,
                                       keep_top_k=20, score_threshold=0.2)
        m_ap = layers.detection_map(dets, gt, class_num=C)
    return main, startup, loss, test, dets, m_ap


def _ssd_feeds(rng, n):
    feeds = []
    for _ in range(n):
        box = _boxes(rng, N, G, hi=0.5)
        label = rng.randint(1, C, (N, G)).astype(np.int64)
        gt = np.concatenate([label[..., None].astype(np.float32), box,
                             np.zeros((N, G, 1), np.float32)], axis=-1)
        feeds.append({"img": rng.randn(N, 3, HW, HW).astype(np.float32),
                      "gt_box": box, "gt_label": label, "gt": gt})
    return feeds


def test_c_ssd_program_trains_and_detects_like_jax():
    jm, js, jloss, jtest, jdets, jmap = _ssd_program(JAX)
    tm, _, tloss, ttest, tdets, tmap = _ssd_program(PORT)
    assert [op.type for op in tm.global_block().ops] == \
        [op.type for op in jm.global_block().ops]
    assert [op.type for op in ttest.global_block().ops] == \
        [op.type for op in jtest.global_block().ops]
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    texe, tscope = tfluid.Executor("cpu"), tfluid.Scope()
    tfluid.params_from_jax(
        {n: np.asarray(jscope.find_var(n))
         for n, v in jm.global_block().vars.items()
         if v.persistable and jscope.find_var(n) is not None},
        tscope, device="cpu")
    feeds = _ssd_feeds(np.random.RandomState(8), 4)
    losses = {}
    for side, exe, prog, loss, scope in (
            ("jax", jexe, jm, jloss, jscope),
            ("torch", texe, tm, tloss, tscope)):
        losses[side] = [float(np.asarray(exe.run(
            prog, feed=f, fetch_list=[loss], scope=scope)[0]).reshape(-1)[0])
            for f in feeds[:3]]
    np.testing.assert_allclose(losses["torch"], losses["jax"],
                               rtol=LOSS_RTOL)
    assert losses["torch"][-1] < losses["torch"][0]
    want = jexe.run(jtest, feed=feeds[3], fetch_list=[jdets, jmap],
                    scope=jscope)
    got = texe.run(ttest, feed=feeds[3], fetch_list=[tdets, tmap],
                   scope=tscope)
    assert got[0].shape == want[0].shape == (N, 20, 6)
    np.testing.assert_array_equal(got[0][..., 0], want[0][..., 0])
    np.testing.assert_allclose(got[0][..., 1:], want[0][..., 1:],
                               rtol=DET_RTOL, atol=BOX_ATOL)
    assert (got[0][..., 0] >= 0).sum() >= 2
    np.testing.assert_array_max_ulp(got[1], want[1], maxulp=MAP_ULPS)


def test_c_ssd_gradient_reaches_only_the_heads():
    """ssd_loss's matching, mining and targets are no_grad: the backward
    program differentiates only the location and confidence paths."""
    tm = _ssd_program(PORT)[0]
    grads = {op.type for op in tm.global_block().ops
             if op.type.endswith("_grad")}
    for op in ("iou_similarity", "bipartite_match", "target_assign",
               "mine_hard_examples", "box_coder", "prior_box"):
        assert op + "_grad" not in grads, op
    assert {"huber_loss_grad", "softmax_with_cross_entropy_grad",
            "conv2d_grad"} <= grads


# --- (d) shape inference ----------------------------------------------

def _meta_cases():
    """One small case of each of the slice's ops."""
    r = np.random.RandomState(12)
    x4 = r.randn(2, 4, 6, 6).astype(np.float32)
    x5 = r.randn(2, 2, 4, 6, 6).astype(np.float32)
    w = r.randn(4, 2, 3, 3).astype(np.float32)
    prior = _boxes(r, 10)
    pvar = np.full((10, 4), 0.1, np.float32)
    match = r.randint(-1, 3, (2, 10)).astype(np.int32)
    ins_map, classes = _map_case(r, 6)
    pooled = _port("max_pool2d_with_index", {"X": x4},
                   {"ksize": [2, 2], "strides": [2, 2]})
    return [
        ("depthwise_conv2d", {"Input": x4,
                              "Filter": r.randn(4, 1, 3, 3).astype(
                                  np.float32)}, {"paddings": [1, 1]}),
        ("conv3d", {"Input": x5, "Filter": r.randn(3, 2, 3, 3, 3).astype(
            np.float32)}, {}),
        ("conv2d_transpose", {"Input": x4, "Filter": w},
         {"strides": [2, 2], "paddings": [1, 1]}),
        ("conv3d_transpose", {"Input": x5, "Filter": r.randn(
            2, 3, 2, 2, 2).astype(np.float32)}, {"strides": [2, 2, 2]}),
        ("lrn", {"X": x4}, {"n": 4}),
        ("l2_normalize", {"X": x4}, {"axis": 1}),
        ("pad", {"X": x4}, {"paddings": [0, 0, 1, 0, 2, 1, 0, 3]}),
        ("crop", {"X": x4}, {"offsets": [0, 1, 1, 2],
                             "shape": [-1, 2, 4, 3]}),
        ("maxout", {"X": x4}, {"groups": 2}),
        ("pool3d", {"X": x5}, {"ksize": [2, 3, 3], "strides": [2, 2, 2],
                               "ceil_mode": True}),
        ("max_pool2d_with_index", {"X": x4}, {"ksize": [3, 3],
                                              "strides": [2, 2],
                                              "paddings": [1, 1]}),
        ("max_pool3d_with_index", {"X": x5}, {"ksize": [2, 2, 2],
                                              "strides": [2, 2, 2]}),
        ("unpool", {"X": pooled["Out"], "Indices": pooled["Mask"]},
         {"ksize": [2, 2], "strides": [2, 2]}),
        ("spp", {"X": x4}, {"pyramid_height": 3}),
        ("roi_pool", {"X": x4, "ROIs": np.array([[0, 0, 0, 4, 4],
                                                 [1, 1, 2, 5, 5]],
                                                np.float32)},
         {"pooled_height": 2, "pooled_width": 3}),
        ("bilinear_interp", {"X": x4}, {"out_h": 9, "out_w": 4}),
        ("nearest_interp", {"X": x4}, {"out_h": 3, "out_w": 8}),
        ("huber_loss", {"X": x4, "Y": x4[::-1].copy()}, {}),
        ("smooth_l1_loss", {"X": x4, "Y": x4[::-1].copy()}, {}),
        ("iou_similarity", {"X": _boxes(r, 2, 3), "Y": prior}, {}),
        ("prior_box", {"Input": x4, "Image": np.zeros((2, 3, 24, 24),
                                                     np.float32)},
         {"min_sizes": [4.0], "max_sizes": [9.0], "aspect_ratios": [2.0],
          "flip": True}),
        ("box_coder", {"PriorBox": prior, "PriorBoxVar": pvar,
                       "TargetBox": r.randn(2, 10, 4).astype(np.float32)},
         {"code_type": "decode_center_size"}),
        ("bipartite_match", {"DistMat": r.rand(2, 3, 10).astype(
            np.float32)}, {"match_type": "per_prediction"}),
        ("target_assign", {"X": _boxes(r, 2, 3), "MatchIndices": match,
                           "NegIndices": match}, {}),
        ("mine_hard_examples", {"ClsLoss": r.rand(2, 10).astype(np.float32),
                                "MatchIndices": match}, {}),
        ("multiclass_nms", {"BBoxes": _boxes(r, 2, 10),
                            "Scores": r.rand(2, 3, 10).astype(np.float32)},
         {"nms_top_k": 4, "keep_top_k": 5}),
        ("detection_map", ins_map, {"class_num": classes}),
    ]


META_CASES = _meta_cases()


@pytest.mark.parametrize("op,ins,attrs", META_CASES,
                         ids=[c[0] for c in META_CASES])
def test_d_shape_inference_on_meta_matches_a_cpu_run(op, ins, attrs):
    """Build-time shape inference runs each emitter on ``meta``: every
    output's shape and dtype equal a CPU run's (the loop ops answer
    without stepping)."""
    cpu = _port(op, ins, attrs)
    meta = run_forward(EmitCtx(device="meta"), op,
                       {s: [torch.empty(np.shape(v), device="meta",
                                        dtype=torch.from_numpy(
                                            np.array(v)).dtype)]
                        for s, v in ins.items()}, attrs)
    assert set(meta) == set(cpu)
    for s, v in meta.items():
        assert tuple(v[0].shape) == cpu[s].shape, s
        assert v[0].dtype == torch.from_numpy(cpu[s]).dtype, s


def test_d_meta_cases_cover_the_slice():
    assert {c[0] for c in META_CASES} == NEW_OPS
