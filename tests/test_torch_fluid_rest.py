"""The rest of Fluid's op library in the port against the JAX package's,
on the CPU: the 32 op types this slice adds (tensor: ``gather``,
``scatter``, ``one_hot``, ``multiplex``, ``label_smooth``, ``is_empty``,
``arg_min``, ``reverse``, ``split_ids``, ``split_selected_rows``; math:
``l1_norm``, ``minus``; the losses; ``nce``; the two batch-size-like
random ops; ``norm``, ``conv_shift``, ``bilinear_tensor_product``,
``sampling_id``; ``auc``, ``precision_recall``,
``positive_negative_pair``), their layers, ``fluid.evaluator``,
``fluid.metrics``, ``default_scope_funcs`` and ``calc_gradient``:

  - each op alone on seeded numpy inputs (one parametrised case or more
    an op): the outputs, and the input gradients through the port's
    record-and-grad path against the JAX op's ``jax.vjp`` for seeded
    cotangents. The JAX ops run op by op, as their code reads (jitted,
    XLA turns a division by a constant into a reciprocal product).
    ``nce`` is held on the port's own negatives: the test hands them to
    the JAX op through ``jax.random.randint``, inside the test only. The
    three random ops cannot match ``jax.random``: each package's draws
    are held by their distribution on 10^5 samples;
  - the program bytes of every new layer against the JAX layer's;
  - ``fluid.evaluator`` (Accuracy, EditDistance, ChunkEvaluator) and
    ``fluid.metrics`` over three batches in both packages;
  - a word2vec program with an ``hsigmoid`` head (sparse embedding)
    trains alike in both packages for 3 steps; one with an ``nce`` head
    trains in the port;
  - the registry pin: 212 of the JAX package's 218 op types.

Tolerances (float32; XLA and PyTorch sum in other orders): outputs rtol
1e-5 / atol 1e-6, gradients rtol 1e-4 / atol 1e-5, program parameters and
losses rtol 1e-5 / atol 1e-6; index and bool outputs exactly equal. The
distribution checks: means within 0.01 and standard deviations within
0.01 of the stated ones, category frequencies within 0.01 of the row's
probabilities (about 5 standard errors at 10^5 draws).
"""
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.fluid.registry import EmitCtx as JEmitCtx
from paddle_tpu.fluid.registry import OPS as JAX_OPS
from paddle_tpu.fluid.registry import get_op_info as jax_op_info
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import layers as tlayers
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.fluid.registry import (
    FWD_META_ATTR, OPS, EmitCtx, forward_with_grad, run_forward, run_grad)

FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
RTOL, ATOL = 1e-5, 1e-6
DRAWS = 100_000
STAT_TOL = 0.01
JAX = (jfluid, jlayers, junique)
PORT = (tfluid, tlayers, tunique)

NEW_OPS = {
    "gather", "scatter", "one_hot", "multiplex", "label_smooth", "is_empty",
    "arg_min", "reverse", "split_ids", "split_selected_rows", "l1_norm",
    "minus", "sigmoid_cross_entropy_with_logits", "log_loss", "hinge_loss",
    "rank_loss", "margin_rank_loss", "squared_l2_distance",
    "modified_huber_loss", "hierarchical_sigmoid", "lambda_cost",
    "scale_sub_region", "nce", "uniform_random_batch_size_like",
    "gaussian_random_batch_size_like", "norm", "conv_shift",
    "bilinear_tensor_product", "sampling_id", "auc", "precision_recall",
    "positive_negative_pair",
}
OPS_BEFORE = 180  # op types the port's own modules registered before
# the op types later slices registered: the mesh layer's
# (tests/test_torch_mesh.py holds them), the pipeline region's
# (tests/test_torch_pipeline.py) and the legacy per-sample conv
# (tests/test_torch_v2_ops.py)
OPS_AFTER = {"get_places", "parallel_do", "moe_ffn", "pipeline",
             "pipeline_cut", "conv2d_input_filter"}
STILL_MISSING = set()
# held in tests/test_torch_selected_rows.py (a SelectedRows input);
# drawn, so held by distribution below
ELSEWHERE = {"split_selected_rows", "uniform_random_batch_size_like",
             "gaussian_random_batch_size_like", "sampling_id"}


def _as_list(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


def _port_op(op_type, ins, attrs, dys):
    """Outputs (lists of numpy arrays), and with cotangents ``dys`` the
    input gradients (slot -> list)."""
    ctx = EmitCtx(device="cpu", root_seed=1)
    tins = {s: [torch.from_numpy(np.array(a)) for a in _as_list(v)]
            for s, v in ins.items()}
    if not dys:
        outs = run_forward(ctx, op_type, tins, attrs)
        return {s: [t.numpy() for t in v] for s, v in outs.items()}, {}
    outs, record = forward_with_grad(ctx, op_type, tins, attrs)
    grad_attrs = {FWD_META_ATTR: {"type": op_type, "attrs": attrs,
                                  "in_slots": list(ins),
                                  "out_slots": list(outs)}}
    gins = dict(tins)
    gins.update({"Out@" + s: v for s, v in outs.items()})
    gins.update({"GRAD@" + s: [torch.from_numpy(d)] for s, d in dys.items()})
    grads = run_grad(ctx, gins, grad_attrs, record)
    return ({s: [t.detach().numpy() for t in v] for s, v in outs.items()},
            {s[5:]: [None if g is None else g.numpy() for g in v]
             for s, v in grads.items()})


def _jax_op(op_type, ins, attrs, diff_slots, dys, ctx=None):
    """The JAX op's outputs and ``jax.vjp`` gradients, op by op."""
    fwd = jax_op_info(op_type).forward

    def fn(*diffs):
        full = {s: [jnp.asarray(a) for a in _as_list(v)]
                for s, v in ins.items()}
        full.update({s: [d] for s, d in zip(diff_slots, diffs)})
        return fwd(ctx, full, attrs)

    primals = [jnp.asarray(ins[s]) for s in diff_slots]
    outs = {s: [np.asarray(a) for a in _as_list(v)]
            for s, v in fn(*primals).items()}
    if not dys:
        return outs, {}
    _, vjp = jax.vjp(lambda *d: {s: fn(*d)[s] for s in dys}, *primals)
    grads = vjp({s: jnp.asarray(d) for s, d in dys.items()})
    return outs, dict(zip(diff_slots, (np.asarray(g) for g in grads)))


def _same(t, j, what):
    if (t.dtype, j.dtype) != (np.int64, np.int32):
        assert t.dtype == j.dtype, (what, t.dtype, j.dtype)
    assert t.shape == j.shape, (what, t.shape, j.shape)
    if t.dtype.kind in "iub":
        np.testing.assert_array_equal(t, j, err_msg=what)
    else:
        np.testing.assert_allclose(t, j, rtol=FWD_RTOL, atol=FWD_ATOL,
                                   err_msg=what)


def _op_parity(op_type, ins, attrs, diff_slots=(), out_slots=("Out",),
               seed=0, ctx=None):
    """Both packages' op on the same inputs: every slot of ``out_slots``
    (index outputs equal), and for ``diff_slots`` the gradients for
    seeded normal cotangents on the float ``out_slots``."""
    tout, _ = _port_op(op_type, ins, attrs, {})
    rng = np.random.RandomState(seed + 100)
    dys = {s: rng.randn(*tout[s][0].shape).astype(np.float32)
           for s in out_slots if tout[s][0].dtype.kind == "f"} \
        if diff_slots else {}
    tout, tgrads = _port_op(op_type, ins, attrs, dys)
    jout, jgrads = _jax_op(op_type, ins, attrs, list(diff_slots), dys, ctx)
    for s in out_slots:
        assert len(tout[s]) == len(jout[s]), s
        for i, (t, j) in enumerate(zip(tout[s], jout[s])):
            _same(t, j, f"{s}[{i}]")
    for s in diff_slots:
        np.testing.assert_allclose(tgrads[s][0], jgrads[s], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg="grad " + s)
    return tout, tgrads


def _randn(rng, *shape, scale=1.0):
    return (scale * rng.randn(*shape)).astype(np.float32)


def _uniform(rng, lo, hi, *shape):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _int(*values):
    return np.array(values, np.int64)


# --- the op cases -----------------------------------------------------------

def _cases():
    """(case id, op, ins, attrs, diff slots, out slots)."""
    rng = np.random.RandomState(2031)
    c = []

    def add(name, op, ins, attrs=None, diff=(), outs=("Out",)):
        c.append((name, op, ins, attrs or {}, tuple(diff), tuple(outs)))

    # tensor
    add("gather", "gather", {"X": _randn(rng, 5, 3),
                             "Index": _int([4], [0], [4], [2])}, diff=["X"])
    add("gather_flat_index", "gather", {"X": _randn(rng, 6, 2, 3),
                                        "Index": _int(5, 1, 1)}, diff=["X"])
    add("scatter", "scatter", {"X": _randn(rng, 6, 3), "Ids": _int(4, 0, 2),
                               "Updates": _randn(rng, 3, 3)},
        diff=["X", "Updates"])
    add("one_hot", "one_hot", {"X": _int([3], [0], [5], [6], [-1])},
        {"depth": 6})
    add("multiplex", "multiplex", {
        "X": [_randn(rng, 4, 5) for _ in range(3)],
        "Ids": _int([2], [0], [1], [2])})
    add("label_smooth", "label_smooth", {"X": np.eye(5, dtype=np.float32)[
        [1, 3, 0, 4]]}, {"epsilon": 0.1}, diff=["X"])
    add("label_smooth_prior", "label_smooth", {
        "X": np.eye(5, dtype=np.float32)[[2, 2, 4]],
        "PriorDist": np.array([0.1, 0.2, 0.3, 0.2, 0.2], np.float32)},
        {"epsilon": 0.2}, diff=["X"])
    add("is_empty", "is_empty", {"X": np.zeros((3, 0), np.float32)})
    add("is_empty_not", "is_empty", {"X": _randn(rng, 2, 2)})
    ties = rng.randint(-2, 3, (4, 6)).astype(np.float32)
    add("arg_min_axis1", "arg_min", {"X": ties}, {"axis": 1})
    add("arg_min_axis0", "arg_min", {"X": ties}, {"axis": 0})
    add("reverse", "reverse", {"X": _randn(rng, 3, 4, 2)}, {"axis": [0, 2]},
        diff=["X"])
    add("reverse_int_axis", "reverse", {"X": _randn(rng, 3, 4)}, {"axis": 1},
        diff=["X"])
    add("split_ids", "split_ids", {"Ids": _int([7], [2], [5], [0], [9])},
        {"num_shards": 2})
    # math
    add("l1_norm", "l1_norm", {"X": _randn(rng, 3, 4)}, diff=["X"])
    add("minus", "minus", {"X": _randn(rng, 3, 4), "Y": _randn(rng, 3, 4)},
        diff=["X", "Y"])
    # losses
    add("sigmoid_cross_entropy_with_logits",
        "sigmoid_cross_entropy_with_logits",
        {"X": _randn(rng, 4, 5, scale=3.0), "Label": _uniform(rng, 0, 1, 4, 5)},
        diff=["X", "Label"])
    add("log_loss", "log_loss", {
        "Predicted": _uniform(rng, 0.05, 0.95, 6, 1),
        "Labels": rng.randint(0, 2, (6, 1)).astype(np.float32)},
        {"epsilon": 1e-4}, diff=["Predicted"], outs=["Loss"])
    add("hinge_loss", "hinge_loss", {
        "Logits": _randn(rng, 8, 1, scale=2.0),
        "Labels": rng.randint(0, 2, (8, 1)).astype(np.float32)},
        diff=["Logits"], outs=["Loss"])
    add("rank_loss", "rank_loss", {
        "Label": rng.randint(0, 2, (6, 1)).astype(np.float32),
        "Left": _randn(rng, 6, 1), "Right": _randn(rng, 6, 1)},
        diff=["Left", "Right"])
    add("margin_rank_loss", "margin_rank_loss", {
        "Label": np.array([[1], [-1], [1], [-1], [1], [1]], np.float32),
        "X1": _randn(rng, 6, 1), "X2": _randn(rng, 6, 1)}, {"margin": 0.1},
        diff=["X1", "X2"], outs=["Out", "Activated"])
    add("squared_l2_distance", "squared_l2_distance", {
        "X": _randn(rng, 4, 5), "Y": _randn(rng, 4, 5)}, diff=["X", "Y"],
        outs=["Out", "sub_result"])
    add("modified_huber_loss", "modified_huber_loss", {
        "X": np.array([[-2.5], [-0.7], [0.2], [0.9], [1.6], [-1.4], [0.4],
                       [3.0]], np.float32),
        "Y": np.array([[1], [0], [1], [0], [1], [0], [0], [1]], np.float32)},
        diff=["X"], outs=["Out", "IntermediateVal"])
    for k in (12, 16, 2):  # K not a power of two masks the top levels
        add(f"hierarchical_sigmoid_k{k}", "hierarchical_sigmoid", {
            "X": _randn(rng, 5, 6), "W": _randn(rng, k - 1, 6, scale=0.5),
            "Label": rng.randint(0, k, (5, 1)).astype(np.int64),
            "Bias": _randn(rng, k - 1, scale=0.1)}, {"num_classes": k},
            diff=["X", "W", "Bias"], outs=["Cost"])
    add("hierarchical_sigmoid_no_bias", "hierarchical_sigmoid", {
        "X": _randn(rng, 4, 3), "W": _randn(rng, 6, 3),
        "Label": _int([0], [6], [3], [5])}, {"num_classes": 7},
        diff=["X", "W"], outs=["Cost"])
    add("lambda_cost", "lambda_cost", {
        "X": _randn(rng, 3, 6),
        "Score": rng.randint(0, 4, (3, 6)).astype(np.float32),
        "Lengths": np.array([6, 4, 2], np.int32)}, {"NDCG_num": 4},
        diff=["X"], outs=["Cost"])
    add("scale_sub_region", "scale_sub_region", {
        "X": _randn(rng, 2, 3, 4, 5),
        "Indices": np.array([[1, 2, 2, 3, 1, 5], [3, 3, 1, 4, 2, 2]],
                            np.int32)}, {"value": 2.5}, diff=["X"])
    # vision
    add("norm", "norm", {"X": _randn(rng, 2, 4, 3, 3),
                         "Scale": _uniform(rng, 0.5, 2.0, 4)},
        {"epsilon": 1e-10}, diff=["X", "Scale"])
    add("conv_shift", "conv_shift", {"X": _randn(rng, 3, 7),
                                     "Y": _randn(rng, 3, 3)},
        diff=["X", "Y"])
    add("bilinear_tensor_product", "bilinear_tensor_product", {
        "X": _randn(rng, 4, 3), "Y": _randn(rng, 4, 5),
        "Weight": _randn(rng, 2, 3, 5), "Bias": _randn(rng, 1, 2)},
        diff=["X", "Y", "Weight", "Bias"])
    # metrics: scores exactly on thresholds of linspace(0, 1, 11)
    on = np.array([0.0, 0.1, 0.3, 0.7, 1.0, 0.5, 0.9, 0.2], np.float32)
    add("auc_on_thresholds", "auc", {
        "Out": np.stack([1 - on, on], 1),
        "Label": _int([1], [0], [0], [1], [1], [0], [1], [0])},
        {"num_thresholds": 11}, outs=["AUC"])
    s = _uniform(rng, 0, 1, 64)
    add("auc", "auc", {"Out": np.stack([1 - s, s], 1),
                       "Label": rng.randint(0, 2, (64, 1)).astype(np.int64)},
        {"num_thresholds": 200}, outs=["AUC"])
    pr_outs = ["BatchMetrics", "AccumMetrics", "AccumStatesInfo"]
    add("precision_recall", "precision_recall", {
        "MaxProbs": _uniform(rng, 0, 1, 10, 1),
        "Indices": rng.randint(0, 4, (10, 1)).astype(np.int64),
        "Labels": rng.randint(0, 4, (10, 1)).astype(np.int64)},
        {"class_number": 4}, outs=pr_outs)
    add("precision_recall_states", "precision_recall", {
        "MaxProbs": _uniform(rng, 0, 1, 10, 1),
        "Indices": rng.randint(0, 5, (10, 1)).astype(np.int64),
        "Labels": rng.randint(0, 5, (10, 1)).astype(np.int64),
        "Weights": _uniform(rng, 0.5, 2, 10, 1),
        "StatesInfo": rng.randint(0, 4, (5, 4)).astype(np.float32)},
        {"class_number": 5}, outs=pr_outs)
    pnp_outs = ["PositivePair", "NegativePair", "NeutralPair"]
    score = rng.randint(0, 4, (12, 1)).astype(np.float32)  # ties
    add("positive_negative_pair", "positive_negative_pair", {
        "Score": score, "Label": rng.randint(0, 3, (12, 1)).astype(
            np.float32),
        "QueryID": rng.randint(0, 3, (12, 1)).astype(np.int64)},
        outs=pnp_outs)
    add("positive_negative_pair_accumulated", "positive_negative_pair", {
        "Score": _randn(rng, 10, 2),
        "Label": rng.randint(0, 2, (10, 1)).astype(np.float32),
        "QueryID": rng.randint(0, 2, (10, 1)).astype(np.int64),
        "AccumulatePositivePair": np.array([3.0], np.float32),
        "AccumulateNegativePair": np.array([1.0], np.float32),
        "AccumulateNeutralPair": np.array([2.0], np.float32),
        "Weight": _uniform(rng, 0.5, 1.5, 10, 1)}, {"column": 0},
        outs=pnp_outs)
    return c


CASES = _cases()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_op_matches_jax(case):
    _, op, ins, attrs, diff, outs = case
    _op_parity(op, ins, attrs, diff, outs)


def test_hierarchical_sigmoid_masks_the_top_levels():
    """K = 12: a path is 4 levels at most (leaves 12..23); leaf 0
    (code 12) walks nodes 5, 2, 0 and masks its fourth level, so its cost
    is the three sigmoid cross entropies of those nodes alone."""
    rng = np.random.RandomState(5)
    x, w = _randn(rng, 1, 4), _randn(rng, 11, 4)
    out = _port_op("hierarchical_sigmoid", {
        "X": x, "W": w, "Label": _int([0])}, {"num_classes": 12},
        {})[0]["Cost"][0]
    z = w[[5, 2, 0]] @ x[0]
    bits = np.array([0, 0, 1], np.float32)  # 12 = 0b1100, from the leaf
    want = np.sum(np.logaddexp(z, 0) - bits * z)
    np.testing.assert_allclose(out[0], want, rtol=FWD_RTOL)


def test_nce_matches_jax_on_the_ports_negatives(monkeypatch):
    """The port draws its negatives; the JAX op is given the same ones
    through ``jax.random.randint`` (patched inside this test only). Cost,
    SampleLogits, SampleLabels and the gradients of Input, Weight and
    Bias agree; a replay of the forward (no record) draws the same
    negatives, so the grad op scores the forward's samples."""
    rng = np.random.RandomState(9)
    ins = {"Input": _randn(rng, 6, 8), "Weight": _randn(rng, 20, 8),
           "Bias": _randn(rng, 20, scale=0.1),
           "Label": rng.randint(0, 20, (6, 1)).astype(np.int64)}
    attrs = {"num_total_classes": 20, "num_neg_samples": 5,
             "__rng_seed__": 3}
    tout, _ = _port_op("nce", ins, attrs, {})
    neg = tout["SampleLabels"][0][:, 1:]
    assert neg.shape == (6, 5) and neg.min() >= 0 and neg.max() < 20
    np.testing.assert_array_equal(tout["SampleLabels"][0][:, :1],
                                  ins["Label"])
    calls = []

    def randint(key, shape, minval, maxval, *a, **k):
        calls.append((tuple(shape), minval, maxval))
        return jnp.asarray(neg, jnp.int32)

    monkeypatch.setattr(jax.random, "randint", randint)
    _op_parity("nce", ins, attrs, ["Input", "Weight", "Bias"],
               ("Cost", "SampleLogits", "SampleLabels"),
               ctx=JEmitCtx(root_key=jax.random.PRNGKey(0)))
    assert calls and calls[0] == ((6, 5), 0, 20)
    # a replayed forward (a grad op with no record) draws the same
    ctx = EmitCtx(device="cpu", root_seed=1)
    tins = {s: [torch.from_numpy(v)] for s, v in ins.items()}
    again = run_forward(ctx, "nce", tins, attrs)["SampleLabels"][0]
    np.testing.assert_array_equal(again.numpy(), tout["SampleLabels"][0])


# --- the random ops, held by their distributions ----------------------------

def _draws(op, ins, attrs, pkg):
    if pkg is PORT:
        return _port_op(op, ins, attrs, {})[0]["Out"][0]
    ctx = JEmitCtx(root_key=jax.random.PRNGKey(1))
    return np.asarray(jax_op_info(op).forward(ctx, {
        s: [jnp.asarray(v)] for s, v in ins.items()}, attrs)["Out"])


@pytest.mark.parametrize("pkg", [PORT, JAX], ids=["port", "jax"])
@pytest.mark.parametrize("op,attrs,mean,std", [
    ("uniform_random_batch_size_like",
     {"shape": [-1, 1000], "min": -2.0, "max": 4.0}, 1.0, 6 / math.sqrt(12)),
    ("gaussian_random_batch_size_like",
     {"shape": [-1, 1000], "mean": 0.5, "std": 2.0}, 0.5, 2.0),
])
def test_batch_size_like_draws_by_distribution(op, attrs, mean, std, pkg):
    ins = {"Input": np.zeros((DRAWS // 1000, 7), np.float32)}
    out = _draws(op, ins, {**attrs, "__rng_seed__": 1}, pkg)
    assert out.shape == (DRAWS // 1000, 1000) and out.dtype == np.float32
    assert abs(out.mean() - mean) < STAT_TOL * max(1.0, std)
    assert abs(out.std() - std) < STAT_TOL * max(1.0, std)
    if op.startswith("uniform"):
        assert out.min() >= attrs["min"] and out.max() < attrs["max"]


@pytest.mark.parametrize("pkg", [PORT, JAX], ids=["port", "jax"])
def test_sampling_id_draws_by_distribution(pkg):
    """Unnormalised rows, a zero entry among them: each row's draws land
    on each category at its probability, never on the zero."""
    probs = np.array([[0.1, 0.2, 0.0, 0.7], [2.0, 1.0, 1.0, 0.0]],
                     np.float32)
    n = DRAWS // 2
    x = np.repeat(probs, n, axis=0)
    ids = _draws("sampling_id", {"X": x}, {"__rng_seed__": 2}, pkg)
    assert ids.shape == (2 * n,) and ids.dtype.kind == "i"
    for r, row in enumerate(probs):
        freq = np.bincount(ids[r * n:(r + 1) * n], minlength=4) / n
        np.testing.assert_allclose(freq, row / row.sum(), atol=STAT_TOL)
        assert freq[row == 0].sum() == 0


# --- layers: program bytes ---------------------------------------------------

def _same_program(tp, jp):
    """``to_bytes()`` equal, up to a var declared int64 that the JAX
    package's bytes record as int32 (no x64), and the dtype attr (a
    cast's ``in_dtype``) read from such a var."""
    tj, jj = json.loads(tp.to_bytes()), json.loads(jp.to_bytes())
    for tb, jb in zip(tj["blocks"], jj["blocks"]):
        for name, jv in jb["vars"].items():
            tv = tb["vars"].get(name)
            if tv and (tv["dtype"], jv["dtype"]) == ("int64", "int32"):
                jv["dtype"] = "int64"
        for to, jo in zip(tb["ops"], jb["ops"]):
            for key, jv in jo["attrs"].items():
                if (to["attrs"].get(key), jv) == ("int64", "int32"):
                    jo["attrs"][key] = "int64"
    assert tj == jj


def _build(pkg, body, seed=3):
    fluid, layers, unique_name = pkg
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with unique_name.guard(), fluid.program_guard(main, startup):
        out = body(fluid, layers)
    return main, startup, out


def _x(L, shape=(6,), name="x", dtype="float32"):
    return L.data(name=name, shape=list(shape), dtype=dtype)


LAYERS = {
    "nce": lambda f, L: L.nce(input=_x(L), label=_x(L, [1], "y", "int64"),
                              num_total_classes=30, num_neg_samples=4),
    "nce_no_bias": lambda f, L: L.nce(
        input=_x(L), label=_x(L, [1], "y", "int64"), num_total_classes=30,
        bias_attr=False),
    "hsigmoid": lambda f, L: L.hsigmoid(
        input=_x(L), label=_x(L, [1], "y", "int64"), num_classes=12),
    "one_hot": lambda f, L: L.one_hot(_x(L, [1], dtype="int64"), depth=7),
    "label_smooth": lambda f, L: L.label_smooth(
        L.one_hot(_x(L, [1], dtype="int64"), depth=7), epsilon=0.2),
    "sigmoid_cross_entropy_with_logits":
        lambda f, L: L.sigmoid_cross_entropy_with_logits(_x(L), _x(L, name="y")),
    "multiplex": lambda f, L: L.multiplex(
        [_x(L, name="a"), _x(L, name="b")], _x(L, [1], "i", "int32")),
    "prelu_all": lambda f, L: L.prelu(_x(L, [3, 4, 4]), mode="all"),
    "prelu_channel": lambda f, L: L.prelu(_x(L, [3, 4, 4]), mode="channel"),
    "prelu_element": lambda f, L: L.prelu(_x(L, [3, 4, 4]), mode="element"),
    "dot_product_attention": lambda f, L: L.dot_product_attention(
        _x(L, [5, 8], "q"), _x(L, [5, 8], "k"), _x(L, [5, 8], "v")),
    "argmin": lambda f, L: L.argmin(_x(L, [5]), axis=1),
    "create_tensor": lambda f, L: L.create_tensor("float32", name="t",
                                                  persistable=True),
    "uniform_random": lambda f, L: L.uniform_random([3, 4], min=-0.5,
                                                    max=0.5, seed=7),
    "gaussian_random": lambda f, L: L.gaussian_random([3, 4], mean=1.0,
                                                      std=0.5),
    "lookup_table": lambda f, L: L.lookup_table(
        _x(L, [1], dtype="int64"), size=[40, 6], is_sparse=True),
    "save_load": lambda f, L: (L.save(_x(L), "x.npy"),
                               L.load(L.create_tensor("float32", name="z"),
                                      "x.npy")),
    "save_load_combine": lambda f, L: (
        L.save_combine([_x(L), _x(L, name="y")], "xy.npz"),
        L.load_combine([L.create_tensor("float32", name="a"),
                        L.create_tensor("float32", name="b")], "xy.npz")),
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_layer_program_bytes_match_jax(name):
    tm, ts, _ = _build(PORT, LAYERS[name])
    jm, js, _ = _build(JAX, LAYERS[name])
    _same_program(tm, jm)
    _same_program(ts, js)


def test_calc_gradient_matches_jax():
    """``fluid.calc_gradient`` of a scalar wrt an fc weight: the program
    bytes and the gradient equal the JAX package's."""
    def body(fluid, L):
        x = _x(L, [4])
        y = L.fc(input=x, size=3, param_attr="w", bias_attr=False)
        loss = L.mean(L.square(y))
        w = fluid.default_main_program().global_block().var("w")
        (g,) = fluid.calc_gradient(loss, [w])
        return g

    (tm, ts, tg), (jm, js, jg) = _build(PORT, body), _build(JAX, body)
    _same_program(tm, jm)
    w = np.random.RandomState(4).randn(4, 3).astype(np.float32)
    x = np.random.RandomState(5).randn(2, 4).astype(np.float32)
    got = []
    for fluid, main, startup, g in ((tfluid, tm, ts, tg),
                                    (jfluid, jm, js, jg)):
        scope, exe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        scope.set_var("w", torch.from_numpy(w) if fluid is tfluid
                      else jnp.asarray(w))
        got.append(np.asarray(exe.run(main, feed={"x": x}, fetch_list=[g],
                                      scope=scope)[0]))
    np.testing.assert_allclose(got[0], got[1], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[0], x.T @ (2 * (x @ w)) / 6, rtol=RTOL,
                               atol=ATOL)


def test_default_scope_funcs_and_exports():
    from paddle_tpu_torch.fluid import default_scope_funcs as dsf

    assert tfluid.Tensor is None and tfluid.WeightNormParamAttr is not None
    assert tfluid.selected_rows.SelectedRows is not None
    root = dsf.get_cur_scope()
    child = dsf.enter_local_scope()
    try:
        assert dsf.get_cur_scope() is child and child.parent is root
        dsf.var("local")
        assert "local" in child.var_names() and dsf.find_var("local") is None
        child.set_var("local", torch.ones(1))
        assert dsf.find_var("local") is not None
    finally:
        dsf.leave_local_scope()
    assert dsf.get_cur_scope() is root
    assert dsf.scoped_function(lambda: dsf.get_cur_scope()) is not root
    with pytest.raises(RuntimeError):
        dsf.leave_local_scope()


# --- fluid.evaluator and fluid.metrics ---------------------------------------

def _evaluator_run(pkg, kind):
    """Three batches through the evaluator ``kind`` in a program of
    ``pkg``; returns its eval() after reset and the batches."""
    fluid, layers, unique_name = pkg
    rng = np.random.RandomState(1)
    main, startup = fluid.Program(), fluid.Program()
    scope = fluid.Scope()
    with fluid.scope_guard(scope), unique_name.guard():
        with fluid.program_guard(main, startup):
            if kind == "accuracy":
                scores = layers.data(name="scores", shape=[4],
                                     dtype="float32")
                label = layers.data(name="label", shape=[1], dtype="int64")
                ev = fluid.evaluator.Accuracy(input=scores, label=label)
                feeds = [{"scores": rng.rand(8, 4).astype("float32"),
                          "label": rng.randint(0, 4, (8, 1)).astype("int64")}
                         for _ in range(3)]
            elif kind == "edit_distance":
                hyp = layers.data(name="hyp", shape=[5], dtype="int64")
                ref = layers.data(name="ref", shape=[5], dtype="int64")
                ev = fluid.evaluator.EditDistance(input=hyp, label=ref)
                feeds = [{"hyp": rng.randint(0, 4, (3, 5)).astype("int64"),
                          "ref": rng.randint(0, 4, (3, 5)).astype("int64")}
                         for _ in range(3)]
            else:
                inf = layers.data(name="inf", shape=[6], dtype="int64")
                lab = layers.data(name="lab", shape=[6], dtype="int64")
                ev = fluid.evaluator.ChunkEvaluator(
                    input=inf, label=lab, chunk_scheme="IOB",
                    num_chunk_types=2)
                feeds = [{"inf": rng.randint(0, 5, (4, 6)).astype("int64"),
                          "lab": rng.randint(0, 5, (4, 6)).astype("int64")}
                         for _ in range(3)]
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        ev.reset(exe)
        metrics = [[np.asarray(v) for v in exe.run(
            main, feed=f, fetch_list=ev.metrics)] for f in feeds]
        result = ev.eval(exe)
    return [np.asarray(r) for r in _as_list(result)], metrics, main


@pytest.mark.parametrize("kind", ["accuracy", "edit_distance", "chunk"])
def test_evaluator_matches_jax(kind):
    tres, tmet, tmain = _evaluator_run(PORT, kind)
    jres, jmet, jmain = _evaluator_run(JAX, kind)
    _same_program(tmain, jmain)
    for t, j in zip(tres, jres):
        np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    for tb, jb in zip(tmet, jmet):
        for t, j in zip(tb, jb):
            np.testing.assert_allclose(t, j, rtol=RTOL, atol=ATOL)
    if kind == "accuracy":
        assert 0.0 < float(tres[0].reshape(-1)[0]) < 1.0


def test_program_of_host_ops_fetches_from_the_scope():
    """A repair: a program with no device op (an evaluator's eval
    program clones its state vars and fetches them) fetches them from
    the scope, as the JAX executor's host-only path does; the port raised
    "was not produced by the block"."""
    got = []
    for fluid in (tfluid, jfluid):
        prog, scope = fluid.Program(), fluid.Scope()
        v = prog.global_block().create_var(name="state", shape=[2],
                                           dtype="float32", persistable=True)
        scope.set_var("state", torch.tensor([1.5, -2.0]) if fluid is tfluid
                      else jnp.asarray([1.5, -2.0]))
        got.append(np.asarray(fluid.Executor(fluid.CPUPlace()).run(
            prog, fetch_list=[v], scope=scope)[0]))
    np.testing.assert_array_equal(got[0], got[1])
    with pytest.raises(ValueError, match="was not produced"):
        tfluid.Executor(tfluid.CPUPlace()).run(
            tfluid.Program(), fetch_list=["absent"], scope=tfluid.Scope())


def test_metrics_match_jax():
    from paddle_tpu.fluid import metrics as jm
    from paddle_tpu_torch.fluid import metrics as tm

    rng = np.random.RandomState(0)
    batches = []
    for _ in range(3):
        labels = rng.randint(0, 2, size=64)
        scores = np.clip(0.6 * labels + 0.5 * rng.rand(64), 0, 1)
        batches.append((np.stack([1 - scores, scores], 1), labels,
                        rng.randint(5, 20), rng.randint(0, 5, (4, 1))))
    out = []
    for m in (tm, jm):
        auc, pr = m.Auc(num_thresholds=200), m.Auc(curve="PR")
        acc, ch, ed, dm = m.Accuracy(), m.ChunkEvaluator(), m.EditDistance(), \
            m.DetectionMAP()
        comp = m.CompositeMetric()
        comp.add_metric(m.Accuracy())
        for preds, labels, n, dist in batches:
            auc.update(preds, labels)
            pr.update(preds, labels)
            acc.update(float((preds.argmax(1) == labels).mean()), 64)
            ch.update(n, n - 2, n // 2)
            ed.update(dist.astype(np.float64), len(dist))
            dm.update(float(preds[0, 1]))
            comp._metrics[0].update(0.5, 2)
        res = [auc.eval(), pr.eval(), acc.eval(), *ch.eval(), *ed.eval(),
               dm.eval(), *comp.eval()]
        config = auc.get_config()
        auc.reset()
        out.append((res, config["name"], float(auc.tp_list.sum())))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=RTOL, atol=ATOL)
    assert out[0][0][0] > 0.8
    assert out[0][1:] == out[1][1:] == ("Auc", 0.0)


# --- programs with the new heads ---------------------------------------------

W2V = dict(vocab=120, emb=16, hidden=32, n=5, batch=16)


def _word2vec(head, seed=13):
    """The book's N-gram model (tests/test_book.py:76) at a small width:
    N-1 words through one shared sparse embedding, concat, fc(sigmoid),
    and the ``head``'s cost over the vocabulary."""
    def body(fluid, L):
        words = [L.data(name=f"word_{i}", shape=[1], dtype="int64")
                 for i in range(W2V["n"] - 1)]
        nxt = L.data(name="next_word", shape=[1], dtype="int64")
        embeds = [L.embedding(input=w, size=[W2V["vocab"], W2V["emb"]],
                              is_sparse=True,
                              param_attr=fluid.ParamAttr(name="shared_w"))
                  for w in words]
        h = L.fc(input=L.concat(input=embeds, axis=1), size=W2V["hidden"],
                 act="sigmoid")
        if head == "hsigmoid":
            cost = L.hsigmoid(input=h, label=nxt, num_classes=W2V["vocab"])
        else:
            cost = L.nce(input=h, label=nxt,
                         num_total_classes=W2V["vocab"])
        avg = L.mean(cost)
        fluid.optimizer.SGD(learning_rate=0.5).minimize(avg)
        return avg, [w.name for w in words] + ["next_word"]

    return body


def _w2v_feeds(steps):
    rng = np.random.RandomState(6)
    return [{f"word_{i}" if i < W2V["n"] - 1 else "next_word":
             np.minimum(rng.zipf(1.5, (W2V["batch"], 1)), W2V["vocab"])
             .astype(np.int64) - 1 for i in range(W2V["n"])}
            for _ in range(steps)]


def test_word2vec_hsigmoid_head_trains_as_jax():
    (tm, ts, (tloss, _)), (jm, js, (jloss, _)) = \
        _build(PORT, _word2vec("hsigmoid")), _build(JAX, _word2vec("hsigmoid"))
    _same_program(tm, jm)
    _same_program(ts, js)
    jscope, jexe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
    jexe.run(js, scope=jscope)
    tscope, texe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
    texe.run(ts, scope=tscope)
    names = [p.name for p in tm.global_block().all_parameters()]
    for n in names:
        tscope.set_var(n, torch.from_numpy(np.array(jscope.find_var(n))))
    tl, jl = [], []
    for feed in _w2v_feeds(3):
        tl.append(float(texe.run(tm, feed=feed, fetch_list=[tloss],
                                 scope=tscope)[0][0]))
        jl.append(float(np.asarray(jexe.run(jm, feed=feed,
                                            fetch_list=[jloss],
                                            scope=jscope)[0]).reshape(-1)[0]))
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    for n in names:
        np.testing.assert_allclose(tscope.find_var(n).numpy(),
                                   np.asarray(jscope.find_var(n)),
                                   rtol=RTOL, atol=ATOL, err_msg=n)


def test_word2vec_nce_head_trains_in_the_port():
    """The nce head's program: bytes equal the JAX build's; on one batch
    repeated, the port's loss falls over 8 steps, and two runs from the
    same start are bitwise the same (the negatives come from the
    program's seed)."""
    (tm, ts, (tloss, _)), (jm, js, _) = \
        _build(PORT, _word2vec("nce")), _build(JAX, _word2vec("nce"))
    _same_program(tm, jm)
    _same_program(ts, js)
    feed = _w2v_feeds(1)[0]
    runs = []
    for _ in range(2):
        main, startup, (loss, _) = _build(PORT, _word2vec("nce"))
        scope, exe = tfluid.Scope(), tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        runs.append([float(exe.run(main, feed=feed, fetch_list=[loss],
                                   scope=scope)[0][0]) for _ in range(8)])
    assert runs[0] == runs[1]
    assert all(np.isfinite(runs[0])) and runs[0][-1] < runs[0][0]


# --- the registry ------------------------------------------------------------

def test_registry_holds_212_of_218_op_types():
    """Counted over the port's own modules (other test files register
    probe ops of their own in a worker's process)."""
    own = {t for t, info in OPS.items()
           if info.forward.__module__.startswith("paddle_tpu_torch.")}
    jax_own = {t for t, info in JAX_OPS.items()
               if info.forward.__module__.startswith("paddle_tpu.")}
    assert len(NEW_OPS) == 32 and NEW_OPS <= jax_own
    assert NEW_OPS <= own, sorted(NEW_OPS - own)
    assert len(own) == OPS_BEFORE + len(NEW_OPS) + len(OPS_AFTER) == 218
    assert OPS_AFTER <= own
    assert len(jax_own) == 218
    assert jax_own - own == STILL_MISSING
    assert own <= jax_own
    tested = {c[1] for c in CASES} | {"nce"} | ELSEWHERE
    assert tested == NEW_OPS, sorted(NEW_OPS ^ tested)
