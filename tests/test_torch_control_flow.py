"""The port's control flow (``fluid/ops/control_flow.py``,
``fluid/layers/control_flow.py``) and the ops its programs run
(``activations``, ``elementwise``, ``compare_ops``, ``reduce_ops``,
``loss_ops.cross_entropy``, ``tensor_ops``, the rank-table ops of
``sequence_ops``, ``beam_search_ops``) against the JAX package's, on
the CPU:

  (a) every new op alone: outputs and, for a differentiable op, the
      input gradients through the port's record-and-grad path, against
      the JAX op and its ``jax.vjp`` on seeded numpy inputs;
  (b) ``beam_search``: ids and parents bitwise the JAX op's where
      finished beams and -1e9 lanes tie, ``beam_search_decode`` bitwise;
  (c) programs built by both packages (same program bytes) and run by
      both executors from the JAX scope's values: While unbounded and
      with ``max_steps`` (forward and gradients, the step-evaluation
      count), IfElse, ConditionalBlock, Switch, StaticRNN, DynamicRNN on
      ragged lengths including 1 and T with a static input, the tensor
      arrays in a While, lod_rank_table / reorder_lod_tensor_by_rank /
      max_sequence_len / zeros_like_array / equal, Print;
  (d) a parameter read only inside a DynamicRNN, a While(max_steps=K)
      or a StaticRNN gets the JAX package's gradient (a sub-block run
      with autograd off would give it zeros);
  (e) a DynamicRNN's gradient under amp (bf16 products) against a
      float64 central difference of a numpy replica, as the JAX test
      (tests/test_control_flow_grad.py:259) holds its own.

Tolerances (float32; XLA and PyTorch sum in other orders): rtol 1e-5 /
atol 1e-6 on outputs and gradients; (e) 4e-2 of the largest gradient,
the JAX test's bound for bf16's 8 mantissa bits.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.fluid.flags import set_flags as jset_flags
from paddle_tpu.fluid.registry import get_op_info as jax_op_info
import paddle_tpu_torch
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.flags import set_flags as tset_flags
from paddle_tpu_torch.fluid import layers as tlayers
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.fluid.ops import control_flow as tcf
from paddle_tpu_torch.fluid.registry import (
    FWD_META_ATTR, EmitCtx, forward_with_grad, run_forward, run_grad)

RTOL, ATOL = 1e-5, 1e-6
BF16_TOL = 4e-2
JAX = (paddle_tpu, jfluid, jlayers, junique)
PORT = (paddle_tpu_torch, tfluid, tlayers, tunique)


# --- (a) ops alone -------------------------------------------------------

def _port_op(op_type, ins, attrs, dys):
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


def _jax_op(op_type, ins, attrs, diff_slots, dys):
    fwd = jax_op_info(op_type).forward

    def fn(*diffs):
        full = {s: [jnp.asarray(v)] for s, v in ins.items()}
        full.update({s: [d] for s, d in zip(diff_slots, diffs)})
        return fwd(None, full, attrs)

    primals = [jnp.asarray(ins[s]) for s in diff_slots]
    outs = {s: np.asarray(v[0] if isinstance(v, list) else v)
            for s, v in fn(*primals).items()}
    if not dys:
        return outs, {}
    _, vjp = jax.vjp(lambda *d: {s: fn(*d)[s] for s in dys}, *primals)
    grads = vjp({s: jnp.asarray(d) for s, d in dys.items()})
    return outs, dict(zip(diff_slots, (np.asarray(g) for g in grads)))


def _op_parity(op_type, ins, attrs, diff_slots=(), out_slots=("Out",),
               seed=0):
    """Outputs and (for ``diff_slots``) gradients of both packages' op on
    the same inputs; the cotangents are seeded normals. Dtypes agree,
    except that an int64 result computes as int32 in the JAX package
    (it runs without x64)."""
    tout0, _ = _port_op(op_type, ins, attrs, {})
    rng = np.random.RandomState(seed + 100)
    dys = {s: rng.randn(*tout0[s].shape).astype(tout0[s].dtype)
           for s in out_slots} if diff_slots else {}
    tout, tgrads = _port_op(op_type, ins, attrs, dys)
    jout, jgrads = _jax_op(op_type, ins, attrs, list(diff_slots), dys)
    for s in out_slots:
        if (tout[s].dtype, jout[s].dtype) != (np.int64, np.int32):
            assert tout[s].dtype == jout[s].dtype, (s, tout[s].dtype,
                                                     jout[s].dtype)
        assert tout[s].shape == jout[s].shape, s
        np.testing.assert_allclose(tout[s], jout[s], rtol=RTOL, atol=ATOL,
                                   err_msg=s)
    for s in diff_slots:
        np.testing.assert_allclose(tgrads[s], jgrads[s], rtol=RTOL,
                                   atol=ATOL, err_msg="grad " + s)
    return tout, tgrads


def _x(seed, shape, lo=None, hi=None):
    rng = np.random.RandomState(seed)
    if lo is None:
        return rng.randn(*shape).astype(np.float32)
    return rng.uniform(lo, hi, shape).astype(np.float32)


# unary ops: (op, attrs, positive domain)
UNARY = [
    ("sigmoid", {}, False), ("logsigmoid", {}, False), ("exp", {}, False),
    ("relu", {}, False), ("tanh", {}, False), ("tanh_shrink", {}, False),
    ("sqrt", {}, True), ("abs", {}, False), ("ceil", {}, False),
    ("floor", {}, False), ("cos", {}, False), ("sin", {}, False),
    ("round", {}, False), ("reciprocal", {}, True), ("log", {}, True),
    ("log_softmax", {"axis": -1}, False), ("square", {}, False),
    ("softplus", {}, False), ("softsign", {}, False),
    ("softshrink", {"lambda": 0.3}, False),
    ("brelu", {"t_min": -0.5, "t_max": 0.7}, False),
    ("leaky_relu", {"alpha": 0.1}, False), ("soft_relu", {}, False),
    ("elu", {"alpha": 0.7}, False), ("relu6", {"threshold": 1.5}, False),
    ("pow", {"factor": 2.5}, True), ("stanh", {}, False),
    ("hard_sigmoid", {}, False), ("swish", {"beta": 1.3}, False),
    ("thresholded_relu", {"threshold": 0.4}, False),
    ("hard_shrink", {"threshold": 0.3}, False), ("gelu", {}, False),
    ("cumsum", {"axis": 1}, False),
    ("cumsum", {"axis": 1, "reverse": True, "exclusive": True}, False),
    ("sign", {}, False),
]


@pytest.mark.parametrize("op,attrs,positive", UNARY,
                         ids=[f"{u[0]}{i}" for i, u in enumerate(UNARY)])
def test_a_unary_op_matches_jax(op, attrs, positive):
    x = _x(1, (3, 5), 0.5, 2.0) if positive else _x(1, (3, 5)) * 2
    _op_parity(op, {"X": x}, attrs, ["X"])


@pytest.mark.parametrize("mode,alpha_shape", [
    ("all", (1,)), ("channel", (3,)), ("element", (3, 4))])
def test_a_prelu_matches_jax(mode, alpha_shape):
    _op_parity("prelu", {"X": _x(2, (2, 3, 4)),
                         "Alpha": _x(3, alpha_shape, 0.1, 0.4)},
               {"mode": mode}, ["X", "Alpha"])


@pytest.mark.parametrize("op", ["elementwise_mul", "elementwise_div",
                                "elementwise_max", "elementwise_min",
                                "elementwise_pow"])
@pytest.mark.parametrize("yshape,axis", [((2, 3, 4), -1), ((3,), 1)])
def test_a_elementwise_op_matches_jax(op, yshape, axis):
    x = _x(4, (2, 3, 4), 0.5, 2.0)
    y = _x(5, yshape, 0.5, 2.0)
    _op_parity(op, {"X": x, "Y": y}, {"axis": axis}, ["X", "Y"])


@pytest.mark.parametrize("op", ["less_than", "less_equal", "greater_than",
                                "greater_equal", "equal", "not_equal"])
def test_a_compare_op_matches_jax(op):
    rng = np.random.RandomState(6)
    x = rng.randint(0, 3, (4, 3)).astype(np.int64)
    y = rng.randint(0, 3, (4, 3)).astype(np.int64)
    _op_parity(op, {"X": x, "Y": y}, {})
    _op_parity(op, {"X": x.astype(np.float32), "Y": y.astype(np.float32)},
               {})


@pytest.mark.parametrize("op", ["logical_and", "logical_or", "logical_xor",
                                "logical_not"])
def test_a_logical_op_matches_jax(op):
    rng = np.random.RandomState(7)
    ins = {"X": rng.rand(4, 3) > 0.5}
    if op != "logical_not":
        ins["Y"] = rng.rand(4, 3) > 0.5
    _op_parity(op, ins, {})


@pytest.mark.parametrize("op", ["reduce_sum", "reduce_mean", "reduce_max",
                                "reduce_min", "reduce_prod"])
@pytest.mark.parametrize("attrs", [
    {"dim": [0], "keep_dim": False, "reduce_all": True},
    {"dim": [1], "keep_dim": True, "reduce_all": False},
    {"dim": [0, 2], "keep_dim": False, "reduce_all": False},
    {"dim": [-1], "keep_dim": False, "reduce_all": False}])
def test_a_reduce_op_matches_jax(op, attrs):
    _op_parity(op, {"X": _x(8, (2, 3, 4), 0.5, 1.5)}, attrs, ["X"])


@pytest.mark.parametrize("soft", [False, True])
def test_a_cross_entropy_matches_jax(soft):
    rng = np.random.RandomState(9)
    p = rng.rand(5, 4).astype(np.float32) + 0.05
    p /= p.sum(-1, keepdims=True)
    if soft:
        lab = rng.rand(5, 4).astype(np.float32)
        lab /= lab.sum(-1, keepdims=True)
    else:
        lab = rng.randint(0, 4, (5, 1)).astype(np.int64)
    _op_parity("cross_entropy", {"X": p, "Label": lab},
               {"soft_label": soft}, ["X"], out_slots=("Y",))


TENSOR_OPS = [
    ("concat", {"X": _x(10, (2, 3))}, {"axis": 1}, ["X"]),
    ("split", {"X": _x(11, (4, 6))}, {"axis": 1, "sections": [1, 2, 3]},
     None),
    ("split", {"X": _x(11, (4, 6))}, {"axis": 0, "num": 2}, None),
    ("fill_constant_batch_size_like", {"Input": _x(12, (5, 3))},
     {"shape": [-1, 7], "dtype": "float32", "value": 1.5,
      "input_dim_idx": 0, "output_dim_idx": 0}, []),
    ("fill_zeros_like", {"X": _x(13, (2, 3))}, {}, []),
    ("shape", {"Input": _x(14, (2, 3, 4))}, {}, []),
    ("increment", {"X": np.array([3], np.int64)}, {"step": 2.0}, []),
    ("increment", {"X": _x(15, (1,))}, {"step": 0.5}, ["X"]),
    ("expand", {"X": _x(16, (2, 1, 3))}, {"expand_times": [1, 4, 2]},
     ["X"]),
    ("fill", {}, {"shape": [2, 2], "value": [1.0, 2.0, 3.0, 4.0],
                  "dtype": "float32"}, []),
    ("lod_tensor_to_array", {"X": _x(17, (2, 3, 4))}, {}, ["X"]),
    ("array_to_lod_tensor", {"X": _x(18, (3, 2, 4))}, {}, ["X"]),
    ("scale", {"X": _x(19, (2, 3))}, {"scale": 2.5, "bias": 0.5}, ["X"]),
    ("scale", {"X": _x(19, (2, 3))},
     {"scale": 2.5, "bias": 0.5, "bias_after_scale": False}, ["X"]),
    ("slice", {"Input": _x(20, (4, 5, 6))},
     {"axes": [0, 2], "starts": [1, -4], "ends": [3, 100]}, []),
]


@pytest.mark.parametrize("op,ins,attrs,diff", TENSOR_OPS,
                         ids=[f"{t[0]}{i}" for i, t in
                              enumerate(TENSOR_OPS)])
def test_a_tensor_op_matches_jax(op, ins, attrs, diff):
    if op == "split":
        ctx = EmitCtx(device="cpu")
        got = run_forward(ctx, op, {"X": [torch.from_numpy(ins["X"])]},
                          attrs)["Out"]
        want = jax_op_info(op).forward(None, {"X": [jnp.asarray(ins["X"])]},
                                       attrs)["Out"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        return
    _op_parity(op, ins, attrs, diff or ())


def test_a_concat_of_several_matches_jax():
    xs = [_x(21 + i, (2, k)) for i, k in enumerate((1, 3, 2))]
    ctx = EmitCtx(device="cpu")
    tx = [torch.from_numpy(x).requires_grad_() for x in xs]
    out = run_forward(ctx, "concat", {"X": tx}, {"axis": 1})["Out"][0]
    dy = _x(30, tuple(out.shape))
    out.backward(torch.from_numpy(dy))
    fwd = jax_op_info("concat").forward
    jout, vjp = jax.vjp(lambda *a: fwd(None, {"X": list(a)},
                                       {"axis": 1})["Out"],
                        *[jnp.asarray(x) for x in xs])
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    for t, g in zip(tx, vjp(jnp.asarray(dy))):
        np.testing.assert_array_equal(t.grad.numpy(), np.asarray(g))


def test_a_sequence_mask_batch_gather_max_len_match_jax():
    lens = np.array([3, 1, 5, 4], np.int32)
    ref = _x(31, (4, 5, 2))
    for attrs, ins in (({"maxlen": 6, "out_dtype": "float32"}, {"X": lens}),
                       ({"maxlen": -1, "out_dtype": "int32"},
                        {"X": lens, "MaxLenRef": ref})):
        _op_parity("sequence_mask", ins, attrs, out_slots=("Y",))
    x = _x(32, (3, 4, 5))
    idx = np.array([[3, 0], [1, 1], [2, 3]], np.int32)
    _op_parity("batch_gather", {"X": x, "Index": idx}, {}, ["X"])
    _op_parity("max_sequence_len", {"Lengths": lens}, {})


def test_a_rank_table_ops_match_jax():
    lens = np.array([2, 5, 3, 5, 1, 3], np.int32)  # ties keep batch order
    tout, _ = _op_parity("lod_rank_table", {"X": lens, "Lengths": lens}, {})
    np.testing.assert_array_equal(tout["Out"], [1, 3, 2, 5, 0, 4])
    x = _x(33, (6, 3))
    _op_parity("reorder_lod_tensor_by_rank",
               {"X": x, "RankTable": tout["Out"]}, {}, ["X"])


def test_a_array_ops_match_jax():
    arr = _x(34, (4, 2, 3))
    x = _x(35, (2, 3))
    for i in (0, 2, 3, 7):  # 7 clamps to the last slot, as in JAX
        ii = np.array([i], np.int64)
        _op_parity("write_to_array", {"Array": arr, "X": x, "I": ii}, {},
                   ["Array", "X"])
        _op_parity("read_from_array", {"X": arr, "I": ii}, {}, ["X"])
    tout, _ = _port_op("array_length", {"X": arr}, {}, {})
    assert tout["Out"].dtype == np.int64 and tout["Out"].tolist() == [4]
    tout, _ = _port_op("lod_array_length", {"X": arr}, {}, {})
    assert tout["Out"].tolist() == [4]


# --- (b) beam search -----------------------------------------------------

def _beam_parity(pre_ids, pre_scores, logp, beam, end_id):
    ins = {"PreIds": pre_ids, "PreScores": pre_scores, "Scores": logp}
    attrs = {"beam_size": beam, "end_id": end_id, "level": 0}
    t, _ = _port_op("beam_search", ins, attrs, {})
    j, _ = _jax_op("beam_search", ins, attrs, [], {})
    assert t["SelectedIds"].dtype == np.int64
    assert t["ParentIdx"].dtype == np.int32
    np.testing.assert_array_equal(t["SelectedIds"], j["SelectedIds"])
    np.testing.assert_array_equal(t["ParentIdx"], j["ParentIdx"])
    np.testing.assert_array_equal(t["SelectedScores"], j["SelectedScores"])
    return t


def test_b_beam_search_ties_with_finished_beams_match_jax():
    B, K, V, END = 3, 3, 7, 1
    rng = np.random.RandomState(40)
    logp = np.log(rng.dirichlet(np.ones(V), size=(B, K))).astype(np.float32)
    # batch 0: two beams finished on END at equal scores (a tie across
    # parents) and one live beam; batch 1: every beam finished; batch 2:
    # the first step's -1e9 lanes with equal candidates
    pre_ids = np.array([[END, END, 4], [END, END, END], [0, 0, 0]],
                       np.int64)
    pre_scores = np.array([[-2.0, -2.0, -1.5], [-1.0, -3.0, -1.0],
                           [0.0, -1e9, -1e9]], np.float32)
    logp[2, 1:] = logp[2, 0]  # the dead lanes tie with each other
    logp[0, 2, 3] = logp[0, 2, 5]  # a tie inside the live beam
    t = _beam_parity(pre_ids, pre_scores, logp, K, END)
    # finished beams come back as END at their own score, lower parent
    # first on a tie
    assert t["SelectedIds"][1].tolist() == [END, END, END]
    assert t["ParentIdx"][1].tolist() == [0, 2, 1]


def test_b_beam_search_with_candidate_ids_matches_jax():
    B, K, V = 2, 2, 5
    rng = np.random.RandomState(41)
    ins = {"PreIds": np.array([[3, 1], [2, 4]], np.int64),
           "PreScores": rng.randn(B, K).astype(np.float32),
           "Scores": rng.randn(B, K, V).astype(np.float32),
           "Ids": rng.randint(0, 50, (B, K, V)).astype(np.int64)}
    attrs = {"beam_size": 2, "end_id": 1, "level": 0}
    t, _ = _port_op("beam_search", ins, attrs, {})
    j, _ = _jax_op("beam_search", ins, attrs, [], {})
    for s in ("SelectedIds", "ParentIdx", "SelectedScores"):
        np.testing.assert_array_equal(t[s], j[s], err_msg=s)


def test_b_beam_search_decode_matches_jax():
    T, B, K, END = 6, 2, 3, 1
    rng = np.random.RandomState(42)
    ins = {"Ids": rng.randint(0, 5, (T, B, K)).astype(np.int64),
           "Scores": rng.randn(T, B, K).astype(np.float32),
           "Parents": rng.randint(0, K, (T, B, K)).astype(np.int32)}
    t, _ = _port_op("beam_search_decode", ins, {"end_id": END}, {})
    j, _ = _jax_op("beam_search_decode", ins, {"end_id": END}, [], {})
    np.testing.assert_array_equal(t["SentenceIds"], j["SentenceIds"])
    np.testing.assert_array_equal(t["SentenceScores"], j["SentenceScores"])
    assert t["SentenceIds"].dtype == np.int64


# --- (c) programs --------------------------------------------------------

def _same_program(tp, jp):
    """``to_bytes()`` equal, up to one known difference: a var the
    program declares int64 is int64 in the port's bytes, and int32 in
    the JAX package's where its shape inference (no x64) recorded the
    int32 it computes in."""
    tj, jj = json.loads(tp.to_bytes()), json.loads(jp.to_bytes())
    for tb, jb in zip(tj["blocks"], jj["blocks"]):
        for name, jv in jb["vars"].items():
            tv = tb["vars"].get(name)
            if tv and (tv["dtype"], jv["dtype"]) == ("int64", "int32"):
                jv["dtype"] = "int64"
    assert tj == jj


def _persistables(program, scope):
    return {n: np.asarray(scope.find_var(n))
            for n, v in program.global_block().vars.items()
            if v.persistable and scope.find_var(n) is not None}


def _run_both(build, feed, fetch=None, init=None, runs=1):
    """Build with each package (program bytes equal), run the JAX
    startup, copy its persistables (and ``init``) into the port's scope,
    and run the main program ``runs`` times in each. ``fetch`` defaults
    to the names ``build`` returns. Returns the fetches of the last run:
    (jax, port)."""
    out = {}
    for pkg in (JAX, PORT):
        _, fluid, layers, unique_name = pkg
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 3
        with unique_name.guard(), fluid.program_guard(main, startup):
            names = build(fluid, layers)
        out[pkg] = (main, startup)
        fetch = names if fetch is None else fetch
    (jm, js), (tm, ts) = out[JAX], out[PORT]
    _same_program(tm, jm)
    _same_program(ts, js)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    for k, v in (init or {}).items():
        jscope.set_var(k, jnp.asarray(v))
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    tfluid.params_from_jax(_persistables(jm, jscope), tscope, device="cpu")
    for k, v in (init or {}).items():
        tscope.set_var(k, torch.from_numpy(np.array(v)))
    for _ in range(runs):
        j = jexe.run(jm, feed=feed, fetch_list=fetch, scope=jscope)
        t = texe.run(tm, feed=feed, fetch_list=fetch, scope=tscope)
    return [np.asarray(v) for v in j], [np.asarray(v) for v in t]


def _close(j, t, names=None):
    for i, (a, b) in enumerate(zip(j, t)):
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL,
                                   err_msg=str(names[i] if names else i))


def _doubling_while(fluid, layers, max_steps, n_fed, scale=2.0, pname="w"):
    x = layers.data(name="x", shape=[4], dtype="float32")
    y = layers.fc(input=x, size=4, param_attr=pname, bias_attr=False)
    i = layers.fill_constant(shape=[1], dtype="int64", value=0)
    if n_fed:
        n = layers.data(name="n_steps", shape=[1], dtype="int64",
                        append_batch_size=False)
    else:
        n = layers.fill_constant(shape=[1], dtype="int64", value=3)
    cond = layers.less_than(i, n)
    w = layers.While(cond, max_steps=max_steps)
    with w.block():
        y2 = layers.scale(y, scale=scale)
        layers.assign(y2, y)
        layers.increment(i, value=1, in_place=True)
        layers.less_than(i, n, cond=cond)
    loss = layers.mean(y)
    fluid.optimizer.SGD(learning_rate=0.0).minimize(loss)
    return y


def test_c_while_forward_unbounded_matches_jax():
    def build(fluid, layers):
        i = layers.fill_constant(shape=[1], dtype="int64", value=0)
        n = layers.fill_constant(shape=[1], dtype="int64", value=5)
        acc = layers.fill_constant(shape=[1], dtype="float32", value=0.0)
        cond = layers.less_than(i, n)
        w = layers.While(cond)
        with w.block():
            layers.assign(layers.scale(acc, scale=1.0, bias=2.0), acc)
            layers.increment(i, value=1, in_place=True)
            layers.less_than(i, n, cond=cond)
        return [acc.name, i.name]

    j, t = _run_both(build, {})
    assert float(t[0].ravel()[0]) == 10.0 and t[1].tolist() == [5]
    _close(j, t)


@pytest.mark.parametrize("max_steps,n", [(0, 3), (0, 5), (0, 0), (8, None)])
def test_c_while_backward_matches_jax(max_steps, n):
    """loss = mean(x @ W doubled n times): dW = 2^n x^T 1/8, through an
    unbounded While (n fed at run time; n = 0 runs no iteration) and a
    While(max_steps=8) whose loop exits after 3."""
    x_np = np.ones((2, 4), np.float32)
    feed = {"x": x_np}
    if n is not None:
        feed["n_steps"] = np.array([n], np.int64)
    j, t = _run_both(
        lambda fluid, layers: _doubling_while(fluid, layers, max_steps,
                                              n is not None),
        feed, ["w@GRAD"], init={"w": np.eye(4, dtype=np.float32)})
    _close(j, t)
    trips = 3 if n is None else n
    np.testing.assert_allclose(
        t[0], 2.0 ** trips * x_np.T @ np.full((2, 4), 1 / 8, np.float32),
        rtol=1e-6)


@pytest.mark.parametrize("max_steps", [0, 12])
def test_c_while_step_evals_count_the_forward_only(max_steps):
    """FLAGS['count_while_step_evals'] counts body evaluations: T for an
    unbounded loop of T iterations, forward and backward together (the
    gradient pulls back through the recorded iterations; the JAX
    package's unbounded grad replays ~3T more), max_steps for a bounded
    one."""
    T = 7
    x_np = np.ones((2, 4), np.float32)
    for pkg in (PORT,):
        _, fluid, layers, unique_name = pkg
        main, startup = fluid.Program(), fluid.Program()
        with unique_name.guard(), fluid.program_guard(main, startup):
            _doubling_while(fluid, layers, max_steps, True, scale=1.01)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    scope.set_var("w", torch.eye(4))
    tset_flags({"count_while_step_evals": True})
    try:
        tcf.step_evals_reset()
        (g,) = exe.run(main, feed={"x": x_np,
                                   "n_steps": np.array([T], np.int64)},
                       fetch_list=["w@GRAD"], scope=scope)
        evals = tcf.step_evals()
    finally:
        tset_flags({"count_while_step_evals": False})
    assert evals == (max_steps or T)
    trips = min(T, max_steps) if max_steps else T
    np.testing.assert_allclose(
        g, 1.01 ** trips * x_np.T @ np.full((2, 4), 1 / 8, np.float32),
        rtol=1e-5)


def test_c_while_counts_host_syncs():
    """An unbounded While reads its condition once an iteration and once
    at the exit; a bounded one never."""
    from paddle_tpu_torch.observability import metrics

    syncs = metrics.counter("fluid.control_flow.host_syncs")
    for max_steps, want in ((0, 6), (9, 0)):
        main, startup = tfluid.Program(), tfluid.Program()
        with tunique.guard(), tfluid.program_guard(main, startup):
            _doubling_while(tfluid, tlayers, max_steps, True)
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(startup, scope=scope)
        before = syncs.value()
        exe.run(main, feed={"x": np.ones((2, 4), np.float32),
                            "n_steps": np.array([5], np.int64)},
                fetch_list=["w@GRAD"], scope=scope)
        assert syncs.value() - before == want


def test_c_ifelse_matches_jax():
    x_np = np.array([[1, 1, 1, 1], [-1, -1, -1, -1], [2, -1, 0, 0],
                     [0.5, -2, 1, 0.25]], np.float32)

    def build(fluid, layers):
        x = layers.data(name="x", shape=[4], dtype="float32")
        x.stop_gradient = False
        s = layers.reduce_sum(x, dim=1, keep_dim=True)
        zero = layers.fill_constant(shape=[1], dtype="float32", value=0.0)
        cond = layers.less_than(zero, s)
        ie = layers.IfElse(cond)
        with ie.true_block():
            d = ie.input(x)
            ie.output(layers.fc(d, size=3, param_attr="ie_w",
                                bias_attr=False, act="tanh"))
        with ie.false_block():
            d = ie.input(x)
            ie.output(layers.elementwise_add(
                layers.scale(layers.fc(d, size=3, param_attr="ie_w",
                                       bias_attr=False), scale=-1.0),
                layers.cast(cond, "float32")))
        (merged,) = ie()
        loss = layers.reduce_sum(layers.square(merged))
        fluid.backward.append_backward(loss, parameter_list=["x", "ie_w"])
        return [merged.name, "x@GRAD", "ie_w@GRAD"]

    j, t = _run_both(build, {"x": x_np})
    _close(j, t, ["out", "x@GRAD", "ie_w@GRAD"])


@pytest.mark.parametrize("flag", [True, False])
def test_c_conditional_block_matches_jax(flag):
    def build(fluid, layers):
        x = layers.data(name="x", shape=[2], dtype="float32")
        x.stop_gradient = False
        f = layers.fill_constant(shape=[1], dtype="bool", value=flag)
        y = layers.scale(x, scale=1.0)
        cb = layers.ConditionalBlock([f])
        with cb.block():
            layers.assign(layers.scale(y, scale=4.0), y)
        loss = layers.reduce_sum(layers.square(y))
        fluid.backward.append_backward(loss, parameter_list=["x"])

    x_np = np.array([[1.0, -2.0]], np.float32)
    j, t = _run_both(build, {"x": x_np}, ["x@GRAD"])
    _close(j, t)
    np.testing.assert_allclose(t[0], 2 * x_np * (16.0 if flag else 1.0))


@pytest.mark.parametrize("step", [0, 4, 9])
def test_c_switch_matches_jax(step):
    """A piecewise value by Switch (the learning-rate schedulers' form):
    case step < 3, case step < 6, default."""
    def build(fluid, layers):
        s = layers.data(name="step", shape=[1], dtype="float32",
                        append_batch_size=False)
        lr = layers.fill_constant(shape=[1], dtype="float32", value=0.0)
        b1 = layers.fill_constant(shape=[1], dtype="float32", value=3.0)
        b2 = layers.fill_constant(shape=[1], dtype="float32", value=6.0)
        with layers.Switch() as switch:
            with switch.case(layers.less_than(s, b1)):
                layers.assign(layers.fill_constant(
                    shape=[1], dtype="float32", value=1.0), lr)
            with switch.case(layers.less_than(s, b2)):
                layers.assign(layers.fill_constant(
                    shape=[1], dtype="float32", value=0.5), lr)
            with switch.default():
                layers.assign(layers.fill_constant(
                    shape=[1], dtype="float32", value=0.1), lr)
        return [lr.name]

    j, t = _run_both(build, {"step": np.array([step], np.float32)})
    _close(j, t)
    assert t[0][0] == np.float32({0: 1.0, 4: 0.5, 9: 0.1}[step])


def test_c_static_rnn_matches_jax():
    N, T, D, H = 3, 4, 2, 5
    rng = np.random.RandomState(50)
    feed = {"x": rng.randn(N, T, D).astype(np.float32),
            "h0": rng.randn(N, H).astype(np.float32)}

    def build(fluid, layers):
        x = layers.data(name="x", shape=[T, D], dtype="float32")
        h0 = layers.data(name="h0", shape=[H], dtype="float32")
        rnn = layers.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            hp = rnn.memory(init=h0)
            h = layers.fc(input=[xt, hp], size=H, act="tanh",
                          param_attr=["srnn_wx", "srnn_wh"])
            rnn.update_memory(hp, h)
            rnn.step_output(h)
        out = rnn()
        loss = layers.mean(layers.square(out))
        fluid.optimizer.SGD(learning_rate=0.0).minimize(loss)
        return [out.name, "srnn_wx@GRAD", "srnn_wh@GRAD"]

    names = ["out", "srnn_wx@GRAD", "srnn_wh@GRAD"]
    j, t = _run_both(build, feed)
    _close(j, t, names)


def _drnn_program(fluid, layers, H=5, act="tanh", static=True):
    x = layers.data(name="x", shape=[3], dtype="float32", lod_level=1)
    bias = layers.data(name="bias", shape=[3], dtype="float32")
    label = layers.data(name="label", shape=[1], dtype="int64")
    drnn = layers.DynamicRNN()
    with drnn.block():
        x_t = drnn.step_input(x)
        h_prev = drnn.memory(shape=[H], value=0.0)
        if static:
            x_t = layers.elementwise_add(x=x_t, y=drnn.static_input(bias))
        h = layers.fc(input=[x_t, h_prev], size=H, act=act,
                      param_attr=["drnn_wx", "drnn_wh"], bias_attr="drnn_b")
        drnn.update_memory(h_prev, h)
        drnn.output(h)
    out = drnn()
    last = layers.sequence_last_step(out)
    logit = layers.fc(input=last, size=2, param_attr="drnn_out")
    loss = layers.mean(layers.softmax_with_cross_entropy(logits=logit,
                                                         label=label))
    fluid.optimizer.Adam(learning_rate=0.05).minimize(loss)
    return out, last, loss


def test_c_dynamic_rnn_ragged_matches_jax():
    N, T = 5, 6
    rng = np.random.RandomState(51)
    feed = {"x": rng.randn(N, T, 3).astype(np.float32),
            "x@LEN": np.array([6, 1, 3, 6, 2], np.int32),  # 1 and T
            "bias": 0.1 * rng.randn(N, 3).astype(np.float32),
            "label": rng.randint(0, 2, (N, 1)).astype(np.int64)}
    names = ["out", "last", "loss", "drnn_wx@GRAD", "drnn_wh@GRAD",
             "drnn_b@GRAD", "drnn_out@GRAD"]

    def build(fluid, layers):
        out, last, loss = _drnn_program(fluid, layers)
        return [out.name, last.name, loss.name] + names[3:]

    j, t = _run_both(build, feed, runs=3)
    _close(j, t, names)
    out = t[0]
    pad = np.arange(T)[None, :] >= feed["x@LEN"][:, None]
    assert not out[pad].any() and out[~pad].all()
    np.testing.assert_array_equal(
        t[1], out[np.arange(N), feed["x@LEN"] - 1])


def test_c_arrays_in_a_while_match_jax():
    """create_array / array_write / array_read / array_length in a
    While(max_steps): a running sum of squared rows written step by
    step, and its gradient."""
    T = 5

    def build(fluid, layers):
        x = layers.data(name="x", shape=[T, 3], dtype="float32",
                        append_batch_size=False)
        x.stop_gradient = False
        arr = layers.create_array("float32", T + 1, [3])
        arr.stop_gradient = False  # its writes carry x's gradient
        i = layers.zeros(shape=[1], dtype="int64")
        n = layers.fill_constant(shape=[1], dtype="int64", value=T)
        cond = layers.less_than(i, n)
        w = layers.While(cond, max_steps=T + 2)
        with w.block():
            row = layers.array_read(x, i)  # x [T, 3] read as an array
            prev = layers.array_read(arr, i)
            layers.increment(i, value=1)
            layers.array_write(layers.elementwise_add(
                prev, layers.square(row)), i, arr)
            layers.less_than(i, n, cond=cond)
        length = layers.array_length(arr)
        loss = layers.reduce_sum(arr)
        fluid.backward.append_backward(loss, parameter_list=["x"])
        return [arr.name, length.name, "x@GRAD"]

    rng = np.random.RandomState(52)
    feed = {"x": rng.randn(T, 3).astype(np.float32)}
    j, t = _run_both(build, feed)
    _close([j[0], j[2]], [t[0], t[2]])
    assert t[1].tolist() == [T + 1]
    np.testing.assert_allclose(t[0][T], (feed["x"] ** 2).sum(0), rtol=1e-6)
    # row r is in the sums written after it: T - r of them
    np.testing.assert_allclose(
        t[2], 2 * feed["x"] * np.arange(T, 0, -1)[:, None], rtol=1e-6)


def test_c_rank_table_reorder_max_len_zeros_like_equal_match_jax():
    def build(fluid, layers):
        x = layers.data(name="x", shape=[2], dtype="float32", lod_level=1)
        table = layers.lod_rank_table(x)
        re = layers.reorder_lod_tensor_by_rank(x, table)
        mx = layers.max_sequence_len(x)
        zeros = layers.zeros_like_array(re)
        same = layers.equal(mx, layers.fill_constant(
            shape=[1], dtype="int32", value=5))
        return [table.name, re.name, mx.name, zeros.name, same.name]

    rng = np.random.RandomState(53)
    feed = {"x": rng.randn(4, 5, 2).astype(np.float32),
            "x@LEN": np.array([2, 5, 3, 5], np.int32)}
    j, t = _run_both(build, feed)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b, a)
    assert t[0].tolist() == [1, 3, 2, 0] and t[2].tolist() == [5]
    assert not t[3].any() and t[3].shape == (4, 5, 2)
    assert t[4].tolist() == [True]


def test_c_print_passes_values_and_gradients_through(capsys):
    def build(fluid, layers):
        x = layers.data(name="x", shape=[3], dtype="float32")
        x.stop_gradient = False
        p = layers.Print(x, message="tap", summarize=2)
        loss = layers.reduce_sum(layers.square(p))
        fluid.backward.append_backward(loss, parameter_list=["x"])
        return [p.name, "x@GRAD"]

    x_np = np.array([[1.0, -2.0, 3.0]], np.float32)
    j, t = _run_both(build, {"x": x_np})
    _close(j, t)
    np.testing.assert_array_equal(t[0], x_np)
    printed = capsys.readouterr().out
    assert "tap [forward]" in printed and "tap [backward]" in printed


# --- (d) a parameter read only inside a sub-block ------------------------

def _inner_only(kind):
    """A loss whose one parameter 'inner_w' is read only inside the
    sub-block of a DynamicRNN, a While(max_steps) or a StaticRNN."""
    def build(fluid, layers):
        x = layers.data(name="x", shape=[4], dtype="float32", lod_level=1)
        if kind == "dynamic_rnn":
            drnn = layers.DynamicRNN()
            with drnn.block():
                xt = drnn.step_input(x)
                hp = drnn.memory(shape=[4], value=0.0)
                h = layers.fc(input=layers.elementwise_add(xt, hp), size=4,
                              act="tanh", param_attr="inner_w",
                              bias_attr=False)
                drnn.update_memory(hp, h)
                drnn.output(h)
            out = layers.sequence_last_step(drnn())
        elif kind == "static_rnn":
            h0 = layers.fill_constant_batch_size_like(
                input=x, shape=[-1, 4], dtype="float32", value=0.0)
            rnn = layers.StaticRNN()
            with rnn.step():
                xt = rnn.step_input(x)
                hp = rnn.memory(init=h0)
                h = layers.fc(input=layers.elementwise_add(xt, hp), size=4,
                              act="tanh", param_attr="inner_w",
                              bias_attr=False)
                rnn.update_memory(hp, h)
                rnn.step_output(h)
            out = rnn()
        else:
            h = layers.sequence_last_step(x)
            i = layers.fill_constant(shape=[1], dtype="int64", value=0)
            n = layers.fill_constant(shape=[1], dtype="int64", value=3)
            cond = layers.less_than(i, n)
            w = layers.While(cond, max_steps=5)
            with w.block():
                layers.assign(layers.fc(input=h, size=4, act="tanh",
                                        param_attr="inner_w",
                                        bias_attr=False), h)
                layers.increment(i, value=1, in_place=True)
                layers.less_than(i, n, cond=cond)
            out = h
        loss = layers.mean(layers.square(out))
        fluid.optimizer.SGD(learning_rate=0.0).minimize(loss)

    return build


@pytest.mark.parametrize("kind", ["dynamic_rnn", "while_max_steps",
                                  "static_rnn"])
def test_d_parameter_read_only_inside_a_sub_block_gets_its_gradient(kind):
    rng = np.random.RandomState(60)
    feed = {"x": rng.randn(3, 5, 4).astype(np.float32),
            "x@LEN": np.array([5, 2, 4], np.int32)}
    if kind == "static_rnn":
        feed.pop("x@LEN")
    j, t = _run_both(_inner_only(kind), feed, ["inner_w@GRAD"])
    assert np.abs(t[0]).max() > 1e-3  # not the zeros of a no-grad run
    _close(j, t)


# --- (e) bf16 DynamicRNN gradient against float64 -------------------------

def test_e_dynamic_rnn_grad_bf16_mixed_exit_steps_vs_f64():
    N, T, D, H = 4, 5, 3, 4
    main, startup = tfluid.Program(), tfluid.Program()
    main.random_seed = startup.random_seed = 17
    with tunique.guard(), tfluid.program_guard(main, startup):
        x = tlayers.data(name="x", shape=[D], dtype="float32", lod_level=1)
        drnn = tlayers.DynamicRNN()
        with drnn.block():
            x_t = drnn.step_input(x)
            h_prev = drnn.memory(shape=[H], value=0.0)
            hx = tlayers.fc(input=x_t, size=H, bias_attr=False,
                            param_attr="bf16.wx")
            hh = tlayers.fc(input=h_prev, size=H, bias_attr=False,
                            param_attr="bf16.wh")
            h = tlayers.tanh(tlayers.elementwise_add(x=hx, y=hh))
            drnn.update_memory(h_prev, h)
            drnn.output(h)
        loss = tlayers.mean(tlayers.sequence_last_step(drnn()))
        tfluid.optimizer.SGD(learning_rate=0.0).minimize(loss)

    rng = np.random.RandomState(2)
    x_np = rng.uniform(-1, 1, (N, T, D)).astype(np.float32)
    lens = np.array([5, 2, 3, 1], np.int32)
    wx0 = rng.uniform(-0.5, 0.5, (D, H)).astype(np.float32)
    wh0 = rng.uniform(-0.5, 0.5, (H, H)).astype(np.float32)
    exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    exe.run(startup, scope=scope)
    scope.set_var("bf16.wx", torch.from_numpy(wx0))
    scope.set_var("bf16.wh", torch.from_numpy(wh0))
    tset_flags({"amp": True})
    try:
        gwx, gwh = exe.run(main, feed={"x": x_np, "x@LEN": lens},
                           fetch_list=["bf16.wx@GRAD", "bf16.wh@GRAD"],
                           scope=scope)
    finally:
        tset_flags({"amp": False})

    def f64_loss(wx, wh):
        last = np.zeros((N, H))
        for i in range(N):
            h = np.zeros(H)
            for t in range(int(lens[i])):
                h = np.tanh(x_np[i, t].astype(np.float64) @ wx + h @ wh)
            last[i] = h
        return last.mean()

    def numeric(which, eps=1e-5):
        base = {"wx": wx0.astype(np.float64), "wh": wh0.astype(np.float64)}
        g = np.zeros_like(base[which])
        for idx in np.ndindex(g.shape):
            up, dn = dict(base), dict(base)
            up[which] = base[which].copy()
            dn[which] = base[which].copy()
            up[which][idx] += eps
            dn[which][idx] -= eps
            g[idx] = (f64_loss(up["wx"], up["wh"])
                      - f64_loss(dn["wx"], dn["wh"])) / (2 * eps)
        return g

    for got, which in ((gwx, "wx"), (gwh, "wh")):
        want = numeric(which)
        rel = np.abs(got.astype(np.float64) - want).max() / (
            np.abs(want).max() + 1e-8)
        assert rel < BF16_TOL, (which, rel)
        assert rel > 0  # the products did run in bf16
