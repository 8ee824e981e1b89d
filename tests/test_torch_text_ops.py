"""The port's recurrent, sequence, CRF, CTC and text-metric ops
(``fluid/ops/sequence_ops.py``, ``vision_ops.py``, ``crf_ops.py``,
``ctc_ops.py``, ``metric_ops.py``, ``nn_ops.py``, ``math_ops.py``,
``tensor_ops.arg_max``) against the JAX package's, on the CPU.

Each op alone on seeded numpy inputs, ragged lengths among them (1 and
T), both ``is_reverse`` settings for the recurrent ops and zero-length
label rows for CTC: the outputs, and for a differentiable op the input
gradients through the port's record-and-grad path against the JAX op's
``jax.vjp`` for seeded cotangents.

Tolerances (float32; XLA and PyTorch sum in other orders): outputs rtol
1e-5 / atol 1e-6, gradients rtol 1e-4 / atol 1e-5. Integer outputs
(``crf_decoding``, ``ctc_align``, ``edit_distance``, ``chunk_eval``'s
counts, the ``@LEN`` outputs, ``arg_max``) exactly equal; an int64 result
of the port may meet the int32 the JAX package computes without x64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.fluid.registry import OPS as JAX_OPS
from paddle_tpu.fluid.registry import get_op_info as jax_op_info
from paddle_tpu_torch.fluid.registry import (
    FWD_META_ATTR, OPS, EmitCtx, forward_with_grad, run_forward, run_grad)

FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5

# the op types this slice adds to the port (arg_max comes with them:
# ctc_greedy_decoder's argmax runs it)
NEW_OPS = {
    "gru", "lstm_unit", "gru_unit", "lstmp", "sequence_conv",
    "context_project", "sequence_expand", "sequence_reverse",
    "sequence_slice", "sequence_concat", "sequence_reshape",
    "sequence_erase", "lod_reset", "sequence_softmax", "im2sequence",
    "row_conv", "cos_sim", "linear_chain_crf", "crf_decoding", "warpctc",
    "ctc_align", "edit_distance", "chunk_eval", "arg_max",
}
OPS_BEFORE = 129  # op types the port's own modules registered before
# op types the later slices registered: 27 of image and vision
# (tests/test_torch_detection.py holds them), 32 of the rest of Fluid
# (tests/test_torch_fluid_rest.py), 3 of the mesh layer (get_places,
# parallel_do, moe_ffn: tests/test_torch_mesh.py), 2 of the pipeline
# region (pipeline, pipeline_cut: tests/test_torch_pipeline.py)
OPS_AFTER = 27 + 32 + 3 + 2


def _as_list(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


def _port_op(op_type, ins, attrs, dys):
    """Outputs, and with cotangents ``dys`` the input gradients."""
    ctx = EmitCtx(device="cpu", root_seed=1)
    tins = {s: [torch.from_numpy(np.array(a)) for a in _as_list(v)]
            for s, v in ins.items()}
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
            {s[5:]: [g.numpy() for g in v] for s, v in grads.items()
             if v and v[0] is not None})


def _jax_op(op_type, ins, attrs, diff_slots, dys):
    fwd = jax_op_info(op_type).forward
    paths = [(s, i) for s in diff_slots for i in range(len(_as_list(ins[s])))]

    def fn(*diffs):
        full = {s: [jnp.asarray(a) for a in _as_list(v)]
                for s, v in ins.items()}
        for (s, i), d in zip(paths, diffs):
            full[s][i] = d
        return fwd(None, full, attrs)

    primals = [jnp.asarray(_as_list(ins[s])[i]) for s, i in paths]
    outs = {s: np.asarray(v[0] if isinstance(v, list) else v)
            for s, v in jax.jit(fn)(*primals).items()}
    if not dys:
        return outs, {}
    _, vjp = jax.vjp(jax.jit(lambda *d: {s: fn(*d)[s] for s in dys}),
                     *primals)
    grads = {}
    for (s, _), g in zip(paths, vjp({s: jnp.asarray(d)
                                     for s, d in dys.items()})):
        grads.setdefault(s, []).append(np.asarray(g))
    return outs, grads


def _same(t, j, s, exact):
    if (t.dtype, j.dtype) != (np.int64, np.int32):
        assert t.dtype == j.dtype, (s, t.dtype, j.dtype)
    assert t.shape == j.shape, (s, t.shape, j.shape)
    if exact or t.dtype.kind in "iub":
        np.testing.assert_array_equal(t, j, err_msg=s)
    else:
        np.testing.assert_allclose(t, j, rtol=FWD_RTOL, atol=FWD_ATOL,
                                   err_msg=s)


def _op_parity(op_type, ins, attrs, diff_slots=(), out_slots=("Out",),
               exact=(), seed=0):
    """Both packages' op on the same inputs: ``out_slots`` within the
    output tolerance (``exact`` ones equal), and for ``diff_slots`` the
    gradients for seeded normal cotangents on the float ``out_slots``."""
    tout0, _ = _port_op(op_type, ins, attrs, {})
    rng = np.random.RandomState(seed + 100)
    dys = {s: rng.randn(*tout0[s].shape).astype(tout0[s].dtype)
           for s in out_slots if tout0[s].dtype.kind == "f"} \
        if diff_slots else {}
    tout, tgrads = _port_op(op_type, ins, attrs, dys)
    jout, jgrads = _jax_op(op_type, ins, attrs, list(diff_slots), dys)
    for s in out_slots:
        _same(tout[s], jout[s], s, s in exact)
    for s in diff_slots:
        for i, (tg, jg) in enumerate(zip(tgrads[s], jgrads[s])):
            np.testing.assert_allclose(tg, jg, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL,
                                       err_msg=f"grad {s}[{i}]")
    return tout, tgrads


def _randn(rng, *shape, scale=1.0):
    return (scale * rng.randn(*shape)).astype(np.float32)


def test_registry_gains_the_slice_op_types():
    """The port's modules register exactly the slice's op types more
    (other test files register probe ops of their own in a worker's
    process: those are not counted)."""
    own = {t for t, info in OPS.items()
           if info.forward.__module__.startswith("paddle_tpu_torch.")}
    assert NEW_OPS <= set(JAX_OPS)
    assert NEW_OPS <= own, sorted(NEW_OPS - own)
    assert len(own) == OPS_BEFORE + len(NEW_OPS) + OPS_AFTER
    tested = {case[0] for case in CASES} | {"arg_max"}
    assert tested == NEW_OPS, sorted(NEW_OPS - tested)


# --- recurrent ops ----------------------------------------------------------

LENS = np.array([6, 1, 3, 4], np.int32)  # N 4, T 6: 1 and T among them


@pytest.mark.parametrize("rev", [False, True])
@pytest.mark.parametrize("acts,h0", [(("sigmoid", "tanh"), False),
                                     (("tanh", "relu"), True)])
def test_gru_matches_jax(rev, acts, h0):
    rng = np.random.RandomState(5)
    N, T, H = 4, 6, 5
    ins = {"Input": _randn(rng, N, T, 3 * H),
           "Weight": _randn(rng, H, 3 * H, scale=0.5),
           "Bias": _randn(rng, 3 * H, scale=0.5), "Lengths": LENS}
    if h0:
        ins["H0"] = _randn(rng, N, H)
    attrs = {"is_reverse": rev, "gate_activation": acts[0],
             "activation": acts[1]}
    out, _ = _op_parity("gru", ins, attrs,
                        ["Input", "Weight", "Bias"] + (["H0"] if h0 else []),
                        ("Hidden", "BatchGate", "BatchResetHiddenPrev",
                         "BatchHidden"))
    pad = np.arange(T)[None, :] >= LENS[:, None]
    assert not out["Hidden"][pad].any()


@pytest.mark.parametrize("peep,rev,h0", [(False, False, False),
                                         (True, False, True),
                                         (True, True, False),
                                         (False, True, True)])
def test_lstmp_matches_jax(peep, rev, h0):
    rng = np.random.RandomState(9)
    N, T, H, P = 4, 6, 5, 3
    ins = {"Input": _randn(rng, N, T, 4 * H),
           "Weight": _randn(rng, P, 4 * H, scale=0.5),
           "ProjWeight": _randn(rng, H, P, scale=0.5),
           "Bias": _randn(rng, 1, (7 if peep else 4) * H, scale=0.5),
           "Lengths": LENS}
    if h0:
        ins["H0"] = _randn(rng, N, H)
        ins["C0"] = _randn(rng, N, H)
    attrs = {"use_peepholes": peep, "is_reverse": rev,
             "gate_activation": "sigmoid", "cell_activation": "tanh",
             "candidate_activation": "tanh",
             "proj_activation": "relu" if h0 else "tanh"}
    diff = ["Input", "Weight", "ProjWeight", "Bias"] + (["H0", "C0"]
                                                        if h0 else [])
    _op_parity("lstmp", ins, attrs, diff,
               ("Projection", "Cell", "BatchedProjection", "BatchedCell",
                "BatchedInput", "OrderedP0"))


@pytest.mark.parametrize("forget_bias", [0.0, 1.0])
def test_lstm_unit_matches_jax(forget_bias):
    rng = np.random.RandomState(2)
    _op_parity("lstm_unit", {"X": _randn(rng, 3, 20),
                             "C_prev": _randn(rng, 3, 5)},
               {"forget_bias": forget_bias}, ["X", "C_prev"], ("C", "H"))


@pytest.mark.parametrize("gate,act", [(1, 2), (2, 3), (0, 1)])
def test_gru_unit_matches_jax(gate, act):
    rng = np.random.RandomState(4)
    H = 5
    ins = {"Input": _randn(rng, 3, 3 * H), "HiddenPrev": _randn(rng, 3, H),
           "Weight": _randn(rng, H, 3 * H, scale=0.5),
           "Bias": _randn(rng, 1, 3 * H, scale=0.5)}
    _op_parity("gru_unit", ins, {"gate_activation": gate, "activation": act},
               ["Input", "HiddenPrev", "Weight", "Bias"],
               ("Hidden", "Gate", "ResetHiddenPrev"))


# --- every other op: (op, inputs, attrs, diff slots, out slots, exact) -------

def _seq_cases():
    r = np.random.RandomState(11)
    N, T, D = 4, 6, 3
    x = _randn(r, N, T, D)
    ids = r.randint(0, 6, (N, T)).astype(np.int64)
    emission = _randn(r, N, T, 5)
    trans = _randn(r, 7, 5, scale=0.5)
    label = r.randint(0, 5, (N, T)).astype(np.int64)
    # a near-uniform emission: Viterbi decides on small margins
    flat = _randn(r, N, T, 5, scale=1e-3)
    logits = _randn(r, N, 8, 6)
    ctc_lab = np.array([[1, 2, 2, -1], [3, -1, -1, -1],
                        [-1, -1, -1, -1], [5, 4, 3, 1]], np.int64)
    ctc_ids = np.array([[0, 1, 1, 0, 2, 2, 2, 0],
                        [3, 3, 0, 0, 3, 1, 0, 0],
                        [0, 0, 0, 0, 0, 0, 0, 0],
                        [4, 0, 4, 4, 5, 0, 0, 5]], np.int64)
    hyp = r.randint(-1, 5, (N, 7)).astype(np.int64)
    ref = r.randint(-1, 5, (N, 5)).astype(np.int64)
    tags = r.randint(-1, 7, (N, 9)).astype(np.int64)
    gold = r.randint(-1, 7, (N, 9)).astype(np.int64)
    tags9 = r.randint(0, 9, (N, 9)).astype(np.int64)
    gold9 = np.where(r.rand(N, 9) < 0.6, tags9,
                     r.randint(0, 9, (N, 9))).astype(np.int64)
    seq_len9 = np.array([9, 4, 0, 7], np.int64)
    return [
        ("sequence_conv", {"X": x, "Filter": _randn(r, 3 * D, 4),
                           "Lengths": LENS},
         {"contextLength": 3, "contextStart": -1}, ["X", "Filter"],
         ("Out",), ()),
        ("sequence_conv", {"X": x, "Filter": _randn(r, 4 * D, 2)},
         {"contextLength": 4, "contextStart": -2}, ["X", "Filter"],
         ("Out",), ()),
        ("context_project", {"X": x, "Lengths": LENS},
         {"context_length": 5, "context_start": -3}, ["X"], ("Out",), ()),
        ("sequence_expand", {"X": _randn(r, N, D), "Y": x}, {}, ["X"],
         ("Out",), ()),
        ("sequence_expand", {"X": _randn(r, N, 1, D), "Y": x}, {}, ["X"],
         ("Out",), ()),
        ("sequence_reverse", {"X": x, "Lengths": LENS}, {}, ["X"],
         ("Out",), ()),
        ("sequence_reverse", {"X": x}, {}, ["X"], ("Out",), ()),
        ("sequence_slice", {"X": x,
                            "Offset": np.array([0, 2, 1, 3], np.int64),
                            "Length": np.array([2, 3, 0, 3], np.int64)},
         {}, ["X"], ("Out",), ()),
        ("sequence_slice", {"X": x,
                            "Offset": np.array([[0, 4], [1, 1], [2, 5],
                                                [0, 3]], np.int64),
                            "Length": np.array([[1, 2], [2, 1], [1, 1],
                                                [3, 3]], np.int64)},
         {}, ["X"], ("Out",), ()),
        ("sequence_concat", {"X": [x, _randn(r, N, 4, D)],
                             "Lengths": [LENS,
                                         np.array([2, 4, 0, 1], np.int32)]},
         {}, ["X"], ("Out",), ()),
        ("sequence_concat", {"X": [x, _randn(r, N, 2, D)]}, {}, ["X"],
         ("Out",), ()),
        ("sequence_reshape", {"X": _randn(r, N, 6, 4)}, {"new_dim": 8},
         ["X"], ("Out",), ()),
        ("sequence_erase", {"X": ids}, {"tokens": [2, 5]}, [], ("Out",),
         ("Out",)),
        ("lod_reset", {"X": _randn(r, 6, 2)}, {"target_lod": [0, 2, 5, 6]},
         ["X"], ("Out", "OutLengths"), ("OutLengths",)),
        ("lod_reset", {"X": x, "XLengths": LENS, "Y": _randn(r, 5, 5, 1),
                       "YLengths": np.array([5, 3, 1, 4, 1], np.int32)},
         {}, ["X"], ("Out", "OutLengths"), ("OutLengths",)),
        ("sequence_softmax", {"X": _randn(r, N, T), "Lengths": LENS}, {},
         ["X"], ("Out",), ()),
        ("sequence_softmax", {"X": x}, {}, ["X"], ("Out",), ()),
        ("im2sequence", {"X": _randn(r, 2, 3, 5, 6)},
         {"kernels": [2, 3], "strides": [1, 2], "paddings": [1, 0, 0, 1]},
         ["X"], ("Out",), ()),
        ("im2sequence", {"X": _randn(r, 2, 2, 4, 4)},
         {"kernels": [2, 2], "strides": [2, 2], "paddings": [0, 0, 0, 0]},
         ["X"], ("Out",), ()),
        ("row_conv", {"X": x, "Filter": _randn(r, 3, D), "Lengths": LENS},
         {}, ["X", "Filter"], ("Out",), ()),
        ("row_conv", {"X": x, "Filter": _randn(r, 8, D)}, {},
         ["X", "Filter"], ("Out",), ()),
        ("cos_sim", {"X": _randn(r, 5, 7), "Y": _randn(r, 5, 7)}, {},
         ["X", "Y"], ("Out", "XNorm", "YNorm"), ()),
        ("linear_chain_crf", {"Emission": emission, "Transition": trans,
                              "Label": label, "Lengths": LENS},
         {}, ["Emission", "Transition"],
         ("LogLikelihood", "Alpha", "TransitionExps"), ()),
        ("linear_chain_crf", {"Emission": emission, "Transition": trans,
                              "Label": label[:, :, None]},
         {}, ["Emission", "Transition"], ("LogLikelihood",), ()),
        ("crf_decoding", {"Emission": emission, "Transition": trans,
                          "Lengths": LENS}, {}, [], ("ViterbiPath",),
         ("ViterbiPath",)),
        ("crf_decoding", {"Emission": flat, "Transition": trans * 1e-3,
                          "Lengths": LENS}, {}, [], ("ViterbiPath",),
         ("ViterbiPath",)),
        ("crf_decoding", {"Emission": emission, "Transition": trans,
                          "Label": label[:, :, None], "Lengths": LENS},
         {}, [], ("ViterbiPath",), ("ViterbiPath",)),
        ("crf_decoding", {"Emission": emission, "Transition": trans}, {},
         [], ("ViterbiPath",), ("ViterbiPath",)),
        ("warpctc", {"Logits": logits, "Label": ctc_lab,
                     "LogitsLength": np.array([8, 5, 3, 8], np.int64),
                     "LabelLength": np.array([3, 1, 0, 4], np.int64)},
         {"blank": 0}, ["Logits"], ("Loss", "WarpCTCGrad"), ()),
        ("warpctc", {"Logits": logits, "Label": ctc_lab[:, :, None]},
         {"blank": 0, "norm_by_times": True}, ["Logits"], ("Loss",), ()),
        ("warpctc", {"Logits": logits, "Label": np.where(
            ctc_lab < 0, 5, ctc_lab)}, {"blank": 5}, ["Logits"], ("Loss",),
         ()),
        ("ctc_align", {"Input": ctc_ids,
                       "InputLength": np.array([8, 6, 8, 7], np.int64)},
         {"blank": 0}, [], ("Output", "OutputLength"),
         ("Output", "OutputLength")),
        ("ctc_align", {"Input": ctc_ids[:, :, None]},
         {"blank": 0, "merge_repeated": False}, [],
         ("Output", "OutputLength"), ("Output", "OutputLength")),
        ("edit_distance", {"Hyps": hyp, "Refs": ref}, {}, [],
         ("Out", "SequenceNum"), ("Out", "SequenceNum")),
        ("edit_distance", {"Hyps": hyp, "Refs": ref,
                           "HypsLength": np.array([7, 0, 3, 5], np.int64),
                           "RefsLength": np.array([5, 2, 0, 4], np.int64)},
         {"normalized": True, "ignored_tokens": [3]}, [],
         ("Out", "SequenceNum"), ()),
        ("chunk_eval", {"Inference": tags, "Label": gold},
         {"num_chunk_types": 3, "chunk_scheme": "IOB"}, [],
         ("Precision", "Recall", "F1-Score", "NumInferChunks",
          "NumLabelChunks", "NumCorrectChunks"), ()),
        ("chunk_eval", {"Inference": tags, "Label": gold,
                        "SeqLength": np.array([9, 4, 0, 7], np.int64)},
         {"num_chunk_types": 3, "chunk_scheme": "IOE",
          "excluded_chunk_types": [1]}, [],
         ("Precision", "Recall", "F1-Score", "NumInferChunks",
          "NumLabelChunks", "NumCorrectChunks"), ()),
        ("chunk_eval", {"Inference": tags9[:, :, None],
                        "Label": gold9[:, :, None], "SeqLength": seq_len9},
         {"num_chunk_types": 2, "chunk_scheme": "IOBES"}, [],
         ("Precision", "Recall", "F1-Score", "NumInferChunks",
          "NumLabelChunks", "NumCorrectChunks"), ()),
        ("chunk_eval", {"Inference": tags9, "Label": gold9},
         {"num_chunk_types": 8, "chunk_scheme": "plain"}, [],
         ("Precision", "Recall", "F1-Score", "NumInferChunks",
          "NumLabelChunks", "NumCorrectChunks"), ()),
    ]


CASES = _seq_cases() + [("gru",), ("lstm_unit",), ("gru_unit",),
                        ("lstmp",)]  # the recurrent ops: tests above


@pytest.mark.parametrize(
    "case", [c for c in CASES if len(c) > 1],
    ids=[f"{c[0]}{i}" for i, c in enumerate(CASES) if len(c) > 1])
def test_op_matches_jax(case):
    op, ins, attrs, diff, outs, exact = case
    _op_parity(op, ins, attrs, diff, outs, exact)


def test_metric_counts_are_exact():
    """chunk_eval's counts and the unnormalized edit distances are
    integers: held exactly (the cases above hold them through
    ``_same``'s integer rule and ``exact``); a hand-made case pins the
    values themselves."""
    hyp = np.array([[1, 2, 3, -1], [4, 4, -1, -1]], np.int64)
    ref = np.array([[1, 3, -1], [-1, -1, -1]], np.int64)
    out, _ = _op_parity("edit_distance", {"Hyps": hyp, "Refs": ref}, {}, [],
                        ("Out",), ("Out",))
    np.testing.assert_array_equal(out["Out"][:, 0], [1.0, 2.0])
    # IOB over 2 types: B-0 I-0 O B-1 | B-1 B-1 I-1 O against
    # B-0 I-0 O B-1 | B-1 I-1 I-1 O: 4 and 3 chunks, 2 alike
    inf = np.array([[0, 1, 4, 2], [2, 2, 3, 4]], np.int64)
    lab = np.array([[0, 1, 4, 2], [2, 3, 3, 4]], np.int64)
    out, _ = _op_parity("chunk_eval", {"Inference": inf, "Label": lab},
                        {"num_chunk_types": 2, "chunk_scheme": "IOB"}, [],
                        ("NumInferChunks", "NumLabelChunks",
                         "NumCorrectChunks", "Precision"))
    assert [int(out[k][0]) for k in ("NumInferChunks", "NumLabelChunks",
                                     "NumCorrectChunks")] == [4, 3, 2]


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_arg_max_matches_jax(axis):
    x = np.array([[1.0, 3.0, 3.0], [2.0, -1.0, 2.0]], np.float32)  # ties
    _op_parity("arg_max", {"X": x}, {"axis": axis}, [], ("Out",), ("Out",))


def test_crf_nll_is_log_partition_minus_gold_score():
    """The CRF loss of a one-tag chain: log Z is a logsumexp over the
    single path, so the NLL is 0 — held on the port alone, at float32
    rounding."""
    rng = np.random.RandomState(0)
    em = _randn(rng, 2, 4, 1)
    out, _ = _port_op("linear_chain_crf", {
        "Emission": em, "Transition": _randn(rng, 3, 1),
        "Label": np.zeros((2, 4), np.int64)}, {}, {})
    np.testing.assert_allclose(out["LogLikelihood"], 0.0, atol=1e-5)


def _recurrent_cases():
    r = np.random.RandomState(1)
    N, T, H, P = 4, 6, 5, 3
    return [
        ("gru", {"Input": _randn(r, N, T, 3 * H),
                 "Weight": _randn(r, H, 3 * H), "Bias": _randn(r, 3 * H),
                 "Lengths": LENS}, {"is_reverse": True},
         ("Hidden", "BatchGate", "BatchResetHiddenPrev", "BatchHidden")),
        ("lstmp", {"Input": _randn(r, N, T, 4 * H),
                   "Weight": _randn(r, P, 4 * H),
                   "ProjWeight": _randn(r, H, P),
                   "Bias": _randn(r, 1, 7 * H), "Lengths": LENS},
         {"use_peepholes": True, "is_reverse": True},
         ("Projection", "Cell", "BatchedProjection", "OrderedP0")),
        ("lstm_unit", {"X": _randn(r, 3, 20), "C_prev": _randn(r, 3, 5)},
         {}, ("C", "H")),
        ("gru_unit", {"Input": _randn(r, 3, 15), "HiddenPrev": _randn(r, 3, 5),
                      "Weight": _randn(r, 5, 15), "Bias": _randn(r, 1, 15)},
         {}, ("Hidden", "Gate", "ResetHiddenPrev")),
    ]


def test_ops_infer_shapes_on_meta():
    """Build-time shape inference runs each emitter on ``meta``: the
    recurrent and DP ops answer without stepping, the rest as computed,
    with the shapes and dtypes of a CPU run."""
    cases = [(c[0], c[1], c[2], c[4]) for c in CASES if len(c) > 1]
    for op, ins, attrs, outs in cases + _recurrent_cases():
        tins = {s: [torch.from_numpy(np.array(a)).to("meta")
                    for a in _as_list(v)] for s, v in ins.items()}
        got = run_forward(EmitCtx(device="meta"), op, tins, attrs)
        want, _ = _port_op(op, ins, attrs, {})
        for s in outs:
            assert tuple(got[s][0].shape) == want[s].shape, (op, s)
            assert got[s][0].dtype == torch.from_numpy(want[s]).dtype, \
                (op, s)
