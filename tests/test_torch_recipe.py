"""The port's training-recipe surface against the JAX package's, on the
CPU: the LR schedules (``layers/learning_rate_scheduler.py`` over
``autoincreased_step_counter``, ``create_global_var`` and the Variable
operators of ``layers/math_op_patch.py``), gradient clipping
(``fluid/clip.py``), weight decay (``fluid/regularizer.py``),
per-parameter learning rates, the optimizers and ``ModelAverage``
(``fluid/optimizer.py``, ``fluid/ops/optimizer_ops.py``),
``WeightedAverage`` (``fluid/average.py``) and the Fluid checkpoints of
``fluid/io.py``:

  (a) every new op alone against the JAX op on the cases of
      tests/test_ops_optim.py (seeded), ``clip``/``clip_by_norm``/
      ``squared_l2_norm`` with their input gradients against
      ``jax.vjp``, and ``average_accumulates`` through its fold and
      close branches;
  (b) the six schedules over 20 steps (program bytes equal, rates equal
      to the JAX package's and to their closed forms; ``piecewise_decay``
      exactly at each boundary) and a schedule driving SGD;
  (c) each clip attr, error clip, L1/L2 decay globally and per
      parameter, and a per-parameter learning rate, through
      ``minimize``: parameters after 3 steps;
  (d) each optimizer through ``minimize`` for 3 steps, with one
      parameter at ``ParamAttr(learning_rate=0.5)``; ModelAverage's
      ``apply``/``restore``; WeightedAverage;
  (e) checkpoints: the ``save_persistables`` manifest and the
      ``save_checkpoint`` payload written by either package load in the
      other (manifest segments byte-equal); a run resumed from
      ``save_checkpoint`` at step 3 is bitwise the uninterrupted one.

Every program is built by both packages (same ``to_bytes``; a var
declared int64 reads int32 in the JAX bytes, no x64) and run from the
same float state: the JAX startup's floating persistables are copied into
the port's scope, the port keeps its own int64 step counter.

Tolerances (float32; XLA and PyTorch round differently): rtol 1e-5 /
atol 1e-6; the schedules 1e-6 relative; bitwise where the JAX package pins
bytes (checkpoint segments) and for a resumed run.
"""
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.fluid.registry import get_op_info as jax_op_info
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import layers as tlayers
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.fluid.registry import (
    FWD_META_ATTR, EmitCtx, forward_with_grad, run_forward, run_grad)

RTOL, ATOL = 1e-5, 1e-6
LR_RTOL = 1e-6
JAX = (jfluid, jlayers, junique)
PORT = (tfluid, tlayers, tunique)


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


def _jax_op(op_type, ins, attrs, dys):
    fwd = jax_op_info(op_type).forward
    diff = list(dys and ["X"])

    def fn(*diffs):
        full = {s: [jnp.asarray(v)] for s, v in ins.items()}
        full.update({s: [d] for s, d in zip(diff, diffs)})
        return fwd(None, full, attrs)

    primals = [jnp.asarray(ins[s]) for s in diff]
    outs = {s: np.asarray(v[0] if isinstance(v, list) else v)
            for s, v in fn(*primals).items()}
    if not dys:
        return outs, {}
    _, vjp = jax.vjp(lambda *d: {s: fn(*d)[s] for s in dys}, *primals)
    grads = vjp({s: jnp.asarray(d) for s, d in dys.items()})
    return outs, dict(zip(diff, (np.asarray(g) for g in grads)))


def _op_parity(op_type, ins, attrs, grad=False):
    """Every output of both packages' op on the same inputs (an int64
    output computes as int32 in the JAX package); with ``grad``, also
    d(Out)/d(X) for a seeded cotangent."""
    tout, _ = _port_op(op_type, ins, attrs, {})
    dys = ({"Out": np.random.RandomState(7).randn(
        *tout["Out"].shape).astype(np.float32)} if grad else {})
    tout, tgrads = _port_op(op_type, ins, attrs, dys)
    jout, jgrads = _jax_op(op_type, ins, attrs, dys)
    assert set(tout) == set(jout)
    for s in tout:
        if (tout[s].dtype, jout[s].dtype) != (np.int64, np.int32):
            assert tout[s].dtype == jout[s].dtype, s
        assert tout[s].shape == jout[s].shape, s
        np.testing.assert_allclose(tout[s], jout[s], rtol=RTOL, atol=ATOL,
                                   err_msg=s)
    if grad:
        np.testing.assert_allclose(tgrads["X"], jgrads["X"], rtol=RTOL,
                                   atol=ATOL, err_msg="grad X")
    return tout


def _case(name, seed=0):
    """The inputs and attrs of tests/test_ops_optim.py's case ``name``."""
    rng = np.random.RandomState(seed)

    def r(*shape, lo=None, hi=None, plus=0.0):
        if lo is None:
            return (rng.rand(*shape) + plus).astype(np.float32)
        return rng.uniform(lo, hi, shape).astype(np.float32)

    lr = lambda v: np.array([v], np.float32)  # noqa: E731
    if name == "adagrad":
        return ({"Param": r(4), "Grad": r(4), "Moment": r(4),
                 "LearningRate": lr(0.1)}, {"epsilon": 1e-6})
    if name == "decayed_adagrad":
        return ({"Param": r(4), "Grad": r(4), "Moment": r(4),
                 "LearningRate": lr(0.05)}, {"decay": 0.95, "epsilon": 1e-6})
    if name == "adadelta":
        return ({"Param": r(4), "Grad": r(4), "AvgSquaredGrad": r(4),
                 "AvgSquaredUpdate": r(4)}, {"rho": 0.95, "epsilon": 1e-6})
    if name == "adamax":
        return ({"Param": r(4), "Grad": r(4), "Moment": r(4),
                 "InfNorm": r(4, plus=0.5),
                 "Beta1Pow": np.array([0.9 ** 4], np.float32),
                 "LearningRate": lr(0.002)},
                {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8})
    if name == "adamax_eps_placement_near_zero":
        return ({"Param": r(4), "Grad": np.full(4, 1e-10, np.float32),
                 "Moment": np.zeros(4, np.float32),
                 "InfNorm": np.zeros(4, np.float32),
                 "Beta1Pow": np.array([0.9], np.float32),
                 "LearningRate": lr(0.002)},
                {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8})
    if name == "rmsprop":
        return ({"Param": r(4), "Grad": r(4), "MeanSquare": r(4),
                 "Moment": r(4), "LearningRate": lr(0.01)},
                {"decay": 0.9, "momentum": 0.0, "epsilon": 1e-10})
    if name == "rmsprop_momentum":
        return ({"Param": r(4), "Grad": r(4), "MeanSquare": r(4),
                 "Moment": r(4), "LearningRate": lr(0.01)},
                {"decay": 0.9, "momentum": 0.5, "epsilon": 1e-6})
    if name.startswith("ftrl"):
        power = -0.5 if name == "ftrl" else -1.0
        return ({"Param": r(4, lo=-1, hi=1), "Grad": r(4, lo=-1, hi=1),
                 "SquaredAccumulator": r(4, plus=0.1),
                 "LinearAccumulator": r(4, lo=-2, hi=2),
                 "LearningRate": lr(0.1)},
                {"l1": 0.5, "l2": 0.1, "lr_power": power})
    if name == "proximal_gd":
        return ({"Param": r(4, lo=-1, hi=1), "Grad": r(4, lo=-1, hi=1),
                 "LearningRate": lr(0.1)}, {"l1": 0.2, "l2": 0.05})
    if name == "proximal_adagrad":
        return ({"Param": r(4, lo=-1, hi=1), "Grad": r(4, lo=-1, hi=1),
                 "Moment": r(4, plus=0.1), "LearningRate": lr(0.1)},
                {"l1": 0.2, "l2": 0.05})
    raise KeyError(name)


OPTIMIZER_CASES = ["adagrad", "decayed_adagrad", "adadelta", "adamax",
                   "adamax_eps_placement_near_zero", "rmsprop",
                   "rmsprop_momentum", "ftrl", "ftrl_lr_power_-1",
                   "proximal_gd", "proximal_adagrad"]


@pytest.mark.parametrize("case", OPTIMIZER_CASES)
def test_a_optimizer_op_matches_jax(case):
    ins, attrs = _case(case)
    out = _op_parity(case.split("_eps")[0].split("_lr")[0]
                     .replace("rmsprop_momentum", "rmsprop"), ins, attrs)
    if case == "adamax_eps_placement_near_zero":
        # eps joins the decayed norm BEFORE the max: the new norm is eps
        np.testing.assert_array_equal(out["InfNormOut"],
                                      np.full(4, 1e-8, np.float32))


# (num_accumulates, old_num_accumulates, num_updates) before the step:
# neither branch, a fold and a close together, a window still open
AVERAGE_STATES = [(0, 0, 0), (3, 1, 3), (1, 2, 5)]


@pytest.mark.parametrize("state", AVERAGE_STATES)
def test_a_average_accumulates_matches_jax(state):
    rng = np.random.RandomState(3)
    acc, old, upd = state
    ins = {"Param": rng.randn(3, 2).astype(np.float32),
           "Sum1": rng.randn(3, 2).astype(np.float32),
           "Sum2": rng.randn(3, 2).astype(np.float32),
           "Sum3": rng.randn(3, 2).astype(np.float32),
           "NumAccumulates": np.array([acc], np.int64),
           "OldNumAccumulates": np.array([old], np.int64),
           "NumUpdates": np.array([upd], np.int64)}
    _op_parity("average_accumulates", ins, {
        "average_window": 0.5, "min_average_window": 2,
        "max_average_window": 4})


@pytest.mark.parametrize("op,attrs,scale", [
    ("clip", {"min": -0.3, "max": 0.5}, 1.0),
    ("clip_by_norm", {"max_norm": 1.0}, 1.0),    # the norm exceeds 1
    ("clip_by_norm", {"max_norm": 1.0}, 0.05),   # passes through
    ("squared_l2_norm", {}, 1.0),
])
def test_a_clip_op_matches_jax_with_gradient(op, attrs, scale):
    x = (np.random.RandomState(4).randn(3, 5) * scale).astype(np.float32)
    _op_parity(op, {"X": x}, attrs, grad=True)


def test_a_sparse_gradient_raises():
    """A SelectedRows gradient is taken by the clip and optimizer ops
    (tests/test_torch_selected_rows.py holds them against the JAX
    package); what still raises is a sparse op given a dense tensor and
    a sum of SelectedRows of different heights."""
    from paddle_tpu_torch.fluid.selected_rows import SelectedRows

    ctx = EmitCtx(device="cpu", root_seed=1)
    g = SelectedRows(torch.tensor([0, 2, 0]), torch.ones(3, 3), 3)
    clipped = run_forward(ctx, "clip", {"X": [g]},
                          {"min": 0.0, "max": 1.0})["Out"][0]
    np.testing.assert_array_equal(clipped.to_dense().numpy(),
                                  np.array([[1, 1, 1], [0, 0, 0], [1, 1, 1]],
                                           np.float32))
    moved = run_forward(ctx, "adagrad", {
        "Param": [torch.zeros(3, 3)], "Grad": [g],
        "Moment": [torch.zeros(3, 3)],
        "LearningRate": [torch.ones(1)]}, {})["ParamOut"][0]
    assert (moved[1] == 0).all() and (moved[0] < 0).all()
    with pytest.raises(ValueError, match="expects a SelectedRows"):
        run_forward(ctx, "split_selected_rows", {"X": [torch.eye(3)]},
                    {"height_sections": [1, 2]})
    with pytest.raises(ValueError, match="heights differ"):
        run_forward(ctx, "sum", {"X": [g, SelectedRows(
            torch.tensor([1]), torch.ones(1, 3), 4)]}, {})


# --- programs built and run by both packages --------------------------------

def _same_program(tp, jp):
    """``to_bytes()`` equal, up to a var the program declares int64 that
    the JAX package's bytes record as int32 (no x64), and the dtype attr
    (a cast's ``in_dtype``) read from such a var."""
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


def _build(pkg, build, seed=3):
    fluid, layers, unique_name = pkg
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with unique_name.guard(), fluid.program_guard(main, startup):
        names = build(fluid, layers)
    return main, startup, names


def _float_state(program, scope):
    """The floating persistables of a JAX scope as numpy arrays."""
    out = {}
    for n, v in program.global_block().vars.items():
        val = scope.find_var(n) if v.persistable else None
        if val is not None and np.issubdtype(np.asarray(val).dtype,
                                             np.floating):
            out[n] = np.asarray(val)
    return out


class _Both:
    """One program built by each package (bytes equal), each startup
    run, the JAX scope's floating persistables copied into the port's
    scope (the port keeps its own int64 counters)."""

    def __init__(self, build, seed=3):
        self.j = _build(JAX, build, seed)
        self.t = _build(PORT, build, seed)
        _same_program(self.t[0], self.j[0])
        _same_program(self.t[1], self.j[1])
        self.jexe, self.jscope = jfluid.Executor(jfluid.CPUPlace()), \
            jfluid.Scope()
        self.texe, self.tscope = tfluid.Executor(tfluid.CPUPlace()), \
            tfluid.Scope()
        self.jexe.run(self.j[1], scope=self.jscope)
        self.texe.run(self.t[1], scope=self.tscope)
        tfluid.params_from_jax(_float_state(self.j[0], self.jscope),
                               self.tscope, device="cpu")

    def run(self, feed=None, fetch=None, steps=1):
        """``steps`` runs of each main program; the fetches of every step:
        ([jax step 1, ...], [port step 1, ...])."""
        fetch = [v if isinstance(v, str) else v.name
                 for v in (self.t[2] if fetch is None else fetch)]
        out = ([], [])
        for _ in range(steps):
            out[0].append([np.asarray(v) for v in self.jexe.run(
                self.j[0], feed=feed, fetch_list=fetch, scope=self.jscope)])
            out[1].append([np.asarray(v) for v in self.texe.run(
                self.t[0], feed=feed, fetch_list=fetch, scope=self.tscope)])
        return out

    def params(self):
        names = [p.name for p in self.t[0].global_block().all_parameters()]
        return ([np.asarray(self.jscope.find_var(n)) for n in names],
                [self.tscope.find_var(n).numpy() for n in names], names)


def _close(j, t, names=None, rtol=RTOL, atol=ATOL):
    for i, (a, b) in enumerate(zip(j, t)):
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol,
                                   err_msg=str(names[i] if names else i))


# --- (b) schedules -------------------------------------------------------

STEPS = 20
SCHEDULES = {
    "exponential": (lambda L: L.exponential_decay(0.1, 3, 0.5),
                    lambda i: 0.1 * 0.5 ** (i / 3.0)),
    "exponential_staircase": (
        lambda L: L.exponential_decay(0.1, 3, 0.5, staircase=True),
        lambda i: 0.1 * 0.5 ** math.floor(i / 3.0)),
    "natural_exp": (lambda L: L.natural_exp_decay(0.1, 4, 0.5),
                    lambda i: 0.1 * math.exp(-0.5 * i / 4.0)),
    "inverse_time": (lambda L: L.inverse_time_decay(0.1, 2, 0.5,
                                                    staircase=True),
                     lambda i: 0.1 / (1 + 0.5 * math.floor(i / 2.0))),
    "polynomial": (lambda L: L.polynomial_decay(0.1, 8, 0.01, power=2.0),
                   lambda i: 0.09 * (1 - min(i, 8) / 8.0) ** 2 + 0.01),
    "polynomial_cycle": (
        lambda L: L.polynomial_decay(0.1, 6, 0.01, power=1.0, cycle=True),
        lambda i: 0.09 * (1 - i / (6.0 * max(1, math.ceil(i / 6.0))))
        + 0.01),
    "piecewise": (lambda L: L.piecewise_decay([3, 7, 12], [1.0, 0.5, 0.1,
                                                           0.05]),
                  lambda i: 1.0 if i < 3 else 0.5 if i < 7 else
                  0.1 if i < 12 else 0.05),
    "noam": (lambda L: L.noam_decay(64, 5),
             lambda i: 64 ** -0.5 * min((i + 1) ** -0.5,
                                        5 ** -1.5 * (i + 1))),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_b_schedule_matches_jax_and_its_closed_form(name):
    make, closed = SCHEDULES[name]

    def build(fluid, layers):
        return [make(layers)]

    both = _Both(build)
    j, t = both.run(steps=STEPS)
    jv = [float(s[0].reshape(-1)[0]) for s in j]
    tv = [float(s[0].reshape(-1)[0]) for s in t]
    np.testing.assert_allclose(tv, jv, rtol=LR_RTOL)
    want = [closed(i) for i in range(STEPS)]
    np.testing.assert_allclose(tv, want, rtol=LR_RTOL)
    if name == "piecewise":
        # every boundary exactly: 1.0 up to step 2, 0.5 from step 3, ...
        assert tv == [np.float32(w) for w in want]
    counter = both.tscope.find_var("@LR_DECAY_COUNTER@")
    assert counter.dtype == torch.int64
    assert int(counter) == STEPS - (0 if name == "noam" else 1)


def _linreg(fluid, layers, lr=None, opt="SGD", param_lr=None,
            clip=None, regularization=None, param_reg=None, opt_kw=None):
    """fit_a_line's program (fc 13 -> 1 + square_error_cost + mean), its
    weight with the given ParamAttr options."""
    x = layers.data(name="x", shape=[13], dtype="float32")
    y = layers.data(name="y", shape=[1], dtype="float32")
    attr = fluid.ParamAttr(name="fc.w", learning_rate=param_lr or 1.0,
                           regularizer=param_reg)
    pred = layers.fc(input=x, size=1, param_attr=attr, bias_attr="fc.b")
    cost = layers.mean(layers.square_error_cost(input=pred, label=y))
    if clip is not None:
        fluid.set_gradient_clip(clip)
    lr = 0.05 if lr is None else lr(layers)
    getattr(fluid.optimizer, opt)(
        learning_rate=lr, regularization=regularization,
        **(opt_kw or {})).minimize(cost)
    return [cost]


def _linreg_feed(seed=0, n=16):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 13).astype(np.float32)
    y = (x @ rng.randn(13, 1) + 0.3).astype(np.float32)
    return {"x": x, "y": y}


def test_b_lr_schedule_drives_sgd():
    """tests/test_lr_metrics_evaluator.py:86: an exponential decay
    drives SGD; the losses fall and equal the JAX package's."""
    both = _Both(lambda f, L: _linreg(
        f, L, lr=lambda L: L.exponential_decay(0.05, decay_steps=1,
                                               decay_rate=0.9)))
    j, t = both.run(_linreg_feed(), steps=STEPS)
    jl = [float(s[0][0]) for s in j]
    tl = [float(s[0][0]) for s in t]
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    assert tl[-1] < tl[0]


# --- (c) clipping, decay, per-parameter rates -----------------------------

RECIPES = {
    "clip_by_value": dict(clip=("GradientClipByValue", (0.05,))),
    "clip_by_norm": dict(clip=("GradientClipByNorm", (0.1,))),
    "clip_by_global_norm": dict(clip=("GradientClipByGlobalNorm", (0.2,))),
    "l2_decay_global": dict(regularization=("L2Decay", 0.1)),
    "l1_decay_global": dict(regularization=("L1Decay", 0.1)),
    "l2_decay_param": dict(param_reg=("L2Decay", 0.5)),
    "l1_decay_param_over_l2_global": dict(param_reg=("L1Decay", 0.5),
                                          regularization=("L2Decay", 0.1)),
    "param_learning_rate": dict(param_lr=0.5),
}


def _recipe_kw(fluid, spec):
    kw = dict(spec)
    if "clip" in kw:
        cls, args = kw["clip"]
        kw["clip"] = getattr(fluid.clip, cls)(*args)
    for key in ("regularization", "param_reg"):
        if key in kw:
            cls, coeff = kw[key]
            kw[key] = getattr(fluid.regularizer, cls)(coeff)
    return kw


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_c_recipe_matches_jax(name):
    both = _Both(lambda f, L: _linreg(f, L, **_recipe_kw(f, RECIPES[name])))
    j, t = both.run(_linreg_feed(), steps=3)
    _close([s[0] for s in j], [s[0] for s in t])
    jp, tp, names = both.params()
    _close(jp, tp, names)
    ops = both.t[0].global_block().ops
    if name == "clip_by_global_norm":
        assert [op.type for op in ops].count("squared_l2_norm") == 2
    rates = {op.input("Param")[0]: op.input("LearningRate")[0]
             for op in ops if op.type == "sgd"}
    # a per-parameter rate is the global one through a scale op
    assert (rates["fc.w"] != rates["fc.b"]) == (name == "param_learning_rate")


def test_c_error_clip_matches_jax():
    """ErrorClipByValue appends a ``clip`` of a gradient in place (the
    backward callback itself is the JAX package's no-op hook)."""
    def build(fluid, layers):
        _linreg(fluid, layers)
        block = fluid.default_main_program().global_block()
        fluid.clip.ErrorClipByValue(max=0.01).append_clip_op(block,
                                                             "fc.w@GRAD")
        return ["fc.w@GRAD"]

    both = _Both(build)
    j, t = both.run(_linreg_feed(), steps=2)
    _close(j[-1], t[-1])
    assert np.abs(t[-1][0]).max() <= 0.01


# --- (d) optimizers, ModelAverage, WeightedAverage ------------------------

OPTIMIZERS = {
    "SGD": {}, "Momentum": {"momentum": 0.9},
    "Momentum_nesterov": {"momentum": 0.9, "use_nesterov": True},
    "Adam": {}, "Adagrad": {}, "Adamax": {}, "DecayedAdagrad": {},
    "Adadelta": {}, "RMSProp": {"momentum": 0.5},
    "Ftrl": {"l1": 0.01, "l2": 0.01},
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_d_optimizer_minimize_matches_jax(name):
    """3 steps of fit_a_line's program, the weight at a per-parameter
    learning rate of 0.5: losses, parameters and every accumulator."""
    both = _Both(lambda f, L: _linreg(
        f, L, opt=name.split("_")[0], param_lr=0.5,
        opt_kw=OPTIMIZERS[name]))
    j, t = both.run(_linreg_feed(), steps=3)
    _close([s[0] for s in j], [s[0] for s in t])
    state = sorted(_float_state(both.j[0], both.jscope))
    _close([np.asarray(both.jscope.find_var(n)) for n in state],
           [both.tscope.find_var(n).numpy() for n in state], state)


def test_d_model_average_matches_jax():
    """tests/test_lr_metrics_evaluator.py:203's program in both packages:
    the averaged weight equals the JAX package's and lies inside the
    visited range; restore() puts the live weight back bit for bit."""
    averages = {}

    def build(fluid, layers):
        x = layers.data(name="x", shape=[1], dtype="float32")
        y = layers.data(name="y", shape=[1], dtype="float32")
        pred = layers.fc(input=x, size=1, bias_attr=False,
                         param_attr="avg.w")
        cost = layers.mean(layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(cost)
        averages[fluid] = fluid.optimizer.ModelAverage(
            0.5, min_average_window=2, max_average_window=10)
        return [cost]

    both = _Both(build)
    feed = {"x": np.ones((4, 1), np.float32),
            "y": 2 * np.ones((4, 1), np.float32)}
    seen = []
    for _ in range(5):
        both.run(feed)
        seen.append(float(both.tscope.find_var("avg.w").reshape(-1)[0]))
    live = both.tscope.find_var("avg.w").clone()
    got = {}
    for fluid, exe, scope in ((jfluid, both.jexe, both.jscope),
                              (tfluid, both.texe, both.tscope)):
        with fluid.scope_guard(scope), averages[fluid].apply(exe):
            got[fluid] = np.asarray(scope.find_var("avg.w")).copy()
    np.testing.assert_allclose(got[tfluid], got[jfluid], rtol=RTOL,
                               atol=ATOL)
    avg = float(got[tfluid].reshape(-1)[0])
    assert min(seen) - 1e-6 <= avg <= max(seen) + 1e-6
    assert not math.isclose(avg, float(live.reshape(-1)[0]), rel_tol=1e-9)
    assert torch.equal(both.tscope.find_var("avg.w"), live)


def test_d_weighted_average_as_jax():
    """tests/test_executor.py:155."""
    from paddle_tpu.fluid.average import WeightedAverage as JWeighted
    from paddle_tpu_torch.fluid.average import WeightedAverage

    for cls in (WeightedAverage, JWeighted):
        wa = cls()
        with pytest.raises(ValueError):
            wa.eval()
        wa.add(2.0, weight=1)
        wa.add(3.0, weight=3)
        assert wa.eval() == pytest.approx((2.0 + 3.0 * 3) / 4)
        wa.reset()
        wa.add(np.array([4.0, 6.0]), weight=1)
        wa.add(np.array([8.0, 2.0]), weight=3)
        np.testing.assert_allclose(wa.eval(), [(4 + 24) / 4, (6 + 6) / 4])
        with pytest.raises(ValueError):
            wa.add(1.0, weight=np.array([1.0, 2.0]))
        wa.reset()
        wa.add(7.0, weight=1)
        assert wa.eval() == 7.0


# --- (e) checkpoints -----------------------------------------------------

def _adam_scheduled(fluid, layers):
    return _linreg(fluid, layers, opt="Adam",
                   lr=lambda L: L.noam_decay(16, 3),
                   clip=fluid.clip.GradientClipByGlobalNorm(1.0),
                   regularization=fluid.regularizer.L2Decay(1e-3))


def _manifest(d):
    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f)


def _segments(d, m):
    with open(os.path.join(d, m["payload"]), "rb") as f:
        data = f.read()
    return {t["name"]: data[t["offset"]:t["offset"] + t["nbytes"]]
            for t in m["tensors"]}


def _same_state(both, steps=2):
    """Run ``steps`` steps in each package, then give the port the JAX
    scope's floating state again: both scopes hold the same values (the
    counter at ``steps``, int32 in the JAX scope, int64 in the port's)."""
    both.run(_linreg_feed(), steps=steps)
    tfluid.params_from_jax(_float_state(both.j[0], both.jscope),
                           both.tscope, device="cpu")
    return _float_state(both.j[0], both.jscope)


COUNTER = "@LR_DECAY_COUNTER@"


def test_e_persistables_manifest_both_ways(tmp_path):
    """Both packages save the same state: segments byte-equal, manifests
    equal but for the nonce-named payload and the counter's integer
    width; each package loads the other's manifest (values bitwise)."""
    both = _Both(_adam_scheduled)
    state = _same_state(both)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jfluid.io.save_persistables(both.jexe, jd, both.j[0], scope=both.jscope,
                                step=2)
    tfluid.io.save_persistables(both.texe, td, both.t[0], scope=both.tscope,
                                step=2)
    mj, mt = _manifest(jd), _manifest(td)
    assert mj["meta"] == mt["meta"] == {"kind": "persistables", "step": 2}
    sj, st = _segments(jd, mj), _segments(td, mt)
    assert np.frombuffer(sj.pop(COUNTER), np.int32)[0] == \
        np.frombuffer(st.pop(COUNTER), np.int64)[0] == 2
    assert sj == st
    for m, dtype in ((mj, "int32"), (mt, "int64")):
        (entry,) = [t for t in m["tensors"] if t["name"] == COUNTER]
        assert entry.pop("dtype") == dtype and entry["shape"] == [1]
        entry.pop("crc32"), entry.pop("nbytes")
    mj.pop("payload"), mt.pop("payload")
    assert mj == mt
    assert tfluid.io.latest_checkpoint_step(jd) == 2
    tscope, jscope = tfluid.Scope(), jfluid.Scope()
    tfluid.io.load_persistables(both.texe, jd, both.t[0], scope=tscope)
    jfluid.io.load_persistables(both.jexe, td, both.j[0], scope=jscope)
    for n, a in state.items():
        np.testing.assert_array_equal(tscope.find_var(n).numpy(), a)
        np.testing.assert_array_equal(np.asarray(jscope.find_var(n)), a)
    assert int(tscope.find_var(COUNTER)) == int(np.asarray(jscope.find_var(COUNTER))[0]) \
        == 2
    with pytest.raises(ValueError, match="Executor"):
        tfluid.io.load_persistables(None, jd, both.t[0], scope=tscope)


def test_e_save_checkpoint_both_ways(tmp_path):
    """save_checkpoint's META + npz from either package: the same
    rotation, ``latest_checkpoint_step``, and each package's
    ``load_checkpoint`` of the other's (values bitwise); a changed
    payload byte fails its crc32."""
    both = _Both(_adam_scheduled)
    state = _same_state(both)
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    for step in (1, 2, 3, 4):
        jfluid.io.save_checkpoint(jd, both.j[0], step=step,
                                  scope=both.jscope, max_to_keep=2)
        tfluid.io.save_checkpoint(td, both.t[0], step=step,
                                  scope=both.tscope, max_to_keep=2)
    assert sorted(os.listdir(td)) == sorted(os.listdir(jd)) == [
        "META", "ckpt_3.npz", "ckpt_4.npz"]
    assert tfluid.io.latest_checkpoint_step(jd) == \
        jfluid.io.latest_checkpoint_step(td) == 4
    tscope, jscope = tfluid.Scope(), jfluid.Scope()
    assert tfluid.io.load_checkpoint(jd, scope=tscope, device="cpu") == 4
    assert jfluid.io.load_checkpoint(td, scope=jscope) == 4
    for n, a in state.items():
        np.testing.assert_array_equal(tscope.find_var(n).numpy(), a)
        np.testing.assert_array_equal(np.asarray(jscope.find_var(n)), a)
    assert int(tscope.find_var(COUNTER)) == int(np.asarray(jscope.find_var(COUNTER))[0]) \
        == 2
    with open(os.path.join(td, "ckpt_4.npz"), "r+b") as f:
        f.seek(100)
        b = f.read(1)
        f.seek(100)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(IOError, match="crc mismatch"):
        tfluid.io.load_checkpoint(td, scope=tfluid.Scope(), device="cpu")


def _resume_state(program, scope):
    return {n: scope.find_var(n).clone()
            for n, v in program.global_block().vars.items()
            if v.persistable and scope.find_var(n) is not None}


def test_e_resumed_run_is_bitwise_the_uninterrupted_one(tmp_path):
    """Adam on a noam schedule with global-norm clipping and L2 decay:
    5 steps straight, against 3 steps, save_checkpoint, a fresh scope,
    load_checkpoint, 2 steps — losses, the learning rate and every
    persistable (accumulators, counter) bitwise equal."""
    main, startup, names = _build(PORT, _adam_scheduled)
    lr = [op for op in main.global_block().ops
          if op.type == "adam"][0].input("LearningRate")[0]
    exe = tfluid.Executor(tfluid.CPUPlace())
    feeds = [_linreg_feed(seed=i) for i in range(5)]
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    start = _resume_state(main, scope)
    straight = [exe.run(main, feed=f, fetch_list=names + [lr], scope=scope)
                for f in feeds]
    end = _resume_state(main, scope)

    first = tfluid.Scope()
    for n, v in start.items():
        first.set_var(n, v.clone())
    resumed = [exe.run(main, feed=f, fetch_list=names + [lr], scope=first)
               for f in feeds[:3]]
    d = str(tmp_path / "ck")
    tfluid.io.save_checkpoint(d, main, step=3, scope=first)
    second = tfluid.Scope()
    assert tfluid.io.load_checkpoint(d, main, scope=second,
                                     device="cpu") == 3
    resumed += [exe.run(main, feed=f, fetch_list=names + [lr], scope=second)
                for f in feeds[3:]]
    for a, b in zip(straight, resumed):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert set(_resume_state(main, second)) == set(end)
    for n, v in end.items():
        assert torch.equal(second.find_var(n), v), n
    assert int(second.find_var(COUNTER)) == 5
