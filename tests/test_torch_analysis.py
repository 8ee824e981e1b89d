"""The port's program verifier and its wiring against the JAX package on
the CPU (``paddle_tpu_torch.analysis`` against ``paddle_tpu.analysis``):

  - the four book programs (fit_a_line, LeNet, word2vec,
    understand_sentiment) built in both packages give equal
    ``(code, severity, where, message)`` lists under
    ``verify_program(check_shapes=True)`` — the JAX package's V003/V004
    by ``jax.eval_shape``, the port's by its emitters on meta tensors;
  - every selftest case fires its code in both packages, with equal
    diagnostics (the N203/N204 messages name each package's own flags
    file, so those compare by code and severity);
  - the int64 the port keeps where the JAX package computes int32 fires
    no V004 in either package;
  - the Executor hook (``FLAGS['verify_programs']``): a use-before-def
    program is refused by both Executors with the same text, a valid
    program's losses are bitwise equal with the hook on and off, and
    the hook runs once per program-cache miss;
  - the memory-optimization gate refuses the same forced aliasing merge
    in both packages and rolls the program back;
  - FLAGS: the port's keys are the JAX package's minus the decided
    absences; ``check_nan_inf``, ``benchmark``, ``serving_buckets``,
    ``trace``, ``trace_buffer`` and ``faults`` behave as in the JAX
    package.
"""
import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.analysis import examples as jexamples
from paddle_tpu.analysis import selftest as jselftest
from paddle_tpu.analysis.diagnostics import AnalysisError as JAnalysisError
from paddle_tpu.fluid.flags import FLAGS as JFLAGS
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.analysis import examples as texamples
from paddle_tpu_torch.analysis import selftest as tselftest
from paddle_tpu_torch.analysis import verify as tverify
from paddle_tpu_torch.analysis.diagnostics import (
    AnalysisError as TAnalysisError, ProgramVerifyError)
from paddle_tpu_torch.flags import FLAGS as TFLAGS

# keys the port leaves out by decision: kernel routing is by device
# alone, and XLA buffer donation and per-executable cost accounting have
# no counterpart in an eager executor
DECIDED_ABSENT = {"use_pallas_kernels", "flash_min_seq", "paged_min_slots",
                  "donate_state", "compile_stats"}


def _rows(diags):
    return [(d.code, d.severity, d.where, d.message) for d in diags]


@pytest.fixture
def port_verify(monkeypatch):
    """FLAGS['verify_programs'] on in the port (the JAX package's suite
    runs with it on)."""
    monkeypatch.setitem(TFLAGS, "verify_programs", True)
    assert JFLAGS["verify_programs"]


# --- the verifier -------------------------------------------------------

@pytest.mark.parametrize("name", sorted(jexamples.BOOK_EXAMPLES))
def test_book_program_diagnostics_equal_jax(name):
    from paddle_tpu.analysis.verify import verify_program as jverify

    jmain, jstart = jexamples.BOOK_EXAMPLES[name]()
    tmain, tstart = texamples.BOOK_EXAMPLES[name]()
    for jp, tp in ((jmain, tmain), (jstart, tstart)):
        assert [op.type for op in tp.global_block().ops] == \
            [op.type for op in jp.global_block().ops]
        want = _rows(jverify(jp, check_shapes=True))
        got = _rows(tverify.verify_program(tp, check_shapes=True))
        assert got == want
        assert not [r for r in got if r[1] == "error"], got


@pytest.mark.parametrize("code", sorted(jselftest.CASES))
def test_selftest_case_fires_the_same_diagnostics(code):
    want = jselftest.CASES[code]()
    got = tselftest.CASES[code]()
    assert code in {d.code for d in got}
    if code in ("N203", "N204"):
        # each names its own package's flags file
        assert [r[:2] for r in _rows(got)] == [r[:2] for r in _rows(want)]
        assert all("paddle_tpu_torch/flags.py" in d.message + d.where
                   for d in got)
    else:
        assert _rows(got) == _rows(want)


def test_selftest_runners_fire_the_same_codes():
    want = [(c, f) for c, f, _ in jselftest.run_selftest()]
    got = [(c, f) for c, f, _ in tselftest.run_selftest()]
    assert got == want and all(f for _, f in got)
    assert set(tselftest.CASES) == set(jselftest.CASES)


def test_int64_standing_difference_fires_no_v004():
    """The JAX package computes int64 as int32 (no x64) and its build
    writes int32 into the desc; the port keeps int64 in both. Each
    package's declared dtype is its own emitter's, so no V004 fires."""
    from paddle_tpu.analysis.verify import verify_program as jverify
    from paddle_tpu.fluid import layers as jl
    from paddle_tpu_torch.fluid import layers as tl

    dtypes, diags = {}, {}
    for name, fluid, layers, verify in (
            ("jax", jfluid, jl, jverify),
            ("port", tfluid, tl, tverify.verify_program)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            a = layers.fill_constant(shape=[2, 3], dtype="int64", value=1)
            b = layers.cast(a, "float32")
            c = layers.argmax(b, axis=1)
            layers.increment(layers.cast(c, "float32"), value=1.0)
        dtypes[name] = [main.global_block().var(n).dtype
                        for n in (a.name, c.name)]
        diags[name] = _rows(verify(main, check_shapes=True))
    assert dtypes == {"jax": ["int32", "int32"], "port": ["int64", "int64"]}
    assert diags["port"] == diags["jax"]
    assert not [r for r in diags["port"] if r[0] in ("V003", "V004")]


def test_meta_run_rejection_is_v003_and_data_dependence_is_silent():
    """An emitter that rejects fully-known shapes on meta tensors is a
    V003; one whose output shape depends on the data (no meta kernel)
    cannot be inferred and reports nothing, as a JAX concretization
    error does."""
    prog = tselftest._mk_program(
        {"a": dict(shape=[2, 3], dtype="float32"),
         "b": dict(shape=[4, 5], dtype="float32"),
         "o": dict(shape=[2, 5], dtype="float32")},
        [("mul", {"X": ["a"], "Y": ["b"]}, {"Out": ["o"]}, {})])
    (d,) = [d for d in tverify.verify_program(prog, check_shapes=True)
            if d.code == "V003"]
    assert d.message.startswith("emitter rejects fully-known input shapes")

    from paddle_tpu_torch.fluid.registry import OpInfo

    def nonzero(ctx, ins, attrs):
        import torch

        return {"Out": [torch.nonzero(ins["X"][0])]}

    prog = tselftest._mk_program(
        {"a": dict(shape=[2, 3], dtype="float32"),
         "o": dict(shape=[9, 9], dtype="int64")},
        [("relu", {"X": ["a"]}, {"Out": ["o"]}, {})])
    od = prog.global_block().ops[0].desc
    assert tverify._shape_check_op(prog.global_block(), 0, od,
                                   OpInfo("relu", nonzero)) == []


# --- the Executor hook --------------------------------------------------

def _use_before_def(selftest):
    return selftest._mk_program(
        {"a": dict(shape=[2, 2], dtype="float32"),
         "t": dict(shape=[2, 2], dtype="float32"),
         "b": dict(shape=[2, 2], dtype="float32")},
        [("relu", {"X": ["t"]}, {"Out": ["b"]}, {}),
         ("relu", {"X": ["a"]}, {"Out": ["t"]}, {})])


def test_executor_hook_refuses_use_before_def_like_jax(port_verify):
    feed = {"a": np.ones((2, 2), np.float32)}
    with pytest.raises(JAnalysisError) as jerr:
        jfluid.Executor().run(_use_before_def(jselftest), feed=feed,
                              fetch_list=["b"], scope=jfluid.Scope())
    with pytest.raises(ProgramVerifyError) as terr:
        tfluid.Executor("cpu").run(_use_before_def(tselftest), feed=feed,
                                   fetch_list=["b"], scope=tfluid.Scope())
    assert str(terr.value) == str(jerr.value)
    assert [d.code for d in terr.value.diagnostics] == ["V001"]


def test_executor_hook_off_leaves_the_program_to_the_op_loop():
    assert not TFLAGS["verify_programs"]
    with pytest.raises(Exception) as err:
        tfluid.Executor("cpu").run(
            _use_before_def(tselftest),
            feed={"a": np.ones((2, 2), np.float32)}, fetch_list=["b"],
            scope=tfluid.Scope())
    assert not isinstance(err.value, TAnalysisError)


def _fit_a_line_losses(steps, batch):
    main, startup = texamples.build_fit_a_line()
    exe, scope = tfluid.Executor("cpu"), tfluid.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(3)
    out = []
    for i in range(steps):
        n = batch if i < steps - 1 else batch + 3  # a new feed signature
        feed = {"x": rng.randn(n, 13).astype(np.float32),
                "y": rng.randn(n, 1).astype(np.float32)}
        (v,) = exe.run(main, feed=feed, fetch_list=["mean_0.tmp_0"],
                       scope=scope)
        out.append(np.asarray(v).tobytes())
    return out


def test_executor_hook_keeps_losses_bitwise_and_runs_once_per_miss(
        monkeypatch):
    calls = []
    real = tverify.assert_valid

    def counting(program, **kw):
        calls.append(kw["fetch_targets"])
        return real(program, **kw)

    monkeypatch.setattr(tverify, "assert_valid", counting)
    off = _fit_a_line_losses(4, 8)
    assert calls == []
    monkeypatch.setitem(TFLAGS, "verify_programs", True)
    on = _fit_a_line_losses(4, 8)
    assert on == off
    # the port's program cache keys on (program version, feed names):
    # startup and main miss once each, a new batch size hits
    assert calls == [[], ["mean_0.tmp_0"]]


# --- the memory-optimization gate ---------------------------------------

def _static_mlp(fluid, layers, unique_name):
    """An MLP whose feeds have a fixed batch, so every activation has a
    static shape and memory_optimize merges some."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 11
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data(name="x", shape=[8, 16], dtype="float32",
                        append_batch_size=False)
        y = layers.data(name="y", shape=[8, 1], dtype="float32",
                        append_batch_size=False)
        h = x
        for _ in range(3):
            h = layers.fc(input=h, size=16, act="relu")
        cost = layers.mean(layers.square_error_cost(
            input=layers.fc(input=h, size=1), label=y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(cost)
    return main


def test_transpiler_gate_refuses_a_forced_alias_like_jax(monkeypatch):
    import paddle_tpu.analysis.verify as jverify_mod
    from paddle_tpu.fluid import layers as jl
    from paddle_tpu.fluid import memory_optimization_transpiler as jmot
    from paddle_tpu.fluid import unique_name as ju
    from paddle_tpu_torch.fluid import layers as tl
    from paddle_tpu_torch.fluid import memory_optimization_transpiler as tmot
    from paddle_tpu_torch.fluid import unique_name as tu

    refusals = {}
    for name, mods, mot, vmod, exc in (
            ("jax", (jfluid, jl, ju), jmot, jverify_mod, JAnalysisError),
            ("port", (tfluid, tl, tu), tmot, tverify, tmot.RewriteError)):
        main = _static_mlp(*mods)
        cfg = mot.ControlFlowGraph(main.global_block())
        last = cfg.last_use_index()
        live = max(last, key=last.get)  # used by the last op
        real = vmod.check_reuse_events
        # the real merge log of the rewrite is replaced by one merge into
        # storage that is still live: the aliasing proof must refuse it
        monkeypatch.setattr(
            vmod, "check_reuse_events",
            lambda c, ev, real=real, live=live:
            real(c, [(1, "forced", live)]) if ev else [])
        before = main.to_bytes()
        with pytest.raises(exc) as err:
            mot.memory_optimize(main)
        assert main.to_bytes() == before  # rolled back
        monkeypatch.undo()
        assert mot.memory_optimize(main) > 0  # the real rewrite passes
        d = err.value.diagnostics
        refusals[name] = [x.key() for x in d] if name == "jax" else d
    assert refusals["port"] == refusals["jax"]
    assert [r[0] for r in refusals["port"]] == ["V010"]


# --- FLAGS --------------------------------------------------------------

def test_port_flag_keys_are_jax_keys_minus_the_decided_absences():
    assert set(TFLAGS) == set(JFLAGS) - DECIDED_ABSENT
    # tests/conftest.py turns these on for the JAX package's suite; the
    # live and environment-seeded keys are each process's own
    skip = {"verify_programs", "strict_shape_inference", "trace",
            "trace_buffer", "faults", "sanitize", "autotune_dir"}
    for k in set(TFLAGS) - skip:
        assert TFLAGS[k] == JFLAGS[k], k
    assert TFLAGS["verify_programs"] is False
    assert TFLAGS["strict_shape_inference"] is False


def _nan_training(fluid, layers, unique_name, exe):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data(name="x", shape=[4], dtype="float32")
        y = layers.data(name="y", shape=[1], dtype="float32")
        cost = layers.mean(layers.square_error_cost(
            input=layers.fc(input=x, size=1), label=y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(cost)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    xs = np.ones((3, 4), np.float32)
    xs[1, 2] = np.nan
    feed = {"x": xs, "y": np.ones((3, 1), np.float32)}
    return lambda: exe.run(main, feed=feed, fetch_list=[cost], scope=scope)


def test_check_nan_inf_raises_the_jax_message(monkeypatch):
    from paddle_tpu.fluid import layers as jl
    from paddle_tpu.fluid import unique_name as ju
    from paddle_tpu_torch.fluid import layers as tl
    from paddle_tpu_torch.fluid import unique_name as tu

    jrun = _nan_training(jfluid, jl, ju, jfluid.Executor())
    trun = _nan_training(tfluid, tl, tu, tfluid.Executor("cpu"))
    trun()  # off: the NaN flows through
    monkeypatch.setitem(JFLAGS, "check_nan_inf", True)
    monkeypatch.setitem(TFLAGS, "check_nan_inf", True)
    with pytest.raises(FloatingPointError) as jerr:
        jrun()
    with pytest.raises(FloatingPointError) as terr:
        trun()
    assert str(terr.value) == str(jerr.value) == \
        "var 'fc_0.w_0' contains NaN/Inf"


def test_benchmark_prints_each_run_time(monkeypatch, capsys):
    monkeypatch.setitem(TFLAGS, "benchmark", True)
    main, startup = texamples.build_fit_a_line()
    exe, scope = tfluid.Executor("cpu"), tfluid.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed={"x": np.ones((2, 13), np.float32),
                        "y": np.ones((2, 1), np.float32)}, scope=scope)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[benchmark] run took ")]
    assert len(lines) == 2 and all(ln.endswith(" ms") for ln in lines)


def test_serving_buckets_flag_is_the_default_ladder_of_both_engines():
    from paddle_tpu.fluid.flags import set_flags as jset_flags
    from paddle_tpu.serving import engine as je
    from paddle_tpu_torch.flags import set_flags as tset_flags
    from paddle_tpu_torch.serving import engine as te

    def runner(feeds, bucket):
        return [feeds["x"]]

    ladders = {}
    try:
        jset_flags({"serving_buckets": "1,3,6"})
        tset_flags({"serving_buckets": "1,3,6"})
        for name, mod in (("jax", je), ("port", te)):
            eng = mod.InferenceEngine(
                runner, [mod._FeedSpec("x", (4,), np.float32)], ["y"],
                name="ladder", fetch_batched=[True])
            try:
                ladders[name] = (list(eng._buckets), mod.default_buckets())
            finally:
                eng.stop()
    finally:
        jset_flags({"serving_buckets": "1,2,4,8,16"})
        tset_flags({"serving_buckets": "1,2,4,8,16"})
    assert ladders["port"] == ladders["jax"] == ([1, 3, 6], [1, 3, 6])


def test_trace_and_faults_flags_read_through_and_propagate():
    from paddle_tpu_torch.distributed import faults
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.observability import tracing

    assert not tracing.trace_enabled() and not TFLAGS["trace"]
    cap = TFLAGS["trace_buffer"]
    try:
        set_flags({"trace": True})
        assert tracing.trace_enabled() and TFLAGS["trace"]
        set_flags({"trace_buffer": 128})
        assert tracing.buffer_capacity() == 128 == TFLAGS["trace_buffer"]
        assert tracing.trace_enabled()  # resizing keeps the enable bit
        tracing.trace_disable()  # toggled without set_flags: read live
        assert not TFLAGS["trace"]
        spec = "seed=7;drop@recv.push_grad:1,3"
        set_flags({"faults": spec})
        assert faults.active_spec() == spec == TFLAGS["faults"]
        faults.uninstall()
        assert TFLAGS["faults"] is None
    finally:
        set_flags({"trace": False, "trace_buffer": cap, "faults": None})
    assert not tracing.trace_enabled() and faults.active() is None
