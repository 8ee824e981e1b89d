"""The port's Fluid stack (paddle_tpu_torch/fluid, models/transformer.py)
against the JAX package's, on the CPU, at a small size.

  (a) the Transformer program the port builds equals the JAX one: op
      types in order, every variable's name, shape and dtype, parameter
      names; and at Transformer-base width the op census gives the
      kernel launches per step that chip_smoke.py asserts;
  (b) a Program serialized by paddle_tpu (``to_bytes``) loads in the port
      and trains to the same losses;
  (c) a small Transformer (vocab 64, max_len 16, d_model 32, 4 heads,
      d_ff 64, 2 layers, dropout 0, seq_parallel) starts from the JAX
      scope's values (``params_from_jax``) and takes 4 Adam steps: the
      per-step losses and the step-1 parameter gradients equal the JAX
      package's, with its Pallas kernels in interpret mode
      (``use_pallas_kernels=True, flash_min_seq=0``) and without them;
  (d) an SGD fit_a_line program gives the same losses in both.

Tolerances (float32; XLA and PyTorch sum in other orders): losses within
2e-5 relative, gradients within 1e-6 absolute plus 1e-4 relative.
Dropout masks cannot match (jax.random vs torch.Generator), hence
dropout 0 where values are compared.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.fluid.flags import FLAGS as JFLAGS, set_flags
from paddle_tpu.models import transformer as jtransformer
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.fluid import layers as tlayers
from paddle_tpu_torch.fluid import unique_name as tunique
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import layer_norm as tln
from paddle_tpu_torch.models import transformer as ttransformer

LOSS_RTOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
SMALL = dict(src_vocab=64, trg_vocab=64, max_len=16, d_model=32, n_heads=4,
             d_ff=64, n_layers=2, dropout=0.0, seq_parallel=True)
BASE = dict(src_vocab=32000, trg_vocab=32000, max_len=512, d_model=512,
            n_heads=8, d_ff=2048, n_layers=6, dropout=0.1, seq_parallel=True)


def _build_transformer(fluid, layers, unique_name, transformer, cfg_kw, lr):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with unique_name.guard(), fluid.program_guard(main, startup):
        cfg = transformer.TransformerConfig(**cfg_kw)
        src = layers.data(name="src", shape=[cfg.max_len], dtype="int64")
        trg = layers.data(name="trg", shape=[cfg.max_len], dtype="int64")
        lab = layers.data(name="lab", shape=[cfg.max_len, 1], dtype="int64")
        cost, _ = transformer.build_train(cfg, src, trg, lab)
        _, params_grads = fluid.optimizer.Adam(lr).minimize(cost)
    return main, startup, cost, [(p.name, g.name) for p, g in params_grads]


def _feed(rng, batch, cfg_kw):
    v, n = cfg_kw["src_vocab"], cfg_kw["max_len"]
    return {"src": rng.randint(0, v, (batch, n)).astype(np.int64),
            "trg": rng.randint(0, v, (batch, n)).astype(np.int64),
            "lab": rng.randint(0, v, (batch, n, 1)).astype(np.int64)}


def _jax_persistables(program, scope):
    return {n: np.asarray(scope.find_var(n))
            for n, v in program.global_block().vars.items()
            if v.persistable and scope.find_var(n) is not None}


@pytest.fixture
def jax_flags():
    saved = {k: JFLAGS[k] for k in ("use_pallas_kernels", "flash_min_seq")}
    yield set_flags
    set_flags(saved)


def _var_table(program):
    return [(n, tuple(v.shape) if v.shape is not None else None, v.dtype,
             v.persistable, v.desc.is_parameter)
            for n, v in program.global_block().vars.items()]


def test_a_transformer_program_equals_jax():
    jm, js, _, jpg = _build_transformer(jfluid, jlayers, junique,
                                        jtransformer, SMALL, 1e-3)
    tm, ts, _, tpg = _build_transformer(tfluid, tlayers, tunique,
                                        ttransformer, SMALL, 1e-3)
    assert jpg == tpg and len(tpg) > 40
    for jp, tp in ((jm, tm), (js, ts)):
        jops = [(op.type, op.desc.inputs, op.desc.outputs)
                for op in jp.global_block().ops]
        tops = [(op.type, op.desc.inputs, op.desc.outputs)
                for op in tp.global_block().ops]
        assert jops == tops
        assert _var_table(jp) == _var_table(tp)
    params = [p.name for p in tm.global_block().all_parameters()]
    assert params == [p.name for p in jm.global_block().all_parameters()]


def test_a_transformer_base_op_census():
    """Transformer-base (the train phase of chip_smoke.py): per step 30
    layer_norm ops (K1), 18 ring_attention ops (K2) each with its grad op
    (K3a + K3b), 6 of them causal; 186 parameters, 184 trainable."""
    main, startup, _, pg = _build_transformer(tfluid, tlayers, tunique,
                                              ttransformer, BASE, 1e-4)
    types = [op.type for op in main.global_block().ops]
    attn = [op for op in main.global_block().ops
            if op.type == "ring_attention"]
    assert types.count("layer_norm") == 30
    assert types.count("layer_norm_grad") == 30
    assert len(attn) == 18 and types.count("ring_attention_grad") == 18
    assert sum(bool(op.attr("causal")) for op in attn) == 6
    assert types.count("adam") == len(pg) == 184
    assert types.count("dropout") == 14
    params = main.global_block().all_parameters()
    assert len(params) == 186
    assert sum(int(np.prod(p.shape)) for p in params) == 93_809_920
    st = [op.type for op in startup.global_block().ops]
    assert (st.count("fill_constant"), st.count("uniform_random"),
            st.count("assign_value")) == (822, 99, 2)


def _train_both(jm, js, jcost, tm, tcost, feeds, fetch_grads=()):
    """Run the JAX startup, copy every persistable into the port's scope,
    then train both on the same feeds. Returns per-step losses (and the
    step-1 fetches of ``fetch_grads``) of each side."""
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    texe, tscope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
    tfluid.params_from_jax(_jax_persistables(jm, jscope), tscope,
                           device="cpu")
    out = {}
    for side, exe, prog, cost, scope in (("jax", jexe, jm, jcost, jscope),
                                         ("torch", texe, tm, tcost, tscope)):
        losses, grads = [], None
        for i, feed in enumerate(feeds):
            fetched = exe.run(prog, feed=feed, scope=scope,
                              fetch_list=[cost] + list(fetch_grads if i == 0
                                                       else ()))
            losses.append(float(np.asarray(fetched[0]).reshape(-1)[0]))
            if i == 0:
                grads = [np.asarray(g) for g in fetched[1:]]
        out[side] = (losses, grads)
    return out


@pytest.mark.parametrize("pallas", [True, False])
def test_c_small_transformer_trains_like_jax(pallas, jax_flags):
    jax_flags({"use_pallas_kernels": pallas, "flash_min_seq": 0})
    jm, js, jcost, jpg = _build_transformer(jfluid, jlayers, junique,
                                            jtransformer, SMALL, 1e-3)
    tm, _, tcost, _ = _build_transformer(tfluid, tlayers, tunique,
                                         ttransformer, SMALL, 1e-3)
    rng = np.random.RandomState(5)
    feeds = [_feed(rng, 3, SMALL) for _ in range(4)]
    grads = [g for _, g in jpg]
    ln0, fa0 = dict(tln.counts.plain_calls), dict(tfa.counts.plain_calls)
    out = _train_both(jm, js, jcost, tm, tcost, feeds, grads)
    # the port went through the kernels' plain versions: 10 layer norms
    # and 6 attentions (each with its backward) per step, run once each
    assert tln.counts.plain_calls[tln.KERNEL] - ln0[tln.KERNEL] == 40
    assert all(tfa.counts.plain_calls[n] - fa0[n] == 24 for n in fa0)
    (jl, jg), (tl, tg) = out["jax"], out["torch"]
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tl[-1] < tl[0]
    assert len(tg) == len(jg) == len(grads)
    for name, a, b in zip(grads, tg, jg):
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_b_program_bytes_from_jax_load_and_train():
    jm, js, jcost, _ = _build_transformer(jfluid, jlayers, junique,
                                          jtransformer, SMALL, 1e-3)
    tm = tfluid.Program.parse_from_bytes(jm.to_bytes())
    ts = tfluid.Program.parse_from_bytes(js.to_bytes())
    assert tm.to_bytes() == jm.to_bytes()
    tcost = tm.global_block().var(jcost.name)
    # the port's own startup program runs on the loaded bytes
    exe, scope = tfluid.Executor("cpu"), tfluid.Scope()
    exe.run(ts, scope=scope)
    rng = np.random.RandomState(9)
    feed = _feed(rng, 2, SMALL)
    (l0,) = exe.run(tm, feed=feed, fetch_list=[tcost], scope=scope)
    assert np.isfinite(l0).all()
    # and from the JAX scope's values it computes the JAX losses
    feeds = [_feed(rng, 2, SMALL) for _ in range(3)]
    out = _train_both(jm, js, jcost, tm, tcost, feeds)
    np.testing.assert_allclose(out["torch"][0], out["jax"][0],
                               rtol=LOSS_RTOL)


def _build_fit_a_line(fluid, layers, unique_name):
    main, startup = fluid.Program(), fluid.Program()
    # seeded: an unseeded startup draws from a process-global counter, so
    # the initial weights would depend on which tests ran before
    main.random_seed = startup.random_seed = 3
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data(name="x", shape=[13], dtype="float32")
        y = layers.data(name="y", shape=[1], dtype="float32")
        pred = layers.fc(input=x, size=1)
        cost = layers.mean(layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.SGD(learning_rate=0.01).minimize(cost)
    return main, startup, cost


def test_d_fit_a_line_sgd_matches_jax():
    jm, js, jcost = _build_fit_a_line(jfluid, jlayers, junique)
    tm, _, tcost = _build_fit_a_line(tfluid, tlayers, tunique)
    assert [op.type for op in tm.global_block().ops] == \
        [op.type for op in jm.global_block().ops]
    rng = np.random.RandomState(1)
    w = rng.randn(13, 1).astype(np.float32)
    feeds = []
    for _ in range(6):
        x = rng.randn(20, 13).astype(np.float32)
        feeds.append({"x": x, "y": (x @ w + 0.5).astype(np.float32)})
    # the first batch once more after the 6 steps: the loss on the SAME
    # batch falls (batch-to-batch noise exceeds what 6 steps of SGD gain,
    # so first-vs-last across different batches would not show it)
    out = _train_both(jm, js, jcost, tm, tcost, feeds + feeds[:1])
    np.testing.assert_allclose(out["torch"][0], out["jax"][0],
                               rtol=LOSS_RTOL)
    assert out["torch"][0][-1] < out["torch"][0][0]


def test_dropout_is_deterministic_and_runs_each_forward_once():
    """With dropout on, two seeded runs give the same losses (the masks
    come from the op's generator), and each dropout's grad op reuses the
    forward's record — its mask — instead of drawing again."""
    kw = dict(SMALL, dropout=0.3)
    losses = []
    for _ in range(2):
        tm, ts, tcost, _ = _build_transformer(tfluid, tlayers, tunique,
                                              ttransformer, kw, 1e-3)
        exe, scope = tfluid.Executor(tfluid.CPUPlace()), tfluid.Scope()
        exe.run(ts, scope=scope)
        rng = np.random.RandomState(2)
        fa0 = dict(tfa.counts.plain_calls)
        losses.append([float(exe.run(tm, feed=_feed(rng, 2, kw),
                                     fetch_list=[tcost], scope=scope)[0][0])
                       for _ in range(2)])
        assert tfa.counts.plain_calls[tfa.FWD] - fa0[tfa.FWD] == 12
    assert losses[0] == losses[1] and all(np.isfinite(losses[0]))


def test_executor_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfluid.Executor()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfluid.params_from_jax({"w": np.zeros(2, np.float32)},
                               tfluid.Scope())
    assert tfluid.Executor(tfluid.CPUPlace()).device.type == "cpu"


def test_not_ported_paths_raise():
    # the exported-model format is the one path left (StableHLO); the
    # send op (tests/test_torch_pserver.py) and the master service a
    # cloud reader leases from (tests/test_torch_multihost.py) are ported
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tfluid.io.export_compiled_model("unused", [], [], None)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tfluid.io.load_exported_model("unused")


def test_grad_op_replays_its_forward_without_a_record():
    """A grad op whose forward op did not run in the same block run
    replays the forward (the JAX package's semantics) and gives the same
    gradients as the recorded path; a missing cotangent is a zero one."""
    from paddle_tpu_torch.fluid.registry import (
        FWD_META_ATTR, EmitCtx, forward_with_grad, run_grad)

    rng = np.random.RandomState(3)
    x = torch.tensor(rng.randn(4, 3).astype(np.float32))
    y = torch.tensor(rng.randn(3, 5).astype(np.float32))
    dout = torch.tensor(rng.randn(4, 5).astype(np.float32))
    attrs = {"x_num_col_dims": 1, "y_num_col_dims": 1}
    ctx = EmitCtx(device="cpu", root_seed=1)
    grad_attrs = {FWD_META_ATTR: {"type": "mul", "attrs": attrs,
                                  "in_slots": ["X", "Y"],
                                  "out_slots": ["Out"]}}
    ins = {"X": [x], "Y": [y], "GRAD@Out": [dout]}
    _, record = forward_with_grad(ctx, "mul", {"X": [x], "Y": [y]}, attrs)
    recorded = run_grad(ctx, ins, grad_attrs, record)
    replayed = run_grad(ctx, ins, grad_attrs)
    for slot, want in (("GRAD@X", dout @ y.T), ("GRAD@Y", x.T @ dout)):
        torch.testing.assert_close(recorded[slot][0], want)
        torch.testing.assert_close(replayed[slot][0], want)
    zero = run_grad(ctx, {"X": [x], "Y": [y]}, grad_attrs)
    assert not zero["GRAD@X"][0].any() and not zero["GRAD@Y"][0].any()


def test_delete_var_drops_values_but_keeps_fetch_targets():
    from paddle_tpu_torch.fluid.proto import OpDesc
    from paddle_tpu_torch.fluid.registry import EmitCtx, exec_op_descs

    env = {"a": torch.ones(2), "b": torch.ones(2)}
    ops = [OpDesc(type="elementwise_add", inputs={"X": ["a"], "Y": ["b"]},
                  outputs={"Out": ["c"]}),
           OpDesc(type="delete_var", inputs={"X": ["a", "c"]})]
    exec_op_descs(EmitCtx(device="cpu"), ops, env, keep=frozenset({"c"}))
    assert "a" not in env and torch.equal(env["c"], torch.full((2,), 2.0))


def test_shape_inference_rejects_warns_or_raises(monkeypatch):
    """Meta-tensor shape inference keeps the JAX package's rule: fully
    known shapes an emitter rejects fail the build; an unexpected emitter
    error warns once per op type, or raises under
    FLAGS['strict_shape_inference']."""
    from paddle_tpu_torch.flags import FLAGS
    from paddle_tpu_torch.fluid import framework, registry

    blk = tfluid.Program().global_block()
    x = blk.create_var(name="x", shape=[2, 3], dtype="float32")
    w = blk.create_var(name="w", shape=[4, 5], dtype="float32")
    with pytest.raises(ValueError, match="rejects its inputs"):
        blk.append_op(type="mul", inputs={"X": [x], "Y": [w]},
                      outputs={"Out": ["o"]})
    name = "_emitter_with_a_bug"
    if name not in registry.OPS:
        @registry.register_op(name)
        def _buggy(ctx, ins, attrs):
            raise KeyError("emitter bug")
    monkeypatch.setattr(framework, "_infer_shape_warned", set())
    with pytest.warns(RuntimeWarning, match="emitter bug"):
        blk.append_op(type=name, inputs={"X": [x]}, outputs={"Out": ["y"]})
    monkeypatch.setitem(FLAGS, "strict_shape_inference", True)
    with pytest.raises(RuntimeError, match="strict_shape_inference"):
        blk.append_op(type=name, inputs={"X": [x]}, outputs={"Out": ["y"]})
