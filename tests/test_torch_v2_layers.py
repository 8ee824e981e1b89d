"""The port's v2 layer DSL against the JAX package's, on the CPU:

  - the ten golden configurations of tests/test_v2_layers_sweep.py (mlp,
    conv_pool, seq_lstm, nmt_attention, bilstm_tagger, vgg16, word2vec,
    recommender, recurrent_custom, text_conv), each built by both
    packages' ``v2`` under ``unique_name.guard()``: the default main
    program's bytes and the Topology's pruned program bytes are equal,
    the Topology's structure signature equals the committed
    ``tests/goldens/<name>.json`` (read only: this file never writes a
    golden), and serialize -> deserialize round-trips byte for byte;
  - ``recurrent_group`` (with ``memory`` and ``StaticInput``) and
    ``recurrent_layer``, and the bidirectional and step-level LSTM and GRU
    groups of ``v2.networks``, on the sweep's seeded inputs from the same
    parameters: outputs within rtol 2e-5 / atol 1e-6;
  - the sweep's elementwise, image, sequence and cost families, and the
    projections of ``mixed_layer``, from the same parameters: outputs
    within rtol 2e-5 / atol 1e-6 (ids exactly equal).
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu.v2 as jv2
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import unique_name as junique
import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.v2 as tv2
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid import unique_name as tunique

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
RTOL, ATOL = 2e-5, 1e-6
JAX = (jfluid, jv2, junique, jframework)
PORT = (tfluid, tv2, tunique, tframework)


# --- the ten golden configurations, as tests/test_v2_layers_sweep.py builds
# them (v2 = either package's v2, fl = its fluid.layers) --------------------

def _mlp(v2, fl, fluid):
    x = v2.layer.data(name="x", type=v2.layer.data_type.dense_vector(8))
    h = v2.layer.fc_layer(x, size=16, act=v2.layer.activation.Relu())
    return v2.layer.fc_layer(h, size=4, act=v2.layer.activation.Softmax())


def _conv_pool(v2, fl, fluid):
    img = v2.layer.data(name="img",
                        type=v2.layer.data_type.dense_vector(1 * 16 * 16))
    x4 = fl.reshape(img, shape=[-1, 1, 16, 16])
    conv = v2.layer.simple_img_conv_pool(
        x4, filter_size=3, num_filters=4, pool_size=2, pool_stride=2,
        act=v2.layer.activation.Relu())
    return v2.layer.fc_layer(conv, size=10,
                             act=v2.layer.activation.Softmax())


def _seq_lstm(v2, fl, fluid):
    seq = v2.layer.data(
        name="seq", type=v2.layer.data_type.dense_vector_sequence(6),
        lod_level=1)
    h = v2.layer.simple_lstm(seq, size=8)
    return v2.layer.fc_layer(v2.layer.last_seq(h), size=2,
                             act=v2.layer.activation.Softmax())


def _nmt_attention(v2, fl, fluid):
    src = v2.layer.data(
        name="src", type=v2.layer.data_type.integer_value_sequence(100),
        lod_level=1)
    trg = v2.layer.data(
        name="trg", type=v2.layer.data_type.integer_value_sequence(100),
        lod_level=1)
    semb = v2.layer.embedding_layer(src, size=8)
    enc = v2.networks.bidirectional_gru(semb, size=4, return_seq=True)
    enc_proj = v2.layer.mixed_layer(
        size=8, input=[v2.layer.full_matrix_projection(enc)])
    temb = v2.layer.embedding_layer(trg, size=8)

    def decoder_step(t_emb, enc_s, proj_s):
        state = v2.layer.memory(size=8)
        ctxv = v2.networks.simple_attention(enc_s, proj_s, state)
        inp = v2.layer.fc_layer([t_emb, ctxv], size=8, act=None)
        return v2.layer.gru_step_layer(inp, state, size=8)

    dec = v2.layer.recurrent_group(
        step=decoder_step,
        input=[temb, v2.layer.StaticInput(enc),
               v2.layer.StaticInput(enc_proj)])
    return v2.layer.fc_layer(dec, size=100,
                             act=v2.layer.activation.Softmax())


def _bilstm_tagger(v2, fl, fluid):
    words = v2.layer.data(
        name="words", type=v2.layer.data_type.integer_value_sequence(200),
        lod_level=1)
    tags = v2.layer.data(
        name="tags", type=v2.layer.data_type.integer_value_sequence(5),
        lod_level=1)
    emb = v2.layer.embedding_layer(words, size=8)
    bi = v2.networks.bidirectional_lstm(emb, size=6, return_seq=True)
    feat = v2.layer.fc_layer(bi, size=5, act=None)
    return v2.layer.crf_layer(feat, tags)


def _vgg16(v2, fl, fluid):
    img = v2.layer.data(name="img",
                        type=v2.layer.data_type.dense_vector(3 * 32 * 32))
    x4 = fl.reshape(img, shape=[-1, 3, 32, 32])
    return v2.networks.vgg_16_network(x4, num_channels=3, num_classes=10)


def _word2vec(v2, fl, fluid):
    ctx_words = [
        v2.layer.data(name=f"w{i}",
                      type=v2.layer.data_type.integer_value(1000))
        for i in range(4)
    ]
    embs = [v2.layer.embedding_layer(w, size=16,
                                     param_attr=fluid.ParamAttr(name="emb"))
            for w in ctx_words]
    merged = v2.layer.addto_layer(embs)
    hidden = v2.layer.fc_layer(merged, size=32,
                               act=v2.layer.activation.Sigmoid())
    return v2.layer.fc_layer(hidden, size=1000,
                             act=v2.layer.activation.Softmax())


def _recommender(v2, fl, fluid):
    uid = v2.layer.data(name="uid",
                        type=v2.layer.data_type.integer_value(500))
    mid = v2.layer.data(name="mid",
                        type=v2.layer.data_type.integer_value(800))
    genres = v2.layer.data(name="genres",
                           type=v2.layer.data_type.dense_vector(18))
    u = v2.layer.fc_layer(v2.layer.embedding_layer(uid, size=16), size=16,
                          act=v2.layer.activation.Tanh())
    m_emb = v2.layer.embedding_layer(mid, size=16)
    m_gen = v2.layer.fc_layer(genres, size=16, act=None)
    m = v2.layer.fc_layer(v2.layer.addto_layer([m_emb, m_gen]), size=16,
                          act=v2.layer.activation.Tanh())
    return v2.layer.cos_sim(u, m)


def _recurrent_custom(v2, fl, fluid):
    seq = v2.layer.data(
        name="seq", type=v2.layer.data_type.dense_vector_sequence(6),
        lod_level=1)
    bias = v2.layer.data(name="bias",
                         type=v2.layer.data_type.dense_vector(6))

    def step(x_t, b):
        h_prev = v2.layer.memory(size=6)
        c_prev = v2.layer.memory(size=6)
        xt = v2.layer.addto_layer([x_t, b])
        h = v2.layer.fc_layer([xt, h_prev], size=6,
                              act=v2.layer.activation.Tanh())
        c = v2.layer.addto_layer([c_prev, h])
        return h, c

    h, c = v2.layer.recurrent_group(
        step=step, input=[seq, v2.layer.StaticInput(bias)])
    return v2.layer.fc_layer(v2.layer.last_seq(c), size=2,
                             act=v2.layer.activation.Softmax())


def _text_conv(v2, fl, fluid):
    words = v2.layer.data(
        name="words", type=v2.layer.data_type.integer_value_sequence(300),
        lod_level=1)
    emb = v2.layer.embedding_layer(words, size=16)
    conv3 = v2.networks.sequence_conv_pool(emb, context_len=3,
                                           hidden_size=12)
    conv4 = v2.networks.sequence_conv_pool(emb, context_len=4,
                                           hidden_size=12)
    return v2.layer.fc_layer([conv3, conv4], size=2,
                             act=v2.layer.activation.Softmax())


GOLDENS = {"mlp": _mlp, "conv_pool": _conv_pool, "seq_lstm": _seq_lstm,
           "nmt_attention": _nmt_attention, "bilstm_tagger": _bilstm_tagger,
           "vgg16": _vgg16, "word2vec": _word2vec,
           "recommender": _recommender,
           "recurrent_custom": _recurrent_custom, "text_conv": _text_conv}


def _build(pkg, body):
    """``body`` in fresh default programs under a fresh name guard; the
    programs, what it returned and (for one output) its Topology."""
    fluid, v2, unique, fw = pkg
    main, startup = fw.Program(), fw.Program()
    with fw.program_guard(main, startup), unique.guard():
        out = body(v2, fluid.layers, fluid)
        topo = v2.topology.Topology(out) \
            if not isinstance(out, (list, tuple)) else None
    return main, startup, out, topo


def _structure(program):
    """tests/test_v2_layers_sweep.py's golden signature: op types and
    per-op output shapes."""
    block = program.global_block()
    sig = []
    for op in block.ops:
        outs = []
        for n in op.desc.output_names():
            v = block._var_recursive(n)
            outs.append([n, list(v.shape) if v is not None and v.shape
                         else None])
        sig.append([op.type, outs])
    return sig


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_golden_config_bytes_and_structure(name):
    tm, ts, _, ttopo = _build(PORT, GOLDENS[name])
    jm, js, _, jtopo = _build(JAX, GOLDENS[name])
    assert tm.to_bytes() == jm.to_bytes()
    assert ts.to_bytes() == js.to_bytes()
    assert ttopo.main_program.to_bytes() == jtopo.main_program.to_bytes()
    data = ttopo.serialize()
    clone = tv2.topology.Topology.deserialize(data)
    assert clone.main_program.to_bytes() == ttopo.main_program.to_bytes()
    assert clone.startup_program.to_bytes() == ts.to_bytes()
    assert clone.output_names() == ttopo.output_names()
    # the JAX package's serialization loads in the port and back
    jclone = tv2.topology.Topology.deserialize(jtopo.serialize())
    assert jclone.main_program.to_bytes() == jtopo.main_program.to_bytes()
    with open(os.path.join(GOLDEN_DIR, name + ".json")) as f:
        golden = json.load(f)
    assert _structure(ttopo.main_program) == golden


# --- values from the same parameters -----------------------------------------

def _values(pkg, main, startup, fetch, feed, params=None):
    """Run ``startup``, overwrite every parameter from ``params`` (name ->
    numpy), run ``main`` on ``feed``; the fetches and the parameters."""
    fluid = pkg[0]
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    names = [p.name for p in main.global_block().all_parameters()]
    if params is None:
        params = {n: np.asarray(tfluid.fetch_var(n, scope)) for n in names}
    else:
        for n in names:
            scope.set_var(n, torch.from_numpy(params[n])
                          if fluid is tfluid else jnp.asarray(params[n]))
    outs = exe.run(main, feed=feed, fetch_list=list(fetch), scope=scope)
    return [np.asarray(o) for o in outs], params


def _parity(body, feed):
    tm, ts, tout, _ = _build(PORT, body)
    jm, js, jout, _ = _build(JAX, body)
    assert tm.to_bytes() == jm.to_bytes()
    tout = list(tout) if isinstance(tout, (list, tuple)) else [tout]
    jout = list(jout) if isinstance(jout, (list, tuple)) else [jout]
    got, params = _values(PORT, tm, ts, tout, feed)
    want, _ = _values(JAX, jm, js, jout, feed, params)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        if g.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=str(i))
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=str(i))
    return got


def _rg_manual(v2, fl, fluid):
    seq = v2.layer.data(
        name="rg_seq", type=v2.layer.data_type.dense_vector_sequence(3),
        lod_level=1)

    def step(x_t):
        h_prev = v2.layer.memory(size=3)
        return v2.layer.fc_layer([x_t, h_prev], size=3,
                                 act=v2.layer.activation.Tanh())

    return [v2.layer.recurrent_group(step=step, input=seq),
            v2.layer.recurrent_group(step=step, input=seq, reverse=True)]


def _rl_static(v2, fl, fluid):
    seq = v2.layer.data(
        name="rl_seq", type=v2.layer.data_type.dense_vector_sequence(4),
        lod_level=1)
    ctxv = v2.layer.data(name="rl_ctx",
                         type=v2.layer.data_type.dense_vector(4))
    rl = v2.layer.recurrent_layer(seq)

    def step(x_t, c):
        h_prev = v2.layer.memory(size=4)
        return v2.layer.fc_layer([x_t, h_prev, c], size=4,
                                 act=v2.layer.activation.Tanh())

    rg = v2.layer.recurrent_group(
        step=step, input=[seq, v2.layer.StaticInput(ctxv)])
    return [rl, rg]


def _rnn_groups(v2, fl, fluid):
    seq = v2.layer.data(
        name="seq", type=v2.layer.data_type.dense_vector_sequence(6),
        lod_level=1)
    gates4 = v2.layer.fc_layer(seq, size=16)
    gates3 = v2.layer.fc_layer(seq, size=12)
    return [v2.networks.lstmemory_group(gates4, size=4),
            v2.networks.gru_group(gates3, size=4, reverse=True),
            v2.networks.bidirectional_lstm(seq, size=4),
            v2.networks.bidirectional_gru(seq, size=4, return_seq=True),
            v2.networks.text_conv_pool(seq, context_len=3, hidden_size=5)]


RECURRENCE = {
    "recurrent_group": (_rg_manual, lambda rng: {
        "rg_seq": rng.rand(2, 4, 3).astype(np.float32),
        "rg_seq@LEN": np.array([4, 2], np.int32)}),
    "recurrent_layer_and_static_input": (_rl_static, lambda rng: {
        "rl_seq": rng.rand(2, 3, 4).astype(np.float32),
        "rl_seq@LEN": np.array([3, 1], np.int32),
        "rl_ctx": rng.rand(2, 4).astype(np.float32)}),
    "lstm_gru_groups": (_rnn_groups, lambda rng: {
        "seq": rng.rand(2, 5, 6).astype(np.float32),
        "seq@LEN": np.array([5, 3], np.int32)}),
}


@pytest.mark.parametrize("name", sorted(RECURRENCE))
def test_recurrence_matches_jax(name):
    body, feed = RECURRENCE[name]
    got = _parity(body, feed(np.random.RandomState(8)))
    if name == "recurrent_group":
        # masked past each sequence's length
        assert np.all(got[0][1, 2:] == 0) and np.all(got[1][1, 2:] == 0)


def _elementwise(v2, fl, fluid):
    x = v2.layer.data(name="x", type=v2.layer.data_type.dense_vector(6))
    y = v2.layer.data(name="y", type=v2.layer.data_type.dense_vector(6))
    w = v2.layer.data(name="w", type=v2.layer.data_type.dense_vector(1))
    return [
        v2.layer.interpolation_layer([x, y], w),
        v2.layer.power_layer(x, w),
        v2.layer.sum_to_one_norm_layer(x),
        v2.layer.row_l2_norm_layer(x),
        v2.layer.dot_prod_layer(x, y),
        v2.layer.out_prod_layer(x, y),
        v2.layer.linear_comb_layer(w, x, size=6),
        v2.layer.l2_distance_layer(x, y),
        v2.layer.clip_layer(x, min=-0.5, max=0.5),
        v2.layer.scale_shift_layer(x),
        v2.layer.slope_intercept_layer(x, slope=2.0, intercept=1.0),
        v2.layer.addto_layer([x, y]),
        v2.layer.cos_sim(x, fl.concat([y, y], axis=1), size=2),
        v2.op.add(x, y), v2.op.sub(x, 1.0), v2.op.mul(x, 2.0),
        v2.op.neg(y),
    ]


def _image(v2, fl, fluid):
    img = v2.layer.data(name="img",
                        type=v2.layer.data_type.dense_vector(2 * 8 * 8))
    x4 = fl.reshape(img, shape=[-1, 2, 8, 8])
    return [
        v2.layer.maxout_layer(x4, groups=2),
        v2.layer.spp_layer(x4, pyramid_height=2),
        v2.layer.img_cmrnorm_layer(x4, size=3),
        v2.layer.pad_layer(x4, pad_c=[1, 1], pad_h=[0, 0], pad_w=[2, 2]),
        v2.layer.rotate_layer(x4, height=8, width=8),
        v2.layer.repeat_layer(img, num_repeats=2),
        v2.layer.img_conv_layer(x4, filter_size=3, num_filters=4,
                                act=v2.layer.activation.Relu()),
        v2.layer.img_conv_layer(x4, filter_size=3, num_filters=3, stride=2,
                                trans=True),
        v2.layer.img_pool_layer(x4, pool_size=2, stride=2),
        v2.networks.img_conv_group(
            x4, conv_num_filter=[4, 4], pool_size=2, pool_stride=2),
        v2.layer.mixed_layer(input=[v2.layer.conv_projection(
            x4, filter_size=3, num_filters=3, padding=1)]),
    ]


def _sequence(v2, fl, fluid):
    seq = v2.layer.data(
        name="seq", type=v2.layer.data_type.dense_vector_sequence(4),
        lod_level=1)
    pooled = v2.layer.pooling_layer(seq, pooling_type=v2.layer.pooling.Max())
    return [
        v2.layer.seq_reshape_layer(seq, reshape_size=2),
        v2.layer.row_conv_layer(seq, context_len=2),
        pooled,
        v2.layer.pooling_layer(seq, pooling_type=v2.layer.pooling.Avg()),
        v2.layer.first_seq(seq),
        v2.layer.last_seq(seq),
        v2.layer.mixed_layer(
            size=5, input=[v2.layer.full_matrix_projection(pooled)]),
        v2.layer.mixed_layer(input=[v2.layer.context_projection(
            seq, context_len=3)]),
    ]


def _costs(v2, fl, fluid):
    x = v2.layer.data(name="x", type=v2.layer.data_type.dense_vector(4))
    lbl = v2.layer.data(name="lbl", type=v2.layer.data_type.dense_vector(4))
    ilbl = v2.layer.data(name="il", type=v2.layer.data_type.integer_value(4))
    left = v2.layer.data(name="l", type=v2.layer.data_type.dense_vector(1))
    right = v2.layer.data(name="r", type=v2.layer.data_type.dense_vector(1))
    rlabel = v2.layer.data(name="rl",
                           type=v2.layer.data_type.dense_vector(1))
    probs = v2.layer.softmax_layer(x)
    return [
        v2.layer.classification_cost(probs, ilbl),
        v2.layer.regression_cost(x, lbl),
        v2.layer.multi_binary_label_cross_entropy(x, lbl),
        v2.layer.smooth_l1_cost(x, lbl),
        v2.layer.huber_regression_cost(x, lbl),
        v2.layer.rank_cost(left, right, rlabel),
        v2.layer.sum_cost(x),
        v2.layer.cross_entropy_with_selfnorm(probs, ilbl),
    ]


def _projections(v2, fl, fluid):
    ids = v2.layer.data(name="ids",
                        type=v2.layer.data_type.integer_value(50))
    x = v2.layer.data(name="x", type=v2.layer.data_type.dense_vector(8))
    return [
        v2.layer.mixed_layer(size=8, input=[
            v2.layer.full_matrix_projection(x),
            v2.layer.table_projection(ids),
            v2.layer.identity_projection(x),
            v2.layer.dotmul_projection(x),
        ], act=v2.layer.activation.Tanh()),
        v2.layer.mixed_layer(size=8, input=[v2.layer.scaling_projection(x)]),
        v2.layer.mixed_layer(
            size=5, input=[v2.layer.trans_full_matrix_projection(x)]),
        v2.layer.mixed_layer(
            size=4, input=[v2.layer.slice_projection(x, [(0, 2), (4, 6)])]),
        v2.layer.tensor_layer(x, x, size=3),
        v2.layer.gated_unit_layer(x, size=5),
        v2.layer.factorization_machine(x, factor_size=4),
    ]


FAMILIES = {
    "elementwise": (_elementwise, lambda rng: {
        "x": rng.rand(3, 6).astype(np.float32) + 0.1,
        "y": rng.rand(3, 6).astype(np.float32),
        "w": rng.rand(3, 1).astype(np.float32)}),
    "image": (_image, lambda rng: {
        "img": rng.rand(2, 128).astype(np.float32)}),
    "sequence": (_sequence, lambda rng: {
        "seq": rng.rand(2, 3, 4).astype(np.float32),
        "seq@LEN": np.array([3, 2], np.int32)}),
    "costs": (_costs, lambda rng: {
        "x": rng.rand(4, 4).astype(np.float32),
        "lbl": rng.rand(4, 4).astype(np.float32),
        "il": rng.randint(0, 4, (4, 1)).astype(np.int64),
        "l": rng.rand(4, 1).astype(np.float32),
        "r": rng.rand(4, 1).astype(np.float32),
        "rl": (rng.rand(4, 1) > 0.5).astype(np.float32)}),
    "projections": (_projections, lambda rng: {
        "x": rng.rand(3, 8).astype(np.float32),
        "ids": rng.randint(0, 50, (3, 1)).astype(np.int64)}),
}


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_layer_family_matches_jax(name):
    body, feed = FAMILIES[name]
    _parity(body, feed(np.random.RandomState(3)))
