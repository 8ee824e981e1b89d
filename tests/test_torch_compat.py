"""The port's legacy config DSL (``paddle_tpu_torch.compat.
trainer_config_helpers``) against the JAX package's, on the CPU.

Four legacy config files, written here in the reference's own idiom
(``from paddle.trainer_config_helpers import *``, ``settings``,
``outputs``), run through each package's ``compat`` behind the same
``sys.modules['paddle']`` shim as tests/test_reference_configs.py: an
image classifier (``img_conv_layer`` -> ``img_pool_layer`` ->
``fc_layer`` -> ``classification_cost``), an LSTM text classifier over
an integer sequence, a ``mixed_layer`` of projections in the context
manager form with a regression cost, and a custom ``recurrent_group``
with a ``memory``. Each builds the same program bytes in both packages,
then takes two SGD steps (the learning rate from ``settings``) from the
same parameters: both costs within rtol 2e-5 / atol 1e-6.
"""
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.compat import trainer_config_helpers as jtch
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import unique_name as junique
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.compat import trainer_config_helpers as ttch
from paddle_tpu_torch.fluid import framework as tframework
from paddle_tpu_torch.fluid import unique_name as tunique

RTOL, ATOL = 2e-5, 1e-6
N, T = 4, 5

IMAGE_CLASSIFIER = """
from paddle.trainer_config_helpers import *

settings(batch_size=4, learning_rate=0.05)
img = data_layer(name='pixel', size=3 * 16 * 16, height=16, width=16)
conv = img_conv_layer(input=img, filter_size=3, num_filters=8,
                      num_channels=3, padding=1, act=ReluActivation())
pool = img_pool_layer(input=conv, pool_size=2, stride=2,
                      pool_type=MaxPooling())
prob = fc_layer(input=pool, size=10, act=SoftmaxActivation())
label = data_layer(name='label', size=10)
outputs(classification_cost(input=prob, label=label))
"""

LSTM_TEXT = """
from paddle.trainer_config_helpers import *

settings(batch_size=4, learning_rate=0.1)
words = data_layer(name='words', size=50)
emb = embedding_layer(input=words, size=8)
gates = fc_layer(input=emb, size=4 * 6, act=LinearActivation())
lstm = lstmemory(input=gates, size=6)
prob = fc_layer(input=last_seq(input=lstm), size=2,
                act=SoftmaxActivation())
label = data_layer(name='label', size=2)
outputs(classification_cost(input=prob, label=label))
"""

MIXED_PROJECTIONS = """
from paddle.trainer_config_helpers import *

settings(batch_size=4, learning_rate=0.02)
x = data_layer(name='x', size=8)
ids = data_layer(name='ids', size=20)
with mixed_layer(size=8, act=TanhActivation()) as m:
    m += full_matrix_projection(input=x)
    m += table_projection(input=ids)
    m += identity_projection(input=x)
hidden = fc_layer(input=m, size=4, act=SigmoidActivation(),
                  param_attr=ParamAttr(initial_std=0.1))
y = data_layer(name='y', size=4)
outputs(regression_cost(input=hidden, label=y))
"""

RECURRENT_GROUP = """
from paddle.trainer_config_helpers import *

settings(batch_size=4, learning_rate=0.05)
seq = data_layer(name='seq', size=6)

def step(x_t):
    h_prev = memory(name='h', size=5)
    return fc_layer(input=[x_t, h_prev], size=5, act=TanhActivation())

rnn = recurrent_group(step=step, input=seq)
prob = fc_layer(input=last_seq(input=rnn), size=3,
                act=SoftmaxActivation())
label = data_layer(name='label', size=3)
outputs(classification_cost(input=prob, label=label))
"""

CONFIGS = {
    "image_classifier": (IMAGE_CLASSIFIER, {"label": "int"}),
    "lstm_text": (LSTM_TEXT, {"words": "int_seq", "label": "int"}),
    "mixed_projections": (MIXED_PROJECTIONS, {"ids": "int"}),
    "recurrent_group": (RECURRENT_GROUP, {"seq": "seq", "label": "int"}),
}


def _feed_for(name, var, kind, rng):
    t = getattr(var, "_v2_type", None)
    dim = t.dim if t is not None else int(var.shape[-1])
    if kind == "dense":
        return {name: (rng.rand(N, dim) * 0.5 + 0.25).astype(np.float32)}
    if kind == "int":
        return {name: rng.randint(0, max(dim, 2), (N, 1)).astype(np.int64)}
    lens = np.maximum(1, T - np.arange(N) % 3).astype(np.int32)
    if kind == "seq":
        val = (rng.rand(N, T, dim) * 0.5 + 0.25).astype(np.float32)
    else:
        val = rng.randint(0, max(dim, 2), (N, T, 1)).astype(np.int64)
    return {name: val, name + "@LEN": lens}


def _build(tch, fluid, fw, unique, src, types_):
    """Exec the config through ``tch`` behind the ``paddle`` shim; the
    programs, the loss with SGD attached, and the data layers."""
    main, startup = fw.Program(), fw.Program()
    saved = {k: sys.modules.get(k)
             for k in ("paddle", "paddle.trainer_config_helpers")}
    pkg = types.ModuleType("paddle")
    pkg.trainer_config_helpers = tch
    pkg.__path__ = []
    sys.modules["paddle"] = pkg
    sys.modules["paddle.trainer_config_helpers"] = tch
    tch.reset()
    try:
        with unique.guard(), fw.program_guard(main, startup):
            tch.declare_input_types(types_)
            exec(compile(src, "<legacy config>", "exec"),
                 {"__name__": "legacy_config"})
            cfg = tch.get_config()
            (loss,) = cfg["outputs"]
            fluid.optimizer.SGD(
                learning_rate=float(cfg["settings"]["learning_rate"])
            ).minimize(loss)
        return main, startup, loss, list(cfg["data_layers"])
    finally:
        tch.reset()
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def _steps(fluid, main, startup, loss, feed, params=None):
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
    costs = [float(np.asarray(exe.run(main, feed=feed, fetch_list=[loss],
                                      scope=scope)[0]).ravel()[0])
             for _ in range(2)]
    return costs, params


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_legacy_config_steps_alike_in_both_packages(name):
    src, types_ = CONFIGS[name]
    tm, ts, tloss, tdata = _build(ttch, tfluid, tframework, tunique, src,
                                  types_)
    jm, js, jloss, _ = _build(jtch, jfluid, jframework, junique, src,
                              types_)
    assert tm.to_bytes() == jm.to_bytes()
    assert ts.to_bytes() == js.to_bytes()
    rng = np.random.RandomState(7)
    feed = {}
    for dname, var, kind in tdata:
        feed.update(_feed_for(dname, var, kind, rng))
    got, params = _steps(tfluid, tm, ts, tloss, feed)
    want, _ = _steps(jfluid, jm, js, jloss, feed, params)
    assert np.isfinite(got).all() and got[1] != got[0]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_harness_hooks():
    """``reset``, ``set_fixed_batch``, ``declare_input_types`` and
    ``settings`` record what the harness reads back, as the JAX
    package's do."""
    main, startup = tframework.Program(), tframework.Program()
    ttch.reset()
    try:
        with tunique.guard(), tframework.program_guard(main, startup):
            ttch.settings(batch_size=8, learning_rate=0.5)
            ttch.set_fixed_batch(8)
            ttch.declare_input_types({"s": "seq"})
            d = ttch.data_layer(name="d", size=3)
            s = ttch.data_layer(name="s", size=2)
            ttch.outputs(ttch.fc_layer(input=d, size=2))
            cfg = ttch.get_config()
        assert cfg["settings"] == {"batch_size": 8, "learning_rate": 0.5}
        assert list(d.shape) == [8, 3] and s.lod_level == 1
        assert [(n, k) for n, _, k in cfg["data_layers"]] == [
            ("d", "dense"), ("s", "seq")]
        assert len(cfg["outputs"]) == 1
    finally:
        ttch.reset()
    assert ttch.get_config() == {"settings": {}, "outputs": [],
                                 "data_layers": []}
    with pytest.raises(NotImplementedError):
        ttch.define_py_data_sources2()
