"""`paddle.trainer_config_helpers` — the reference's legacy config DSL
surface (reference python/paddle/trainer_config_helpers/{layers,networks,
activations,poolings,attrs,optimizers,math}.py), mapped onto the v2 layer
functions so the reference's OWN config files execute unmodified:

    sys.modules['paddle.trainer_config_helpers'] = this module
    exec(open('tests/configs/projections.py').read())

Differences from the reference module (all by design):
  - layers BUILD into the implicit fluid default program (and actually
    execute); the reference only parsed them into a config proto.
  - `settings()` records the optimization config for the caller to apply
    (tests attach a fluid optimizer from it); it configures nothing
    globally.
  - `ExtraAttr(drop_rate=r)` wraps the layer output in dropout;
    error_clipping_threshold is recorded but clipping is applied at
    optimize time by fluid.clip.
  - data layer sequence-ness/int-ness comes from `declare_input_types`
    (the role the reference's DataProvider declaration played — config
    files never carried it either).
"""
from __future__ import annotations

import functools
import inspect

from ..fluid import layers as _fl
from ..fluid.initializer import (ConstantInitializer, NormalInitializer,
                                 UniformInitializer)
from ..fluid.param_attr import ParamAttr as _FluidParamAttr
from ..v2 import layer as _v2l
from ..v2 import networks as _v2n
from ..v2.layer import _Act, _MixedBuilder, _Pool, _Projection

# --- module state the harness reads back -----------------------------------

_settings: dict = {}
_outputs: list = []
_data_layers: list = []  # (name, var, kind) in declaration order
_input_types: dict = {}  # name -> 'dense'|'int'|'seq'|'int_seq'
_fixed_batch: list = []  # [N] when data layers should pin the batch dim


def reset():
    """Clear recorded state between config files (harness hook)."""
    _settings.clear()
    del _outputs[:]
    del _data_layers[:]
    _input_types.clear()
    del _fixed_batch[:]


def set_fixed_batch(n):
    """Pin the batch dimension of subsequent data layers (harness hook,
    for configs whose graphs make downstream widths batch-dependent —
    e.g. trans_layer's batch-matrix transpose feeding an fc)."""
    del _fixed_batch[:]
    if n:
        _fixed_batch.append(int(n))


def declare_input_types(types: dict):
    """Declare per-data-layer runtime types ('dense'|'int'|'seq'|
    'int_seq'), the way the reference's DataProvider declared them
    (trainer/PyDataProvider2 input_types) — configs never carried this."""
    _input_types.update(types)


def get_config():
    return {"settings": dict(_settings), "outputs": list(_outputs),
            "data_layers": list(_data_layers)}


def settings(**kwargs):
    """reference trainer_config_helpers/optimizers.py settings()."""
    _settings.update(kwargs)


def outputs(*layers):
    for group in layers:
        vs = group if isinstance(group, (list, tuple)) else [group]
        for v in vs:
            _outputs.append(v.to_variable()
                            if isinstance(v, _MixedBuilder) else v)


# --- attribute / activation / pooling classes ------------------------------


def ParamAttr(name=None, initial_max=None, initial_min=None,
              initial_mean=None, initial_std=None, learning_rate=1.0,
              l1_rate=None, l2_rate=None, is_static=False, **kwargs):
    """reference attrs.ParameterAttribute -> fluid ParamAttr. initial_max/
    min pick a uniform initializer, initial_mean/std a gaussian (the
    reference's parameter_config translation)."""
    init = None
    if initial_max is not None or initial_min is not None:
        lo = initial_min if initial_min is not None else -(initial_max or 0)
        hi = initial_max if initial_max is not None else -(initial_min or 0)
        init = UniformInitializer(low=float(lo), high=float(hi))
    elif initial_std is not None or initial_mean is not None:
        mean = float(initial_mean or 0.0)
        std = float(initial_std if initial_std is not None else 0.01)
        init = (ConstantInitializer(mean) if std == 0.0
                else NormalInitializer(loc=mean, scale=std))
    reg = None
    if l2_rate:
        from ..fluid.regularizer import L2Decay
        reg = L2Decay(float(l2_rate))
    elif l1_rate:
        from ..fluid.regularizer import L1Decay
        reg = L1Decay(float(l1_rate))
    return _FluidParamAttr(name=name, initializer=init,
                           learning_rate=float(learning_rate),
                           regularizer=reg, trainable=not is_static)


ParameterAttribute = ParamAttr


class ExtraLayerAttribute:
    """reference attrs.ExtraLayerAttribute: per-layer extras. drop_rate
    is applied (dropout on the layer output); error_clipping_threshold is
    recorded for fluid.clip at optimize time; device is meaningless here
    (placement belongs to the executor's device) and ignored."""

    def __init__(self, error_clipping_threshold=None, drop_rate=None,
                 device=None, **kwargs):
        self.error_clipping_threshold = error_clipping_threshold
        self.drop_rate = drop_rate


ExtraAttr = ExtraLayerAttribute


def _act_class(name):
    class _ActFactory:
        def __new__(cls):
            return _Act(name)

    _ActFactory.__name__ = (name or "linear").title() + "Activation"
    return _ActFactory


LinearActivation = _act_class(None)
IdentityActivation = _act_class(None)
ReluActivation = _act_class("relu")
SigmoidActivation = _act_class("sigmoid")
TanhActivation = _act_class("tanh")
SoftmaxActivation = _act_class("softmax")
ExpActivation = _act_class("exp")
SquareActivation = _act_class("square")
AbsActivation = _act_class("abs")
LogActivation = _act_class("log")
SoftReluActivation = _act_class("softplus")
BReluActivation = _act_class("brelu")
STanhActivation = _act_class("stanh")


def _pool_class(kind, name):
    class _PoolFactory:
        def __new__(cls, **kwargs):
            return _Pool(kind)

    _PoolFactory.__name__ = name
    return _PoolFactory


MaxPooling = _pool_class("max", "MaxPooling")
AvgPooling = _pool_class("average", "AvgPooling")
SumPooling = _pool_class("sum", "SumPooling")
SquareRootNPooling = _pool_class("sqrt", "SquareRootNPooling")
CudnnMaxPooling = MaxPooling
CudnnAvgPooling = AvgPooling


class AggregateLevel:
    """reference layers.AggregateLevel; the padded+lengths sequence model
    is single-level, so both levels aggregate the one time axis."""
    TO_NO_SEQUENCE = "non-seq"
    TO_SEQUENCE = "seq"
    EACH_TIMESTEP = TO_NO_SEQUENCE
    EACH_SEQUENCE = TO_SEQUENCE


class ExpandLevel:
    FROM_NO_SEQUENCE = "non-seq"
    FROM_TIMESTEP = "non-seq"
    FROM_SEQUENCE = "seq"


class layer_math:
    """reference trainer_config_helpers/math.py (paddle.v2.layer_math):
    elementwise math over layers; operator overloads live on Variable
    (fluid/layers/math_op_patch.py)."""

    @staticmethod
    def exp(x):
        return _fl.exp(_resolve(x))

    @staticmethod
    def log(x):
        return _fl.log(_resolve(x))

    @staticmethod
    def abs(x):
        return _fl.abs(_resolve(x))

    @staticmethod
    def sigmoid(x):
        return _fl.sigmoid(_resolve(x))

    @staticmethod
    def tanh(x):
        return _fl.tanh(_resolve(x))

    @staticmethod
    def square(x):
        return _fl.square(_resolve(x))

    @staticmethod
    def relu(x):
        return _fl.relu(_resolve(x))

    @staticmethod
    def sqrt(x):
        return _fl.sqrt(_resolve(x))

    @staticmethod
    def reciprocal(x):
        return _fl.reciprocal(_resolve(x))


# --- layer functions: v2.layer/networks wrapped for shim semantics ---------


def _resolve(v):
    return v.to_variable() if isinstance(v, _MixedBuilder) else v


def _resolve_tree(v):
    if isinstance(v, _MixedBuilder):
        return v.to_variable()
    if isinstance(v, (list, tuple)):
        return type(v)(_resolve_tree(x) for x in v)
    return v


def _wrap(fn):
    @functools.wraps(fn)
    def impl(*args, **kwargs):
        layer_attr = kwargs.pop("layer_attr", None)
        args = tuple(_resolve_tree(a) for a in args)
        kwargs = {k: _resolve_tree(v) for k, v in kwargs.items()}
        out = fn(*args, **kwargs)
        if isinstance(layer_attr, ExtraLayerAttribute) and \
                layer_attr.drop_rate and not isinstance(
                    out, (_Projection, _MixedBuilder, list, tuple)):
            out = _fl.dropout(out, dropout_prob=float(layer_attr.drop_rate))
        return out

    return impl


def data_layer(name, size, height=None, width=None, depth=None, **kwargs):
    """reference layers.data_layer — runtime type (sequence-ness,
    integer-ness) comes from declare_input_types, as it came from the
    DataProvider in the reference."""
    kind = _input_types.get(name, "dense")
    t = {"dense": _v2l.data_type.dense_vector(size),
         "int": _v2l.data_type.integer_value(size),
         "seq": _v2l.data_type.dense_vector_sequence(size),
         "int_seq": _v2l.data_type.integer_value_sequence(size)}[kind]
    lod = {"seq": 1, "int_seq": 1}.get(kind, 0)
    if _fixed_batch and kind == "dense":
        var = _fl.data(name=name, shape=[_fixed_batch[0], size],
                       dtype="float32", append_batch_size=False)
        var._v2_type = t
    else:
        var = _v2l.data(name, t, lod_level=lod) if lod else _v2l.data(name, t)
    if height and width:
        var._img_hw = (int(height), int(width))
        if depth:
            var._img_dhw = (int(depth), int(height), int(width))
    _data_layers.append((name, var, kind))
    return var


def dropout_layer(input, dropout_rate=0.5, **kwargs):
    return _fl.dropout(_resolve(input), dropout_prob=float(dropout_rate))


def define_py_data_sources2(*args, **kwargs):
    """reference trainer/config_parser data-source declaration: a training
    harness concern; paddle_tpu_torch feeds through reader/DataFeeder
    instead."""
    raise NotImplementedError(
        "define_py_data_sources2 configures the legacy DataProvider; "
        "paddle_tpu_torch feeds data through paddle_tpu_torch.reader / "
        "DataFeeder")


def _export_v2():
    """Every public callable from v2.layer + v2.networks, shim-wrapped."""
    g = globals()
    for mod in (_v2l, _v2n):
        for nm, obj in vars(mod).items():
            if nm.startswith("_") or nm in g:
                continue
            if inspect.isfunction(obj):
                g[nm] = _wrap(obj)
            elif inspect.isclass(obj) or isinstance(obj, type):
                g[nm] = obj
    # classes/objects the configs reference directly
    g.setdefault("StaticInput", _v2l.StaticInput)
    # nested-sequence input marker: the padded+lengths model flattens
    # 2-level LoD before the graph (SURVEY §5.7 / v2/layer.py module
    # docstring), so inside a config a SubsequenceInput behaves as the
    # flattened one-level sequence it arrives as
    g.setdefault("SubsequenceInput", lambda input, **kw: input)


_export_v2()

# shim-local definitions shadow the generic export where semantics differ
mixed_layer = _wrap(_v2l.mixed_layer)
memory = _v2l.memory  # must run inside the step fn, unwrapped
