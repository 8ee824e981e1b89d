"""v2 layer DSL mapped onto fluid layers (reference python/paddle/v2/layer.py
+ trainer_config_helpers/layers.py — declarative layers composed by passing
outputs as inputs). Each function appends ops to the implicit default
program, exactly like fluid layers; the v2-specific `data_type` objects
translate to fluid data vars.

Coverage: 114 layer functions vs the reference's 109 names. Intentionally
absent (each a nested-raggedness construct the padded+lengths sequence
model deliberately flattens — SURVEY §5.7):
  - sub_nested_seq_layer: selects inner sequences of a 2-level LoD;
    lod_level-2 data arrives here already flattened to one level.
  - cross_entropy_over_beam: cost over the beam-structured LoD the legacy
    generator emitted; generation here keeps fixed [batch, beam] lanes
    (see beam_search below) where plain cross_entropy applies per lane.
  - layer_support/__cost_input__/__img_norm_layer__: config-parser
    internals, not user layers."""
from __future__ import annotations

from ..fluid import layers as _fl
from ..fluid.param_attr import ParamAttr as _ParamAttr


class _DataType:
    def __init__(self, kind: str, dim: int, seq: bool = False):
        self.kind = kind
        self.dim = dim
        self.seq = seq


class data_type:
    """reference paddle.v2.data_type."""

    @staticmethod
    def dense_vector(dim):
        return _DataType("dense", dim)

    @staticmethod
    def integer_value(dim):
        return _DataType("int", dim)

    @staticmethod
    def integer_value_sequence(dim):
        return _DataType("int", dim, seq=True)

    @staticmethod
    def dense_vector_sequence(dim):
        return _DataType("dense", dim, seq=True)


def data(name, type: _DataType, **kwargs):
    if type.kind == "int":
        shape = [1]
        dtype = "int64"
    else:
        shape = [type.dim]
        dtype = "float32"
    var = _fl.data(name=name, shape=shape, dtype=dtype, **kwargs)
    var._v2_type = type  # embedding_layer sizes its table from this
    return var


def fc_layer(input, size, act=None, **kwargs):
    # sequence inputs ([N, T, D]) project per-timestep, as the legacy
    # config parser did for fc over a sequence layer
    ref = input[0] if isinstance(input, (list, tuple)) else input
    if "num_flatten_dims" not in kwargs and getattr(ref, "shape", None) \
            is not None and len(ref.shape) == 3:
        kwargs["num_flatten_dims"] = 2
    return _fl.fc(input=input, size=size, act=_act_name(act), **kwargs)


def embedding_layer(input, size, vocab_size=None, **kwargs):
    """Table rows come from the input data layer's declared integer dim
    (reference: the v2 config carries the vocab through the data type)."""
    if vocab_size is None:
        t = getattr(input, "_v2_type", None)
        if t is None or t.kind != "int":
            raise ValueError(
                "embedding_layer needs vocab_size= or an input created by "
                "v2.layer.data with integer_value(_sequence)(dim)"
            )
        vocab_size = t.dim
    return _fl.embedding(input, size=[vocab_size, size], **kwargs)


def classification_cost(input, label, weight=None, **kwargs):
    """reference classification_cost; weight is the per-sample cost
    weight the legacy layer took (layers.py classification_cost's
    weight input)."""
    ce = _fl.cross_entropy(input=input, label=label)
    if weight is not None:
        ce = _fl.elementwise_mul(ce, weight)
    return _fl.mean(ce)


def square_error_cost(input, label, weight=None, **kwargs):
    se = _fl.square_error_cost(input=input, label=label)
    if weight is not None:
        se = _fl.elementwise_mul(se, weight)
    return _fl.mean(se)


def cross_entropy_cost(input, label):
    return classification_cost(input, label)


def _concat(input, **kwargs):
    from ..fluid.layers import tensor as _t

    # reference concat_layer accepts projections alongside layers
    ins = [p.realize(p.width) if isinstance(p, _Projection) else p
           for p in input]
    return _t.concat(ins, **kwargs)


concat_layer = _concat


# --- activation / pooling namespaces (reference trainer_config_helpers
# activations.py / poolings.py: layer args take ReluActivation() /
# MaxPooling() instances) ---------------------------------------------------


class _Act:
    def __init__(self, name):
        self.name = name


class activation:
    """reference paddle.v2.activation.*"""

    Relu = staticmethod(lambda: _Act("relu"))
    Sigmoid = staticmethod(lambda: _Act("sigmoid"))
    Tanh = staticmethod(lambda: _Act("tanh"))
    Softmax = staticmethod(lambda: _Act("softmax"))
    Linear = staticmethod(lambda: _Act(None))
    Identity = staticmethod(lambda: _Act(None))


class _Pool:
    def __init__(self, kind):
        self.kind = kind


class pooling:
    """reference paddle.v2.pooling.* (sequence poolings)."""

    Max = staticmethod(lambda: _Pool("max"))
    Avg = staticmethod(lambda: _Pool("average"))
    Sum = staticmethod(lambda: _Pool("sum"))
    SquareRootN = staticmethod(lambda: _Pool("sqrt"))


def _act_name(act):
    return act.name if isinstance(act, _Act) else act


# --- sequence layers (reference trainer_config_helpers/layers.py:
# last_seq, first_seq, pooling_layer, lstmemory, grumemory, simple_lstm,
# simple_gru, expand_layer) -------------------------------------------------


def last_seq(input, **kwargs):
    return _fl.sequence_last_step(input)


def first_seq(input, **kwargs):
    return _fl.sequence_first_step(input)


def pooling_layer(input, pooling_type=None, **kwargs):
    """Sequence pooling (reference pooling_layer) — NOT image pooling
    (that's img_pool_layer)."""
    kind = pooling_type.kind if isinstance(pooling_type, _Pool) else (
        pooling_type or "max")
    return _fl.sequence_pool(input=input, pool_type=kind)


def lstmemory(input, size=None, reverse=False, act=None, **kwargs):
    """reference lstmemory: `size` is the HIDDEN width; the input must
    carry 4*size projected features (pair with fc_layer, as
    trainer_config_helpers documents). Default size = input_width // 4."""
    width = int(input.shape[-1])
    if size is None:
        size = width // 4
    if width != size * 4:
        raise ValueError(
            f"lstmemory(size={size}) needs an input of width {size * 4} "
            f"(4*size projected features), got {width}")
    h, _ = _fl.dynamic_lstm(input=input, size=size * 4, is_reverse=reverse)
    return h


def simple_lstm(input, size, reverse=False, **kwargs):
    """reference networks.simple_lstm: fc projection + lstmemory."""
    proj = _fl.fc(input=input, size=size * 4, num_flatten_dims=2)
    h, _ = _fl.dynamic_lstm(input=proj, size=size * 4, is_reverse=reverse)
    return h


def grumemory(input, size=None, reverse=False, **kwargs):
    """`size` is the hidden width; input carries 3*size projected gates."""
    width = int(input.shape[-1])
    if size is None:
        size = width // 3
    if width != size * 3:
        raise ValueError(
            f"grumemory(size={size}) needs an input of width {size * 3} "
            f"(3*size projected gates), got {width}")
    return _fl.dynamic_gru(input=input, size=size, is_reverse=reverse)


def simple_gru(input, size, reverse=False, **kwargs):
    proj = _fl.fc(input=input, size=size * 3, num_flatten_dims=2)
    return _fl.dynamic_gru(input=proj, size=size, is_reverse=reverse)


def expand_layer(input, expand_as, **kwargs):
    return _fl.sequence_expand(input, expand_as)


# --- image layers (reference img_conv_layer / img_pool_layer /
# simple_img_conv_pool) -----------------------------------------------------


def _as_nchw(input, num_channels=None, height=None, width=None):
    """Flat image data ([N, C*H*W] data layers) to NCHW. The reference
    config parser (trainer/config_parser.py parse_image) infers square
    H = W = sqrt(size / channels) when the data layer carries no
    height/width — the legacy configs rely on that."""
    if input.shape is not None and len(input.shape) >= 4:
        return input
    flat = int(input.shape[-1])
    if not (height and width):
        # data layers carry declared height/width (data_layer(height=,
        # width=)) through _img_hw
        hw = getattr(input, "_img_hw", None)
        if hw:
            height, width = hw
    if height and width:
        h, w = int(height), int(width)
        # reference parse_image: channels = size / (h*w) when undeclared
        c = int(num_channels) if num_channels else max(1, flat // (h * w))
    else:
        c = int(num_channels or 1)
        h = w = int(round((flat // c) ** 0.5))
    if c * h * w != flat:
        raise ValueError(
            f"cannot fold flat image of {flat} features into "
            f"[{c}, {h}, {w}] — pass num_channels/height/width")
    return _fl.reshape(input, shape=[-1, c, h, w])


def img_conv_layer(input, filter_size, num_filters, stride=1, padding=0,
                   act=None, num_channels=None, dilation=1, trans=False,
                   **kwargs):
    input = _as_nchw(input, num_channels)
    conv = _fl.conv2d_transpose if trans else _fl.conv2d
    return conv(input=input, num_filters=num_filters,
                filter_size=filter_size, stride=stride,
                padding=padding, dilation=dilation, act=_act_name(act))


def img_pool_layer(input, pool_size, stride=1, padding=0, pool_type=None,
                   num_channels=None, **kwargs):
    kind = pool_type.kind if isinstance(pool_type, _Pool) else (
        pool_type or "max")
    if kind not in ("max", "avg", "average"):
        kind = "max"
    input = _as_nchw(input, num_channels)
    return _fl.pool2d(input=input, pool_size=pool_size, pool_stride=stride,
                      pool_padding=padding,
                      pool_type="avg" if kind != "max" else "max")


def simple_img_conv_pool(input, filter_size, num_filters, pool_size,
                         pool_stride, act=None, **kwargs):
    from ..fluid import nets as _nets

    return _nets.simple_img_conv_pool(
        input=input, num_filters=num_filters, filter_size=filter_size,
        pool_size=pool_size, pool_stride=pool_stride, act=_act_name(act))


# --- elementwise / misc layers --------------------------------------------


def addto_layer(input, act=None, **kwargs):
    from ..fluid.layers import tensor as _t

    out = _t.sums(list(input))
    name = _act_name(act)
    if name:
        out = getattr(_fl, name)(out)
    return out


def cos_sim(a, b, size=1, **kwargs):
    """reference cos_sim: size>1 treats b as `size` groups of a-width
    vectors and emits one similarity per group ([N, size])."""
    if size and int(size) > 1:
        da = int(a.shape[-1])
        bg = _fl.reshape(b, shape=[-1, int(size), da])
        ag = _fl.reshape(a, shape=[-1, 1, da])
        num = _fl.reduce_sum(_fl.elementwise_mul(bg, ag), dim=-1)
        na = _fl.sqrt(_fl.reduce_sum(_fl.square(ag), dim=-1))
        nb = _fl.sqrt(_fl.reduce_sum(_fl.square(bg), dim=-1))
        return _raw_op("elementwise_div", {"X": [num],
                                           "Y": [_fl.elementwise_mul(na, nb)]})
    return _fl.cos_sim(X=a, Y=b)


def scaling_layer(input, weight, **kwargs):
    return _fl.elementwise_mul(input, weight)


def slope_intercept_layer(input, slope=1.0, intercept=0.0, **kwargs):
    return _fl.scale(input, scale=float(slope), bias=float(intercept))


def trans_layer(input, **kwargs):
    return _fl.transpose(input, perm=[1, 0])


def maxid_layer(input, **kwargs):
    from ..fluid.layers import tensor as _t

    return _t.argmax(input, axis=-1)


def dropout_layer(input, dropout_rate, **kwargs):
    return _fl.dropout(input, dropout_prob=dropout_rate)


batch_norm_layer = _fl.batch_norm
conv_layer = img_conv_layer


# --- cost layers (reference classification_cost / regression_cost /
# crf_layer / ctc_layer / rank_cost) ---------------------------------------


def regression_cost(input, label, **kwargs):
    return square_error_cost(input, label)


def mse_cost(input, label, **kwargs):
    return square_error_cost(input, label)


def crf_layer(input, label, param_attr=None, **kwargs):
    return _fl.linear_chain_crf(input=input, label=label,
                                param_attr=param_attr)


def crf_decoding_layer(input, param_attr, label=None, **kwargs):
    return _fl.crf_decoding(input=input, param_attr=param_attr, label=label)


def softmax_layer(input, **kwargs):
    return _fl.softmax(input)


# --- helper: append a raw op through the fluid LayerHelper ----------------


def _raw_op(op_type, inputs, attrs=None, n_outs=1, dtype=None,
            out_slots=("Out",)):
    from ..fluid.layer_helper import LayerHelper

    helper = LayerHelper(op_type)
    first = next(iter(inputs.values()))
    ref = first[0] if isinstance(first, (list, tuple)) else first
    dtype = dtype or ref.dtype
    outs = [helper.create_variable_for_type_inference(dtype)
            for _ in range(n_outs)]
    helper.append_op(
        type=op_type, inputs=inputs,
        outputs={slot: [o] for slot, o in zip(out_slots, outs)},
        attrs=attrs or {},
    )
    return outs[0] if n_outs == 1 else tuple(outs)


# --- mixed_layer projections / operators (reference
# trainer_config_helpers/layers.py: full_matrix_projection:...,
# identity_projection, table_projection, dotmul_projection,
# context_projection, dotmul_operator). A projection is a deferred spec;
# mixed_layer realizes each against its own `size` and sums them. --------


class _Projection:
    def __init__(self, realize, width=None):
        self.realize = realize  # size -> Variable
        self.width = width  # intrinsic output width, when the projection
        # knows it (lets mixed_layer() omit size, as the reference does)


def full_matrix_projection(input, size=None, param_attr=None, **kwargs):
    def realize(sz):
        sz = sz or size
        if sz is None:
            raise ValueError("full_matrix_projection needs a size (its own "
                             "size= or the enclosing mixed_layer's)")
        # sequence inputs ([N, T, D]) project per-timestep
        flat = 2 if input.shape is not None and len(input.shape) == 3 else 1
        return _fl.fc(input=input, size=sz, act=None, num_flatten_dims=flat,
                      param_attr=param_attr)

    return _Projection(realize, width=size)


def identity_projection(input, offset=None, size=None, **kwargs):
    def realize(sz):
        sz = sz or size
        if offset is not None:
            if sz is None:
                raise ValueError("identity_projection(offset=...) needs a "
                                 "size to know the slice width")
            return _raw_op("slice", {"Input": [input]},
                           {"axes": [input.ndim - 1 if hasattr(input, "ndim")
                                     else len(input.shape) - 1],
                            "starts": [offset], "ends": [offset + sz]})
        return input

    width = size if offset is not None else int(input.shape[-1])
    return _Projection(realize, width=width)


def table_projection(input, size=None, **kwargs):
    t = getattr(input, "_v2_type", None)
    vocab = t.dim if t is not None else None

    def realize(sz):
        sz = sz or size
        if vocab is None:
            # the reference parses (never executes) table projections over
            # non-id layers (tests/configs/projections.py feeds a mixed
            # output); the executable analogue of "the id this activation
            # denotes" is its argmax over the feature width
            ids = _fl.reshape(_fl.argmax(input, axis=-1), shape=[-1, 1])
            return _fl.embedding(ids, size=[int(input.shape[-1]), sz])
        return _fl.embedding(input, size=[vocab, sz])

    return _Projection(realize, width=size)


def dotmul_projection(input, **kwargs):
    def realize(sz):
        from ..fluid.layer_helper import LayerHelper

        helper = LayerHelper("dotmul_projection")
        w = helper.create_parameter(
            helper.param_attr, shape=[int(input.shape[-1])],
            dtype=input.dtype)
        return _fl.elementwise_mul(input, w)

    return _Projection(realize, width=int(input.shape[-1]))


def context_projection(input, context_len=3, context_start=None, **kwargs):
    """Concat each timestep with its neighbours (reference
    context_projection -> math/context_project)."""
    def realize(sz):
        from ..fluid.layers.sequence import seq_lengths_of

        x = input
        flat = x.shape is not None and len(x.shape) == 2
        if flat:
            # non-sequence input (parse-only in the reference): a context
            # window over a length-1 sequence — neighbours are padding
            x = _fl.reshape(x, shape=[-1, 1, int(x.shape[-1])])
        inputs = {"X": [x]}
        lens = seq_lengths_of(input)
        if lens is not None:
            inputs["Lengths"] = [lens]
        attrs = {"context_length": context_len}
        if context_start is not None:
            attrs["context_start"] = context_start
        out = _raw_op("context_project", inputs, attrs)
        if flat:
            out = _fl.reshape(
                out, shape=[-1, int(input.shape[-1]) * context_len])
        return out

    return _Projection(realize, width=int(input.shape[-1]) * context_len)


def dotmul_operator(a, b, scale=1.0, **kwargs):
    return _Projection(lambda sz: _fl.scale(_fl.elementwise_mul(a, b),
                                            scale=float(scale)),
                       width=int(a.shape[-1]))


class _MixedBuilder:
    """Deferred mixed_layer (reference `with mixed_layer(size=N) as m:
    m += projection` — trainer_config_helpers/layers.py mixed_layer's
    context-manager form). Projections accumulate via `+=`; the summed
    layer realizes when the `with` block exits. Afterwards the builder
    proxies the realized Variable (shape/dtype/name), so it can feed
    later layers."""

    def __init__(self, size, act, bias_attr, kwargs):
        self._spec = (size, act, bias_attr, kwargs)
        self._projs = []
        self._var = None

    def __iadd__(self, proj):
        if self._var is not None:
            raise RuntimeError("mixed_layer already realized; += is only "
                               "valid inside the `with` block")
        self._projs.append(proj)
        return self

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        if et is None:
            self.to_variable()
        return False

    def to_variable(self):
        if self._var is None:
            size, act, bias_attr, kw = self._spec
            if not self._projs:
                raise ValueError("mixed_layer realized with no projections")
            self._var = mixed_layer(size=size, input=self._projs, act=act,
                                    bias_attr=bias_attr, **kw)
        return self._var

    def __getattr__(self, item):
        return getattr(self.to_variable(), item)


def mixed_layer(*args, size=None, input=None, act=None, bias_attr=None,
                **kwargs):
    """reference mixed_layer: sum of realized projections/operators, then
    activation. Plain Variables act as full-matrix projections. Accepted
    call forms: mixed_layer(size=N, input=[...]) (reference kwargs),
    mixed_layer(inputs, N), mixed_layer(inputs, size=N) (legacy positional
    input), and the no-input context-manager form (`with mixed_layer(...)
    as m: m += proj`), where size may be omitted if every projection
    declares its own width."""
    for a in args:  # positional args: ints are size, everything else input
        if isinstance(a, int):
            size = a
        else:
            input = a
    if input is None:
        return _MixedBuilder(size, act, bias_attr, kwargs)
    ins = input if isinstance(input, (list, tuple)) else [input]
    widths = [p.width for p in ins
              if isinstance(p, _Projection) and p.width is not None]
    if size is None:
        if not widths:
            raise TypeError("mixed_layer needs an integer size (none of "
                            "its projections declares an output width)")
        size = widths[0]
    bad = [w for w in widths if w != size]
    if bad:
        # the reference config parser rejects mismatched projection sizes;
        # silently overriding would build a different architecture
        raise ValueError(
            f"mixed_layer(size={size}) has projections declaring widths "
            f"{sorted(set(widths))} — every projection must produce the "
            "layer's width")
    realized = []
    for p in ins:
        if isinstance(p, _MixedBuilder):
            p = p.to_variable()
        if isinstance(p, _Projection):
            realized.append(p.realize(size))
        else:
            realized.append(_fl.fc(input=p, size=size, act=None)
                            if size else p)
    out = realized[0]
    for r in realized[1:]:
        out = _fl.elementwise_add(out, r)
    name = _act_name(act)
    if name:
        out = getattr(_fl, name)(out)
    return out


# --- elementwise / arithmetic layers (reference layers.py interpolation,
# power, sum_to_one_norm, row_l2_norm, dot_prod, out_prod, linear_comb,
# l2_distance, clip, scale_shift, slope_intercept) ------------------------


def interpolation_layer(input, weight, **kwargs):
    """out = w*x + (1-w)*y with input=[x, y], per-row weight in [0,1]."""
    x, y = input
    wx = _fl.elementwise_mul(x, weight)
    one_minus = _fl.scale(weight, scale=-1.0, bias=1.0)
    wy = _fl.elementwise_mul(y, one_minus)
    return _fl.elementwise_add(wx, wy)


def power_layer(input, weight, **kwargs):
    return _raw_op("elementwise_pow", {"X": [input], "Y": [weight]})


def sum_to_one_norm_layer(input, **kwargs):
    s = _fl.reduce_sum(input, dim=-1, keep_dim=True)
    return _raw_op("elementwise_div", {"X": [input], "Y": [s]})


def row_l2_norm_layer(input, **kwargs):
    return _fl.l2_normalize(input, axis=-1)


def dot_prod_layer(a=None, b=None, input1=None, input2=None, **kwargs):
    a = a if a is not None else input1  # reference spells them input1/2
    b = b if b is not None else input2
    return _fl.reduce_sum(_fl.elementwise_mul(a, b), dim=-1, keep_dim=True)


def out_prod_layer(a, b, **kwargs):
    """Per-row outer product flattened to [N, da*db] (reference
    out_prod_layer)."""
    da, db = int(a.shape[-1]), int(b.shape[-1])
    am = _fl.reshape(a, shape=[-1, da, 1])
    bm = _fl.reshape(b, shape=[-1, 1, db])
    return _fl.reshape(_fl.matmul(am, bm), shape=[-1, da * db])


def linear_comb_layer(weights, vectors, size=None, **kwargs):
    """Rowwise weighted sum of `size`-dim sub-vectors (reference
    linear_comb_layer): vectors [N, m*size] grouped by weights [N, m];
    size defaults to vectors_width / weights_width (the reference's
    inferred form)."""
    m = int(weights.shape[-1])
    if size is None:
        size = int(vectors.shape[-1]) // m
    v = _fl.reshape(vectors, shape=[-1, m, size])
    w = _fl.reshape(weights, shape=[-1, m, 1])
    return _fl.reshape(_fl.reduce_sum(_fl.elementwise_mul(v, w), dim=1),
                       shape=[-1, size])


def l2_distance_layer(x, y, **kwargs):
    return _raw_op("squared_l2_distance", {"X": [x], "Y": [y]},
                   n_outs=2, out_slots=("Out", "sub_result"))[0]


def clip_layer(input, min, max, **kwargs):
    return _fl.clip(input, min=float(min), max=float(max))


def scale_shift_layer(input, **kwargs):
    """y = w*x + b with SCALAR learnable w, b (reference
    scale_shift_layer)."""
    from ..fluid.layer_helper import LayerHelper

    helper = LayerHelper("scale_shift")
    w = helper.create_parameter(helper.param_attr, shape=[1],
                                dtype=input.dtype)
    b = helper.create_parameter(helper.param_attr, shape=[1],
                                dtype=input.dtype, is_bias=True)
    return _fl.elementwise_add(_fl.elementwise_mul(input, w), b)


def sum_cost(input, **kwargs):
    return _fl.reduce_sum(input)


# --- shape / image manipulation layers (reference repeat_layer, pad,
# crop, rotate, resize, maxout, spp, img_cmrnorm, roi_pool, bilinear) ------


def repeat_layer(input, num_repeats, act=None, **kwargs):
    times = [1] * (len(input.shape) - 1) + [int(num_repeats)]
    out = _raw_op("expand", {"X": [input]}, {"expand_times": times})
    name = _act_name(act)
    return getattr(_fl, name)(out) if name else out


def pad_layer(input, pad_c=None, pad_h=None, pad_w=None, **kwargs):
    """NCHW padding (reference pad_layer pads channel/height/width)."""
    paddings = [0, 0]
    for p in (pad_c, pad_h, pad_w):
        p = p or [0, 0]
        paddings += list(p)
    return _fl.pad(input, paddings=paddings)


def crop_layer(input, shape=None, offsets=None, **kwargs):
    attrs = {}
    if shape is not None:
        attrs["shape"] = list(shape)
    if offsets is not None:
        attrs["offsets"] = list(offsets)
    return _raw_op("crop", {"X": [input]}, attrs)


def rotate_layer(input, height, width, **kwargs):
    """90-degree CCW rotation of each feature map (reference rotate_layer:
    transpose H/W then reverse the new height axis)."""
    c = int(input.shape[1]) if len(input.shape) > 3 else 1
    x = _fl.reshape(input, shape=[-1, c, height, width])
    t = _fl.transpose(x, perm=[0, 1, 3, 2])
    return _raw_op("reverse", {"X": [t]}, {"axis": [2]})


def resize_layer(input, size, **kwargs):
    return _fl.reshape(input, shape=[-1, int(size)])


def maxout_layer(input, groups, **kwargs):
    return _raw_op("maxout", {"X": [input]}, {"groups": int(groups)})


def spp_layer(input, pyramid_height, pool_type=None, num_channels=None,
              **kwargs):
    kind = pool_type.kind if isinstance(pool_type, _Pool) else (
        pool_type or "max")
    return _raw_op("spp", {"X": [_as_nchw(input, num_channels)]},
                   {"pyramid_height": int(pyramid_height),
                    "pooling_type": "avg" if kind != "max" else "max"})


def img_cmrnorm_layer(input, size=5, scale=0.0128, power=0.75,
                      num_channels=None, **kwargs):
    """Local response norm across channels (reference img_cmrnorm_layer ->
    lrn op; alpha = scale/size per the config_parser translation)."""
    return _fl.lrn(_as_nchw(input, num_channels), n=int(size),
                   alpha=float(scale) / int(size), beta=float(power))


def roi_pool_layer(input, rois, pooled_width, pooled_height,
                   spatial_scale=1.0, **kwargs):
    return _raw_op("roi_pool", {"X": [input], "ROIs": [rois]},
                   {"pooled_height": int(pooled_height),
                    "pooled_width": int(pooled_width),
                    "spatial_scale": float(spatial_scale)})


def print_layer(input, **kwargs):
    from ..fluid.layers import tensor as _t

    return _t.Print(input) if hasattr(_t, "Print") else input


# --- sequence layers (reference seq_concat, seq_reshape, seq_slice,
# sub_seq via slice, context window via row_conv) --------------------------


def seq_concat_layer(a, b, **kwargs):
    return _fl.sequence_concat([a, b])


def seq_reshape_layer(input, reshape_size, **kwargs):
    return _fl.sequence_reshape(input, new_dim=int(reshape_size))


def seq_slice_layer(input, starts, ends, **kwargs):
    """reference seq_slice_layer: keep [start_i, end_i) windows. starts /
    ends may carry SEVERAL columns (k windows per sequence — the
    reference emitted a nested sequence); the masked-sequence model keeps
    [N, T, D] with the union of the windows valid. None starts = from 0,
    None ends = to each sequence's length."""
    from ..fluid.layers.sequence import seq_lengths_of

    if starts is None and ends is None:
        return input
    if starts is None:
        starts = _fl.scale(ends, scale=0.0)
    if ends is None:
        lens = seq_lengths_of(input)
        big = _fl.fill_constant(shape=[1], dtype=starts.dtype,
                                value=float(input.shape[1] or 10 ** 6)) \
            if lens is None else _fl.reshape(_fl.cast(lens, starts.dtype),
                                             shape=[-1, 1])
        ends = _fl.elementwise_add(_fl.scale(starts, scale=0.0), big)
    length = _fl.elementwise_sub(ends, starts)
    return _raw_op("sequence_slice",
                   {"X": [input], "Offset": [starts], "Length": [length]})


def row_conv_layer(input, context_len, **kwargs):
    from ..fluid.layer_helper import LayerHelper

    helper = LayerHelper("row_conv")
    w = helper.create_parameter(
        helper.param_attr, shape=[int(context_len), int(input.shape[-1])],
        dtype=input.dtype)
    return _raw_op("row_conv", {"X": [input], "Filter": [w]})


# --- recurrent step layers (reference gru_step_layer, lstm_step_layer) ----


def gru_step_layer(input, output_mem, size=None, **kwargs):
    size = size or int(output_mem.shape[-1])
    from ..fluid.layers import sequence as _seq

    h, _, _ = _seq.gru_unit(input=input, hidden=output_mem, size=size * 3)
    return h


def lstm_step_layer(input, state, size=None, **kwargs):
    """One LSTM step (reference lstm_step_layer): input carries 4*size
    gates; state is the previous cell. Returns (hidden, new_cell)."""
    size = size or int(state.shape[-1])
    c, h = _raw_op("lstm_unit", {"X": [input], "C_prev": [state]},
                   n_outs=2, out_slots=("C", "H"))
    return h, c


# --- cost layers ----------------------------------------------------------


def rank_cost(left, right, label, **kwargs):
    return _fl.mean(_raw_op("rank_loss",
                            {"Left": [left], "Right": [right],
                             "Label": [label]}))


def huber_regression_cost(input, label, delta=1.0, **kwargs):
    return _fl.mean(_raw_op("huber_loss", {"X": [input], "Y": [label]},
                            {"delta": float(delta)}, n_outs=2,
                            out_slots=("Out", "Residual"))[0])


def huber_classification_cost(input, label, **kwargs):
    """reference huber_classification_cost (modified huber on +-1
    labels)."""
    return _fl.mean(_raw_op("modified_huber_loss",
                            {"X": [input], "Y": [label]}, n_outs=2,
                            out_slots=("Out", "IntermediateVal"))[0])


def multi_binary_label_cross_entropy(input, label, **kwargs):
    return _fl.mean(_fl.sigmoid_cross_entropy_with_logits(x=input,
                                                          label=label))


def smooth_l1_cost(input, label, **kwargs):
    return _fl.mean(_fl.smooth_l1(x=input, y=label))


def nce_layer(input, label, num_classes=None, num_neg_samples=10, **kwargs):
    from ..fluid.layer_helper import LayerHelper

    if num_classes is None:
        # the reference derived it from the label data layer's size
        t = getattr(label, "_v2_type", None)
        if t is None:
            raise ValueError("nce_layer needs num_classes= or a label "
                             "created by v2.layer.data")
        num_classes = t.dim
    helper = LayerHelper("nce_layer")
    dim = int(input.shape[-1])
    w = helper.create_parameter(helper.param_attr,
                                shape=[int(num_classes), dim],
                                dtype=input.dtype)
    b = helper.create_parameter(helper.param_attr,
                                shape=[int(num_classes)],
                                dtype=input.dtype, is_bias=True)
    return _fl.mean(_raw_op(
        "nce", {"Input": [input], "Label": [label], "Weight": [w],
                "Bias": [b]},
        {"num_total_classes": int(num_classes),
         "num_neg_samples": int(num_neg_samples)},
        n_outs=3, out_slots=("Cost", "SampleLogits", "SampleLabels"))[0])


def ctc_layer(input, label, blank=0, **kwargs):
    return _fl.mean(_raw_op("warpctc", {"Logits": [input],
                                        "Label": [label]},
                            {"blank": int(blank)},
                            out_slots=("Loss",)))


warp_ctc_layer = ctc_layer


# --- recurrent_group (reference trainer_config_helpers recurrent_group +
# memory + StaticInput — the legacy DSL's custom-RNN API, backed here by
# fluid's DynamicRNN masked-scan lowering) ---------------------------------


class StaticInput:
    """Non-sequence input visible at every step (reference
    paddle.layer.StaticInput)."""

    def __init__(self, input, **kwargs):
        self.input = input


_current_group = None


def memory(name=None, size=None, boot_layer=None, **kwargs):
    """Declare a recurrent state inside a recurrent_group step (reference
    paddle.layer.memory): returns the PREVIOUS step's value. The state the
    step returns (single-memory form) or the returned output whose
    position matches the memory's declaration order feeds the next step."""
    if _current_group is None:
        raise RuntimeError("memory() is only valid inside a "
                           "recurrent_group step function")
    return _current_group._declare_memory(name, size, boot_layer)


class _GroupCtx:
    def __init__(self, drnn):
        self.drnn = drnn
        self.declared = []  # pre-mem vars, in declaration order
        self.explicit = {}  # id(pre) -> update var, via memory.set_input

    def _declare_memory(self, name, size, boot_layer):
        if boot_layer is not None:
            pre = self.drnn.memory(init=boot_layer)
        elif size is not None:
            pre = self.drnn.memory(shape=[int(size)], value=0.0)
        else:
            raise ValueError(
                "memory() requires size= or boot_layer= (the reference's "
                "link-by-name form resolves sizes from the parsed config; "
                "here the state width must be explicit)")
        self.declared.append(pre)
        # reference memory.set_input (trainer_config_helpers/layers.py
        # MemoryV2.set_input): explicitly name the layer that feeds the
        # next step, overriding positional output matching
        pre.set_input = lambda v: self.explicit.__setitem__(id(pre), v)
        return pre


def recurrent_group(step, input, reverse=False, **kwargs):
    """reference recurrent_group: run `step` once per timestep over the
    sequence input(s); memories declared via layer.memory carry state.
    The step's outputs update the memories in declaration order (the
    single-memory/single-output form is the reference's dominant usage);
    extra outputs beyond the declared memories are emitted only; a
    memory.set_input(layer) overrides the positional match.
    reverse=True runs the steps last-to-first: each sequence input's valid
    prefix is flipped before the scan and the emitted sequence flipped
    back, so output[t] is the state after consuming t..end — the
    reference's reversed-group semantics without a backward scan."""
    global _current_group

    from ..fluid.layers.control_flow import DynamicRNN
    from ..fluid.layers.sequence import sequence_reverse

    ins = input if isinstance(input, (list, tuple)) else [input]
    if reverse:
        ins = [x if isinstance(x, StaticInput) else sequence_reverse(x)
               for x in ins]
    drnn = DynamicRNN()
    prev = _current_group
    mismatch = None
    with drnn.block():
        step_args = []
        for x in ins:
            if isinstance(x, StaticInput):
                step_args.append(drnn.static_input(x.input))
            else:
                step_args.append(drnn.step_input(x))
        _current_group = _GroupCtx(drnn)
        step_exc = None
        try:
            outs = step(*step_args)
        except Exception as e:
            # a raw raise here would be shadowed by DynamicRNN._complete()
            # (block()'s finally asserts every memory updated) — self-link
            # the declared state so the USER's error survives the exit
            step_exc = e
            outs = []
        finally:
            ctx, _current_group = _current_group, prev
        if step_exc is not None:
            for mem in ctx.declared:
                drnn.update_memory(mem, mem)
            drnn.output(*(ctx.declared or step_args[:1]))
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        positional = [m for m in ctx.declared if id(m) not in ctx.explicit]
        if positional and len(outs) < len(positional):
            # raising here would be shadowed by DynamicRNN._complete()'s
            # own invariant (block()'s finally) — still update what we can
            # so the clearer error below is the one the user sees
            mismatch = (len(outs), len(positional))
        if step_exc is None:
            for mem in ctx.declared:
                if id(mem) in ctx.explicit:
                    drnn.update_memory(mem, ctx.explicit[id(mem)])
            for mem, out in zip(positional, outs):
                drnn.update_memory(mem, out)
            for mem in positional[len(outs):]:
                drnn.update_memory(mem, mem)  # satisfy the block invariant;
                # the ValueError below is the error the user actually sees
            drnn.output(*outs)
    if step_exc is not None:
        raise step_exc
    if mismatch is not None:
        raise ValueError(
            f"step returned {mismatch[0]} outputs but declared "
            f"{mismatch[1]} memories — each memory updates from the "
            "same-position output")
    result = drnn()  # DynamicRNN() unwraps a single output itself
    if reverse:
        result = ([sequence_reverse(r) for r in result]
                  if isinstance(result, (list, tuple))
                  else sequence_reverse(result))
    return result


def recurrent_layer(input, act=None, reverse=False, **kwargs):
    """Simple Elman recurrence (reference recurrent_layer):
    h_t = act(x_t + W h_{t-1}) — the input carries the ALREADY-projected
    x, so only the recurrent weight W is learned here (pair with fc_layer
    for the input projection, as the legacy configs do)."""
    size = int(input.shape[-1])
    # default act is tanh (reference recurrent_layer); an EXPLICIT
    # Linear()/Identity() activation means no nonlinearity, not tanh
    act_name = "tanh" if act is None else _act_name(act)

    def step(x_t):
        h_prev = memory(size=size)
        rec = _fl.fc(input=h_prev, size=size, act=None)
        h = _fl.elementwise_add(x_t, rec)
        if act_name:
            h = getattr(_fl, act_name)(h)
        return h

    return recurrent_group(step=step, input=input, reverse=reverse)


# --- round-4 DSL breadth: the long tail of trainer_config_helpers/layers.py
# mapped onto fluid ops (reference layers.py — 109 layer types; each function
# below names its reference counterpart) ------------------------------------


def data_layer(name, size, **kwargs):
    """reference data_layer(name, size): raw config-helper spelling —
    v2's data(name, type) wraps it; size is the flat feature dim."""
    return data(name, data_type.dense_vector(size), **kwargs)


def cross_entropy(input, label, **kwargs):
    """reference cross_entropy (config-helper spelling of the cost)."""
    return classification_cost(input, label)


def batch_norm_layer(input, act=None, bias_attr=None, param_attr=None,
                     use_global_stats=None, moving_average_fraction=0.9,
                     num_channels=None, img3D=False, **kwargs):
    """reference batch_norm_layer -> fluid batch_norm (img3D folds flat
    volumetric data to NCDHW first; channel axis is 1 either way)."""
    if img3D:
        input = _as_ncdhw(input, num_channels)
    return _fl.batch_norm(
        input, act=_act_name(act),
        is_test=bool(use_global_stats) if use_global_stats is not None
        else False,
        momentum=moving_average_fraction,
        param_attr=param_attr, bias_attr=bias_attr)


def tensor_layer(a, b, size, act=None, **kwargs):
    """reference tensor_layer: out_k = a^T W_k b (a bilinear form per
    output) -> fluid bilinear_tensor_product op."""
    from ..fluid.layer_helper import LayerHelper

    helper = LayerHelper("tensor_layer")
    w = helper.create_parameter(
        helper.param_attr,
        shape=[size, int(a.shape[-1]), int(b.shape[-1])], dtype=a.dtype)
    out = _raw_op("bilinear_tensor_product",
                  {"X": [a], "Y": [b], "Weight": [w]})
    name = _act_name(act)
    return getattr(_fl, name)(out) if name else out


def gated_unit_layer(input, size, act=None, gate_act=None,
                     gate_param_attr=None, gate_bias_attr=None,
                     inproj_param_attr=None, inproj_bias_attr=None,
                     **kwargs):
    """reference gated_unit_layer: act(fc(x)) * gate_act(fc(x))."""
    proj = _fl.fc(input=input, size=size, act=_act_name(act),
                  param_attr=inproj_param_attr, bias_attr=inproj_bias_attr)
    gate = _fl.fc(input=input, size=size,
                  act=_act_name(gate_act) or "sigmoid",
                  param_attr=gate_param_attr, bias_attr=gate_bias_attr)
    return _fl.elementwise_mul(proj, gate)


def prelu_layer(input, partial_sum=1, param_attr=None, num_channels=None,
                channel_shared=None, **kwargs):
    """reference prelu_layer: partial_sum counts elements SHARING one
    alpha — 1 = element-wise (the reference default), the whole feature =
    one shared alpha; channel_shared=False is per-channel alpha over NCHW.
    Intermediate partial_sum groupings (a specific pixel tiling) map to
    the shared form."""
    if channel_shared is False or (num_channels and partial_sum == 1
                                   and channel_shared is None):
        return _fl.prelu(_as_nchw(input, num_channels), mode="channel",
                         param_attr=param_attr)
    mode = "element" if partial_sum == 1 else "all"
    return _fl.prelu(input, mode=mode, param_attr=param_attr)


def multiplex_layer(input, **kwargs):
    """reference multiplex_layer: input[0] is the per-row selector index,
    the rest are candidate tensors."""
    index, candidates = input[0], list(input[1:])
    return _fl.multiplex(candidates, index)


def kmax_seq_score_layer(input, beam_size=1, **kwargs):
    """reference kmax_seq_score_layer: top-k scores over the sequence
    axis. Padded positions are masked to -inf first when the input
    carries lengths — beam scores are log-probs (negative), so unmasked
    zero padding would otherwise win the top-k."""
    from ..fluid.layers.sequence import seq_lengths_of

    scores = input
    lens = seq_lengths_of(input)
    if scores.shape is not None and len(scores.shape) == 3 \
            and scores.shape[-1] == 1:
        scores = _fl.reshape(scores, shape=[0, -1])  # [N, T, 1] -> [N, T]
    if lens is not None:
        from ..fluid.layers.sequence import sequence_mask as _seq_mask

        mask = _seq_mask(lens, maxlen_ref=scores, dtype="float32")  # [N,T]
        # masked = scores*mask + (mask-1)*1e30: valid scores unchanged,
        # padding pushed to -1e30 so it can never enter the top-k
        neg = _fl.scale(_fl.elementwise_sub(
            mask, _fl.fill_constant(shape=[1], dtype=scores.dtype,
                                    value=1.0)), scale=1e30)
        scores = _fl.elementwise_add(_fl.elementwise_mul(scores, mask), neg)
    vals, _ = _fl.topk(scores, k=beam_size)
    return vals


def sub_seq_layer(input, offsets, sizes, **kwargs):
    """reference sub_seq_layer -> sequence_slice op (per-sequence
    offset/size; padded form masks outside the slice)."""
    return _raw_op("sequence_slice",
                   {"X": [input], "Offset": [offsets], "Length": [sizes]})


def switch_order_layer(input, reshape_axis=None, **kwargs):
    """reference switch_order_layer: NCHW <-> NHWC (reshape_axis names the
    split point; the legacy configs only use the [3] <-> channel-last
    form)."""
    return _fl.transpose(input, perm=[0, 2, 3, 1])


def upsample_layer(input, scale=2, upsample_size=None, **kwargs):
    """reference upsample_layer (nearest): integer `scale` repeats
    rows/cols via expand; an explicit `upsample_size` (or (w, h) pair)
    resizes to exactly that via the nearest_interp op."""
    n, c, h, w = [int(s) if s != -1 else -1 for s in input.shape]
    if upsample_size is not None:
        if isinstance(upsample_size, (list, tuple)):
            ow, oh = int(upsample_size[0]), int(upsample_size[1])
        else:
            ow = oh = int(upsample_size)
        return _raw_op("nearest_interp", {"X": [input]},
                       {"out_h": oh, "out_w": ow})
    x = _fl.reshape(input, shape=[-1, c, h, 1, w, 1])
    x = _fl.expand(x, expand_times=[1, 1, 1, scale, 1, scale])
    return _fl.reshape(x, shape=[-1, c, h * scale, w * scale])


def warp_ctc_layer(input, label, blank=0, norm_by_times=False, **kwargs):
    """reference warp_ctc_layer -> fluid warpctc."""
    return _fl.warpctc(input, label, blank=blank,
                       norm_by_times=norm_by_times)


def factorization_machine(input, factor_size, **kwargs):
    """reference factorization_machine: second-order interactions
    0.5 * sum_f [(sum_i v_if x_i)^2 - sum_i (v_if x_i)^2]."""
    from ..fluid.layer_helper import LayerHelper

    helper = LayerHelper("factorization_machine")
    d = int(input.shape[-1])
    v = helper.create_parameter(helper.param_attr, shape=[d, factor_size],
                                dtype=input.dtype)
    xv = _fl.matmul(input, v)                      # [N, F]
    sq_of_sum = _fl.elementwise_mul(xv, xv)
    x2 = _fl.elementwise_mul(input, input)
    v2 = _fl.elementwise_mul(v, v)
    sum_of_sq = _fl.matmul(x2, v2)                 # [N, F]
    diff = _fl.elementwise_sub(sq_of_sum, sum_of_sq)
    return _fl.scale(_fl.reduce_sum(diff, dim=-1, keep_dim=True), scale=0.5)


def _as_ncdhw(input, num_channels=None):
    """Flat volumetric data ([N, C*D*H*W] data layers with declared
    depth/height/width) to NCDHW (reference parse_image3d)."""
    if input.shape is not None and len(input.shape) >= 5:
        return input
    c = int(num_channels or 1)
    dims = getattr(input, "_img_dhw", None)
    if dims is None:
        raise ValueError("3d image layers over flat data need a data layer "
                         "declared with depth=/height=/width=")
    d, h, w = dims
    return _fl.reshape(input, shape=[-1, c, int(d), int(h), int(w)])


def img_conv3d_layer(input, filter_size, num_filters, stride=1, padding=0,
                     act=None, num_channels=None, groups=1, trans=False,
                     **kwargs):
    """reference img_conv3d_layer -> conv3d / conv3d_transpose op (NCDHW,
    OIDHW filter; trans / layer_type="deconv3d" is the transposed form)."""
    from ..fluid.layer_helper import LayerHelper

    trans = trans or kwargs.get("layer_type") == "deconv3d"
    input = _as_ncdhw(input, num_channels)
    helper = LayerHelper("img_conv3d")

    def _triple(v):
        return [int(x) for x in v] if isinstance(v, (list, tuple)) \
            else [int(v)] * 3

    k = _triple(filter_size)
    c = int(input.shape[1])
    op, shape = ("conv3d_transpose", [c, num_filters] + k) if trans else \
        ("conv3d", [num_filters, c] + k)
    w = helper.create_parameter(helper.param_attr, shape=shape,
                                dtype=input.dtype)
    out = _raw_op(op, {"Input": [input], "Filter": [w]},
                  {"strides": _triple(stride), "paddings": _triple(padding),
                   "groups": int(groups or 1)},
                  out_slots=("Output",))
    name = _act_name(act)
    return getattr(_fl, name)(out) if name else out


def img_pool3d_layer(input, pool_size, stride=1, padding=0, pool_type=None,
                     num_channels=None, **kwargs):
    """reference img_pool3d_layer -> pool3d op."""
    kind = pool_type.kind if isinstance(pool_type, _Pool) else (
        pool_type or "max")
    if kind in ("average", "sqrt", "sum"):
        kind = "avg"
    input = _as_ncdhw(input, num_channels)
    k = [pool_size] * 3 if isinstance(pool_size, int) else list(pool_size)
    stride = [stride] * 3 if isinstance(stride, int) else list(stride)
    padding = [padding] * 3 if isinstance(padding, int) else list(padding)
    return _raw_op("pool3d", {"X": [input]},
                   {"pooling_type": kind, "ksize": k,
                    "strides": stride, "paddings": padding})


def cross_channel_norm_layer(input, param_attr=None, **kwargs):
    """reference cross_channel_norm_layer: per-pixel L2 norm across
    channels with a learned per-channel scale (the SSD conv4_3 norm)."""
    from ..fluid.layer_helper import LayerHelper

    helper = LayerHelper("cross_channel_norm", param_attr=param_attr)
    c = int(input.shape[1])
    normed = _fl.l2_normalize(input, axis=1)
    s = helper.create_parameter(helper.param_attr, shape=[1, c, 1, 1],
                                dtype=input.dtype)
    return _fl.elementwise_mul(normed, s)


def priorbox_layer(input, image, min_size, max_size=None, aspect_ratio=None,
                   variance=(0.1, 0.1, 0.2, 0.2), **kwargs):
    """reference priorbox_layer -> fluid prior_box (SSD anchors)."""
    from ..fluid.layers import detection as _det

    boxes, variances = _det.prior_box(
        input, image, min_sizes=list(min_size),
        max_sizes=list(max_size) if max_size else None,
        aspect_ratios=list(aspect_ratio) if aspect_ratio else [1.0],
        variance=list(variance))
    # legacy layout: [P, 8] = boxes || variances per prior — EXACTLY what
    # detection_output_layer splits back apart
    from ..fluid.layers import tensor as _t

    b = _fl.reshape(boxes, shape=[-1, 4])
    v = _fl.reshape(variances, shape=[-1, 4])
    return _t.concat([b, v], axis=1)


def detection_output_layer(input_loc, input_conf, priorbox, num_classes,
                           nms_threshold=0.45, nms_top_k=400, keep_top_k=200,
                           confidence_threshold=0.01, background_id=0,
                           **kwargs):
    """reference detection_output_layer -> fluid detection_output (decode +
    per-class NMS). priorbox here is the [P, 8] concat the legacy layer
    produced (boxes||variances); fluid takes them separately."""
    from ..fluid.layers import detection as _det

    p = int(priorbox.shape[-1]) // 2 if priorbox.shape is not None else None
    boxes = _raw_op("slice", {"Input": [priorbox]},
                    {"axes": [len(priorbox.shape) - 1], "starts": [0],
                     "ends": [p]}) if p else priorbox
    var = _raw_op("slice", {"Input": [priorbox]},
                  {"axes": [len(priorbox.shape) - 1], "starts": [p],
                   "ends": [2 * p]}) if p else priorbox
    return _det.detection_output(
        input_loc, input_conf, boxes, var,
        nms_threshold=nms_threshold, nms_top_k=nms_top_k,
        keep_top_k=keep_top_k, score_threshold=confidence_threshold,
        background_label=background_id)


def selective_fc_layer(input, size, select=None, act=None, **kwargs):
    """reference selective_fc_layer: a full fc whose output is masked to
    the selected columns (the reference computes only selected columns;
    on a GPU the dense matmul + mask is the fast form)."""
    out = _fl.fc(input=input, size=size, act=_act_name(act))
    if select is not None:
        out = _fl.elementwise_mul(out, select)
    return out


def eos_layer(input, eos_id, **kwargs):
    """reference eos_layer: 1.0 where the id equals eos_id."""
    eos = _fl.fill_constant(shape=[1], dtype=input.dtype, value=eos_id)
    return _fl.cast(_fl.equal(input, eos), "float32")


def get_output_layer(input, arg_name=None, **kwargs):
    """reference get_output_layer: project out a named auxiliary output of
    a multi-output layer. Fluid layers return their outputs directly, so
    this is the identity on whichever output the caller picked."""
    return input


def cross_entropy_with_selfnorm(input, label, softmax_selfnorm_alpha=0.1,
                                **kwargs):
    """reference cross_entropy_with_selfnorm: CE + alpha * (log Z)^2
    self-normalization on the softmax partition function."""
    ce = _fl.cross_entropy(input=input, label=label)
    z = _fl.reduce_sum(input, dim=-1, keep_dim=True)
    logz = _raw_op("log", {"X": [z]})
    penalty = _fl.scale(_fl.elementwise_mul(logz, logz),
                        scale=float(softmax_selfnorm_alpha))
    return _fl.mean(_fl.elementwise_add(ce, penalty))


def scaling_projection(input, **kwargs):
    """reference scaling_projection: one learned scalar times the input."""
    def realize(sz):
        from ..fluid.layer_helper import LayerHelper

        helper = LayerHelper("scaling_projection")
        s = helper.create_parameter(helper.param_attr, shape=[1],
                                    dtype=input.dtype)
        return _fl.elementwise_mul(input, s)

    return _Projection(realize, width=int(input.shape[-1]))


def trans_full_matrix_projection(input, size=None, **kwargs):
    """reference trans_full_matrix_projection: project through W^T (shares
    no weight here — the legacy sharing came from param_attr naming, which
    callers can still pass)."""
    def realize(sz):
        from ..fluid.layer_helper import LayerHelper

        helper = LayerHelper("trans_full_matrix_projection")
        sz = sz or size
        w = helper.create_parameter(helper.param_attr,
                                    shape=[sz, int(input.shape[-1])],
                                    dtype=input.dtype)
        return _fl.matmul(input, w, transpose_y=True)

    return _Projection(realize, width=size)


def slice_projection(input, slices, **kwargs):
    """reference slice_projection: concat of [start, end) column slices."""
    def realize(sz):
        parts = []
        axis = len(input.shape) - 1
        for start, end in slices:
            parts.append(_raw_op("slice", {"Input": [input]},
                                 {"axes": [axis], "starts": [start],
                                  "ends": [end]}))
        if len(parts) == 1:
            return parts[0]
        from ..fluid.layers import tensor as _t

        return _t.concat(parts, axis=axis)

    return _Projection(realize,
                       width=sum(end - start for start, end in slices))


def conv_projection(input, filter_size, num_filters, stride=1, padding=0,
                    num_channels=None, trans=False, **kwargs):
    """reference conv_projection (a conv2d usable inside mixed_layer);
    trans=True is the deconv form (reference conv_projection's trans
    flag)."""
    img = _as_nchw(input, num_channels)
    k = int(filter_size)
    h, w = int(img.shape[2]), int(img.shape[3])
    if trans:
        oh = (h - 1) * stride - 2 * padding + k
        ow = (w - 1) * stride - 2 * padding + k
    else:
        oh = (h + 2 * padding - k) // stride + 1
        ow = (w + 2 * padding - k) // stride + 1

    def realize(sz):
        conv = _fl.conv2d_transpose if trans else _fl.conv2d
        out = conv(img, num_filters=num_filters, filter_size=filter_size,
                   stride=stride, padding=padding)
        # mixed_layer sums projections over a flat feature width
        return _fl.reshape(out, shape=[-1, num_filters * oh * ow])

    return _Projection(realize, width=num_filters * oh * ow)


def conv_operator(img, filter, filter_size, num_filters, num_channels=None,
                  stride=1, padding=0, trans=False, **kwargs):
    """reference conv_operator: convolve `img` with a COMPUTED filter
    tensor (not a parameter; e.g. another layer's output). Lowered by the
    conv2d_input_filter op — one grouped convolution over the batch, so
    the per-sample filters still run as one cuDNN call. trans=True is the
    transposed (deconv) form. Returns a mixed_layer projection whose flat
    width matches conv_projection's NCHW flatten."""
    k = int(filter_size)
    img4 = _as_nchw(img, num_channels)
    c = int(img4.shape[1])
    h, w = int(img4.shape[2]), int(img4.shape[3])
    if trans:
        oh = (h - 1) * stride - 2 * padding + k
        ow = (w - 1) * stride - 2 * padding + k
    else:
        oh = (h + 2 * padding - k) // stride + 1
        ow = (w + 2 * padding - k) // stride + 1

    def realize(sz):
        fil = _fl.reshape(filter, shape=[-1, num_filters, c, k, k])
        out = _raw_op("conv2d_input_filter", {"X": [img4], "Filter": [fil]},
                      {"stride": int(stride), "padding": int(padding),
                       "trans": bool(trans)})
        return _fl.reshape(out, shape=[-1, num_filters * oh * ow])

    return _Projection(realize, width=num_filters * oh * ow)


def block_expand_layer(input, block_x, block_y, stride_x=1, stride_y=1,
                       padding_x=0, padding_y=0, num_channels=None,
                       **kwargs):
    """reference block_expand_layer -> fluid im2sequence (im2col as a
    sequence of flattened blocks, the OCR-CTC front end)."""
    return _fl.im2sequence(input, filter_size=[block_y, block_x],
                           stride=[stride_y, stride_x],
                           padding=[padding_y, padding_x])


def repeat_layer_as_seq(input, num_repeats, **kwargs):
    """alias used by some legacy configs; same as repeat_layer."""
    return repeat_layer(input, num_repeats)


def bilinear_interp_layer(input, out_size_x, out_size_y, **kwargs):
    """reference bilinear_interp_layer -> bilinear_interp op."""
    return _raw_op("bilinear_interp", {"X": [input]},
                   {"out_h": int(out_size_y), "out_w": int(out_size_x)})


def sampling_id_layer(input, **kwargs):
    """reference sampling_id_layer -> sampling_id op: sample one id per
    row from the input's (normalized) distribution."""
    return _raw_op("sampling_id", {"X": [input]}, dtype="int64")


def hsigmoid(input, label, num_classes=None, param_attr=None,
             bias_attr=None, **kwargs):
    """reference hsigmoid (trainer_config_helpers/layers.py:2423):
    hierarchical sigmoid cost over a complete binary class tree."""
    if num_classes is None:
        t = getattr(label, "_v2_type", None)
        if t is None or t.kind != "int":
            raise ValueError("hsigmoid needs num_classes= or an integer "
                             "label from v2.layer.data")
        num_classes = t.dim
    return _fl.hsigmoid(input, label, num_classes, param_attr=param_attr,
                        bias_attr=bias_attr)


def conv_shift_layer(a, b, **kwargs):
    """reference conv_shift_layer (layers.py:5066): circular correlation
    c[i] = sum_j a[(i+j) mod M] * b[j], b's width odd."""
    return _raw_op("conv_shift", {"X": [a], "Y": [b]})


def gru_step_naive_layer(input, output_mem, size=None, **kwargs):
    """reference gru_step_naive_layer: same math as gru_step_layer
    without the fused-kernel layout constraint — identical here."""
    return gru_step_layer(input, output_mem, size=size, **kwargs)


def printer_layer(input, format=None, **kwargs):
    """reference printer_layer: print the input tensor at run time
    (maps to the fluid Print op, forward direction)."""
    return print_layer(input, **kwargs)


def lambda_cost(input, score, NDCG_num=5, max_sort_size=-1, **kwargs):
    """reference lambda_cost (layers.py): LambdaRank listwise ranking
    cost — per query, |dNDCG@N|-weighted logistic loss over doc pairs.
    `max_sort_size` is accepted for API parity (the full pairwise form
    here subsumes the reference's partial-sort optimization)."""
    from ..fluid.layers.sequence import seq_lengths_of

    inputs = {"X": [input], "Score": [score]}
    lens = seq_lengths_of(input) or seq_lengths_of(score)
    if lens is not None:
        inputs["Lengths"] = [lens]
    return _raw_op("lambda_cost", inputs, {"NDCG_num": NDCG_num},
                   out_slots=("Cost",))


def scale_sub_region_layer(input, indices, value, num_channels=None,
                           **kwargs):
    """reference scale_sub_region_layer: scale a per-sample
    [c0:c1, h0:h1, w0:w1] box (1-based inclusive) by `value`."""
    return _raw_op("scale_sub_region",
                   {"X": [_as_nchw(input, num_channels)],
                    "Indices": [indices]},
                   {"value": float(value)})


class GeneratedInput:
    """reference paddle.layer.GeneratedInput: marks the decoder input that
    feeds back the previously generated token through an embedding."""

    def __init__(self, size, embedding_name, embedding_size, **kwargs):
        self.size = size                      # vocabulary size
        self.embedding_name = embedding_name  # shared with training
        self.embedding_size = embedding_size


class BeamMemory:
    """Recurrent-state spec for beam_search (declared OUTSIDE the loop —
    the generation While carries state arrays created before the block;
    an in-step memory() declaration could not be loop-carried). One of:
    boot_layer= (encoder-derived init, [B, H]) or size= (zero init)."""

    def __init__(self, boot_layer=None, size=None):
        if boot_layer is None and size is None:
            raise ValueError("BeamMemory needs boot_layer= or size=")
        self.boot_layer = boot_layer
        self.size = size


def beam_search(step, input, bos_id, eos_id, beam_size, max_length=100,
                batch_size=None, memories=(), **kwargs):
    """reference paddle.layer.beam_search (generation over a recurrent
    step). `input` mixes ONE GeneratedInput (the fed-back token) with any
    number of StaticInput layers. Step contract here (documented
    divergence from the config-parser's name-linked in-step memories —
    loop state must pre-exist the While block to be carried):

      * recurrent state is declared up front via `memories=[BeamMemory
        (boot_layer=...), ...]`;
      * the step receives (token_emb, *statics, *memory_values) with
        beams FLATTENED into the batch dim — every tensor is
        [B*K, ...]; StaticInput layers are tiled over beams;
      * the step returns (prob, *new_memory_values): vocabulary
        probabilities plus one update per declared memory, in order.
        Selected beams' memories are reordered by parent via
        batch_gather each step.

    Returns (ids, scores) from beam_search_decode: ids is
    [B, beam, T+1] — ALL beams, best first, bos prefix included —
    and scores the matching per-beam totals. `batch_size` must be
    static (generation lanes are a fixed [batch, beam] shape)."""
    ins = input if isinstance(input, (list, tuple)) else [input]
    gens = [x for x in ins if isinstance(x, GeneratedInput)]
    if len(gens) != 1:
        raise ValueError("beam_search needs exactly one GeneratedInput")
    gen = gens[0]
    statics = [x.input if isinstance(x, StaticInput) else x
               for x in ins if not isinstance(x, GeneratedInput)]
    if batch_size is None:
        raise ValueError(
            "beam_search(batch_size=...) is required: generation lanes "
            "are a fixed [batch, beam] shape")
    B, K, V = int(batch_size), int(beam_size), int(gen.size)

    from ..fluid.layers import tensor as _t

    def _tile_over_beams(v):
        """[B, ...] -> [B*K, ...]: every beam lane sees the same static."""
        tail = [int(d) for d in v.shape[1:]]
        r = _fl.reshape(v, shape=[B, 1] + tail)
        r = _fl.expand(r, expand_times=[1, K] + [1] * len(tail))
        return _fl.reshape(r, shape=[B * K] + tail)

    statics = [_tile_over_beams(s) for s in statics]

    counter = _fl.zeros(shape=[1], dtype="int64")
    limit = _fl.fill_constant(shape=[1], dtype="int64", value=max_length)
    ids_arr = _fl.create_array("int64", max_length + 1, [B, K])
    scores_arr = _fl.create_array("float32", max_length + 1, [B, K])
    parents_arr = _fl.create_array("int32", max_length + 1, [B, K])

    init_ids = _fl.fill_constant(shape=[B, K], dtype="int64", value=bos_id)
    # lane 0 active, lanes 1.. start at -inf so step 1 expands ONE beam
    neg = _fl.fill_constant(shape=[B, K - 1], dtype="float32", value=-1e9) \
        if K > 1 else None
    zero = _fl.fill_constant(shape=[B, 1], dtype="float32", value=0.0)
    init_scores = _t.concat([zero, neg], axis=1) if neg is not None else zero
    _fl.array_write(init_ids, counter, ids_arr)
    _fl.array_write(init_scores, counter, scores_arr)

    # beam-tracked memories: arrays created (and booted) BEFORE the loop
    # so the While op carries them
    mem_arrays, mem_widths = [], []
    for m in memories:
        if m.boot_layer is not None:
            h = int(m.boot_layer.shape[-1])
            boot3 = _fl.reshape(m.boot_layer, shape=[B, 1, h])
            boot3 = _fl.expand(boot3, expand_times=[1, K, 1])
        else:
            h = int(m.size)
            boot3 = _fl.fill_constant(shape=[B, K, h], dtype="float32",
                                      value=0.0)
        arr = _fl.create_array("float32", max_length + 1, [B, K, h])
        _fl.array_write(boot3, counter, arr)
        mem_arrays.append(arr)
        mem_widths.append(h)

    cond = _fl.less_than(counter, limit)
    w = _fl.While(cond)
    with w.block():
        pre_ids = _fl.array_read(ids_arr, counter)
        pre_scores = _fl.array_read(scores_arr, counter)
        emb = _fl.embedding(
            pre_ids, size=[V, gen.embedding_size],
            param_attr=_ParamAttr(name=gen.embedding_name))  # [B, K, E]
        emb_flat = _fl.reshape(emb, shape=[B * K, gen.embedding_size])
        pre_mems = [
            _fl.reshape(_fl.array_read(arr, counter), shape=[B * K, h])
            for arr, h in zip(mem_arrays, mem_widths)
        ]

        outs = step(emb_flat, *statics, *pre_mems)
        outs = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        prob, new_mems = outs[0], outs[1:]
        if len(new_mems) != len(mem_arrays):
            raise ValueError(
                f"beam_search step returned {len(new_mems)} memory updates "
                f"for {len(mem_arrays)} declared memories")

        logp = _raw_op("log", {"X": [prob]})
        logp3 = _fl.reshape(logp, shape=[B, K, V])
        sel_ids, sel_scores, parent = _fl.beam_search(
            pre_ids, pre_scores, logp3, K, end_id=eos_id)
        _fl.increment(counter, value=1)
        _fl.array_write(sel_ids, counter, ids_arr)
        _fl.array_write(sel_scores, counter, scores_arr)
        _fl.array_write(parent, counter, parents_arr)
        for arr, new, h in zip(mem_arrays, new_mems, mem_widths):
            new3 = _fl.reshape(new, shape=[B, K, h])
            _fl.array_write(_fl.batch_gather(new3, parent), counter, arr)
        _fl.less_than(counter, limit, cond=cond)

    return _fl.beam_search_decode(ids_arr, scores_arr, parents_arr,
                                  end_id=eos_id)
