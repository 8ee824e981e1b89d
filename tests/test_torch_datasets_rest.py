"""The port's last five datasets (``flowers``, ``mq2007``, ``sentiment``,
``voc2012``, ``wmt16``) against the JAX package's on the CPU:

  (a) every sample of every reader (each split, mq2007's three formats)
      equals the JAX reader's, bit for bit, and so do the dictionaries;
  (b) each dataset feeds the model that first needs it, built by both
      packages (the same program bytes, up to the int32 the JAX package
      records for an int64 var), the JAX startup's parameters copied into
      the port, for STEPS steps on the same batches: flowers a VGG-16
      (vgg16_bn_drop) at 102 classes on the images' central 32x32 (the
      dropout ops set to their test mode in both programs: jax.random's
      masks cannot be matched), wmt16 the Transformer at a small width,
      sentiment the book's sentiment conv net over its 2048 words,
      voc2012 an SSD whose ground-truth box is the segmentation mask's
      extent, mq2007 a pairwise RankNet (``rank_loss`` over a shared
      scorer). Losses within LOSS_RTOL of the JAX package's.
"""
import json
import types

import numpy as np
import pytest

import chip_smoke
import paddle_tpu
import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid import nets as jnets
from paddle_tpu.fluid import unique_name as junique
import paddle_tpu_torch
import paddle_tpu_torch.fluid as tfluid

LOSS_RTOL = 2e-5
STEPS = 2
BATCH = 4
JAX = types.SimpleNamespace(paddle=paddle_tpu, fluid=jfluid, layers=jlayers,
                            nets=jnets, unique_name=junique, name="jax")
PORT = chip_smoke.port_pkg()
PORT.name = "port"


# --- (a) the samples ----------------------------------------------------------

def _readers(ds):
    return {
        "flowers": [ds.flowers.train(), ds.flowers.test(),
                    ds.flowers.valid()],
        "mq2007": [getattr(ds.mq2007, split)(format=f)
                   for split in ("train", "test")
                   for f in ("pairwise", "pointwise", "listwise")],
        "sentiment": [ds.sentiment.train(), ds.sentiment.test()],
        "voc2012": [ds.voc2012.train(), ds.voc2012.test(), ds.voc2012.val()],
        "wmt16": [ds.wmt16.train(), ds.wmt16.test(), ds.wmt16.validation(),
                  ds.wmt16.train(64, 80)],
    }


def _same(t, j):
    if isinstance(j, np.ndarray):
        assert isinstance(t, np.ndarray) and t.dtype == j.dtype
        assert t.shape == j.shape and t.tobytes() == j.tobytes()
    elif isinstance(j, (list, tuple)):
        assert type(t) is type(j) and len(t) == len(j)
        for a, b in zip(t, j):
            _same(a, b)
    else:
        assert type(t) is type(j) and t == j


@pytest.mark.parametrize("name", ["flowers", "mq2007", "sentiment",
                                  "voc2012", "wmt16"])
def test_a_samples_equal_jax(name):
    jrs = _readers(paddle_tpu.dataset)[name]
    trs = _readers(paddle_tpu_torch.dataset)[name]
    for jr, tr in zip(jrs, trs):
        n = 0
        for t, j in zip(tr(), jr()):
            _same(t, j)
            n += 1
        assert n == sum(1 for _ in jr()) > 0
    jm = getattr(paddle_tpu.dataset, name)
    tm = getattr(paddle_tpu_torch.dataset, name)
    if name == "sentiment":
        assert tm.get_word_dict() == jm.get_word_dict()
    if name == "wmt16":
        for rev in (False, True):
            assert tm.get_dict("de", 50, rev) == jm.get_dict("de", 50, rev)
    for const in ("FEATURE_DIM", "VOCAB_SIZE", "NUM_CLASSES", "H",
                  "TOTAL_EN_WORDS", "TOTAL_DE_WORDS"):
        if hasattr(jm, const):
            assert getattr(tm, const) == getattr(jm, const)


# --- (b) each dataset through its model ---------------------------------------

def _program(pkg, seed, body):
    fluid = pkg.fluid
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.unique_name.guard(), fluid.program_guard(main, startup):
        cost, feeds, opt = body(pkg.layers)
        opt.minimize(cost)
    return main, startup, cost, feeds


def _vgg_flowers(pkg):
    vgg = __import__(pkg.paddle.__name__ + ".models.vgg", fromlist=["x"])

    def body(layers):
        img = layers.data(name="img", shape=[3, 32, 32], dtype="float32")
        label = layers.data(name="label", shape=[1], dtype="int64")
        cost, _, _ = vgg.build_train(img, label, class_dim=102)
        return cost, [img, label], pkg.fluid.optimizer.Momentum(
            learning_rate=0.01, momentum=0.9)

    built = _program(pkg, 5, body)
    meta = pkg.fluid.registry.FWD_META_ATTR
    for op in built[0].global_block().ops:
        if op.desc.type == "dropout":
            op.desc.attrs["is_test"] = True
        elif op.desc.type == "dropout_grad":  # the forward it replays
            op.desc.attrs[meta]["attrs"]["is_test"] = True
    built[0]._bump_version()
    return built


def _flowers_batches():
    rows = [(img[:, 96:128, 96:128], label)
            for img, label in paddle_tpu_torch.dataset.flowers.train()()]
    return [rows[i * BATCH:(i + 1) * BATCH] for i in range(STEPS)]


TRANSFORMER = dict(src_vocab=64, trg_vocab=80, max_len=32, d_model=32,
                   n_heads=4, d_ff=64, n_layers=1, dropout=0.0)


def _transformer_wmt16(pkg):
    transformer = __import__(pkg.paddle.__name__ + ".models.transformer",
                             fromlist=["x"])

    def body(layers):
        cfg = transformer.TransformerConfig(**TRANSFORMER)
        src = layers.data(name="src", shape=[cfg.max_len], dtype="int64")
        trg = layers.data(name="trg", shape=[cfg.max_len], dtype="int64")
        lbl = layers.data(name="lbl", shape=[cfg.max_len, 1], dtype="int64")
        cost, _ = transformer.build_train(cfg, src, trg, lbl)
        return cost, None, pkg.fluid.optimizer.Adam(1e-3)

    return _program(pkg, 3, body)


def _wmt16_feeds():
    """wmt16 samples at the Transformer's vocabularies, each id sequence
    padded with <e> to max_len."""
    rows = list(paddle_tpu_torch.dataset.wmt16.train(
        TRANSFORMER["src_vocab"], TRANSFORMER["trg_vocab"])())
    L, end = TRANSFORMER["max_len"], paddle_tpu_torch.dataset.wmt16.END_ID

    def pad(seqs):
        return np.asarray([s[:L] + [end] * (L - len(s[:L])) for s in seqs],
                          np.int64)

    feeds = []
    for i in range(STEPS):
        b = rows[i * BATCH:(i + 1) * BATCH]
        feeds.append({"src": pad([r[0] for r in b]),
                      "trg": pad([r[1] for r in b]),
                      "lbl": pad([r[2] for r in b])[:, :, None]})
    return feeds


def _sentiment_conv(pkg):
    dict_dim = pkg.paddle.dataset.sentiment.VOCAB_SIZE

    def body(layers):
        data = layers.data(name="words", shape=[1], dtype="int64",
                           lod_level=1)
        label = layers.data(name="label", shape=[1], dtype="int64")
        e = layers.embedding(input=data, size=[dict_dim, 32])
        convs = [pkg.nets.sequence_conv_pool(
            input=e, num_filters=32, filter_size=k, act="tanh",
            pool_type="sqrt") for k in (3, 4)]
        logits = layers.fc(input=layers.concat(input=convs, axis=1), size=2)
        cost = layers.mean(layers.softmax_with_cross_entropy(
            logits=logits, label=label))
        return cost, [data, label], pkg.fluid.optimizer.Adam(2e-3)

    return _program(pkg, 17, body)


def _sentiment_batches():
    rows = list(paddle_tpu_torch.dataset.sentiment.train()())
    return [[(ids, [lab]) for ids, lab in rows[i * 8:(i + 1) * 8]]
            for i in range(STEPS)]


SSD_HW, SSD_CLASSES = 64, 21


def _ssd_voc(pkg):
    def body(layers):
        img = layers.data(name="img", shape=[3, SSD_HW, SSD_HW],
                          dtype="float32")
        gt_box = layers.data(name="gt_box", shape=[1, 4], dtype="float32")
        gt_label = layers.data(name="gt_label", shape=[1], dtype="int64")
        x, maps = img, []
        for ch in (8, 16, 16):
            x = layers.conv2d(x, num_filters=ch, filter_size=3, padding=1,
                              act="relu")
            x = layers.pool2d(x, pool_size=2, pool_stride=2)
            maps.append(x)
        loc, conf, box, var = layers.multi_box_head(
            maps, img, base_size=SSD_HW, num_classes=SSD_CLASSES,
            aspect_ratios=[[2.0], [2.0], [2.0]], min_ratio=20, max_ratio=90,
            flip=True)
        cost = layers.mean(layers.ssd_loss(loc, conf, gt_box, gt_label, box,
                                           var))
        return cost, None, pkg.fluid.optimizer.SGD(learning_rate=0.05)

    return _program(pkg, 5, body)


def _voc_feeds():
    """Each image's box is its mask's extent (normalized), its label the
    mask's class."""
    rows = list(paddle_tpu_torch.dataset.voc2012.train()())
    feeds = []
    for i in range(STEPS):
        imgs, boxes, labels = [], [], []
        for img, seg in rows[i * BATCH:(i + 1) * BATCH]:
            ys, xs = np.nonzero(seg)
            boxes.append([[xs.min() / SSD_HW, ys.min() / SSD_HW,
                           (xs.max() + 1) / SSD_HW, (ys.max() + 1) / SSD_HW]])
            labels.append([int(seg.max())])
            imgs.append(img)
        feeds.append({"img": np.stack(imgs),
                      "gt_box": np.asarray(boxes, np.float32),
                      "gt_label": np.asarray(labels, np.int64)})
    return feeds


def _ranknet_mq2007(pkg):
    dim = pkg.paddle.dataset.mq2007.FEATURE_DIM

    def body(layers):
        left = layers.data(name="left", shape=[dim], dtype="float32")
        right = layers.data(name="right", shape=[dim], dtype="float32")
        label = layers.data(name="label", shape=[1], dtype="float32")

        def score(x):
            h = layers.fc(input=x, size=16, act="relu",
                          param_attr=pkg.fluid.ParamAttr(name="rank.h.w"),
                          bias_attr=pkg.fluid.ParamAttr(name="rank.h.b"))
            return layers.fc(input=h, size=1,
                             param_attr=pkg.fluid.ParamAttr(name="rank.o.w"),
                             bias_attr=pkg.fluid.ParamAttr(name="rank.o.b"))

        sl, sr = score(left), score(right)
        helper = pkg.fluid.layer_helper.LayerHelper("rank_loss")
        out = helper.create_variable_for_type_inference("float32")
        helper.append_op(type="rank_loss", inputs={
            "Label": [label], "Left": [sl], "Right": [sr]},
            outputs={"Out": [out]})
        return layers.mean(out), None, pkg.fluid.optimizer.SGD(0.1)

    return _program(pkg, 9, body)


def _mq2007_feeds():
    """Pairwise samples: the more relevant document left, label 1."""
    rows = list(paddle_tpu_torch.dataset.mq2007.train("pairwise")())
    feeds = []
    for i in range(STEPS):
        b = rows[i * 16:(i + 1) * 16]
        feeds.append({"left": np.stack([r[0] for r in b]),
                      "right": np.stack([r[1] for r in b]),
                      "label": np.ones((len(b), 1), np.float32)})
    return feeds


def _persistables(program, scope):
    return {n: np.asarray(scope.find_var(n))
            for n, v in program.global_block().vars.items()
            if v.persistable and scope.find_var(n) is not None}


def _same_program(tp, jp):
    if tp.to_bytes() == jp.to_bytes():
        return
    tj, jj = json.loads(tp.to_bytes()), json.loads(jp.to_bytes())
    for tb, jb in zip(tj["blocks"], jj["blocks"]):
        for name, tv in tb["vars"].items():
            jv = jb["vars"].get(name)
            if jv is not None and (jv.get("dtype"), tv.get("dtype")) == (
                    "int32", "int64"):
                jv["dtype"] = "int64"
    assert tj == jj


def _feed_with(pkg, built, batch):
    """A feed dict as is, or a batch of samples through the package's
    DataFeeder."""
    if isinstance(batch, dict):
        return batch
    main, _, _, feeds = built
    kw = {} if pkg is JAX else {"place": tfluid.CPUPlace()}
    return pkg.fluid.DataFeeder(feed_list=feeds, program=main,
                                **kw).feed(batch)


CASES = {"flowers": (_vgg_flowers, _flowers_batches),
         "wmt16": (_transformer_wmt16, _wmt16_feeds),
         "sentiment": (_sentiment_conv, _sentiment_batches),
         "voc2012": (_ssd_voc, _voc_feeds),
         "mq2007": (_ranknet_mq2007, _mq2007_feeds)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_b_dataset_feeds_its_model_like_jax(name):
    build, batches = CASES[name]
    jb, tb = build(JAX), build(PORT)
    _same_program(tb[0], jb[0])
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(jb[1], scope=jscope)
    texe, tscope = tfluid.Executor("cpu"), tfluid.Scope()
    tfluid.params_from_jax(_persistables(jb[0], jscope), tscope,
                           device="cpu")
    losses = {"jax": [], "port": []}
    for batch in batches():
        for side, pkg, exe, built, scope in (
                ("jax", JAX, jexe, jb, jscope),
                ("port", PORT, texe, tb, tscope)):
            (loss,) = exe.run(built[0], feed=_feed_with(pkg, built, batch),
                              fetch_list=[built[2]], scope=scope)
            losses[side].append(float(np.ravel(np.asarray(loss))[0]))
    assert len(losses["port"]) == STEPS
    assert all(np.isfinite(losses["port"]))
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=LOSS_RTOL)
