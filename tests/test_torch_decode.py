"""The port's decoder and DecodeEngine (paddle_tpu_torch/serving/decode)
against the JAX package's, on the CPU, at a small size.

Tolerances, and why:
  - parameters: bitwise — both packages draw them from the same numpy
    RandomState in the same order;
  - one decoder step: logits within atol 1e-4 and the KV pools within
    1e-5 (float32, sums taken in another order by XLA and PyTorch);
  - the engines: greedy tokens, steps_to_first_token, cached_tokens and
    the allocator counters EQUAL. Equal tokens only mean something where
    the top-2 logit margin of every compared position exceeds the
    step's float error, so the test asserts a margin above 1e-3;
  - seeded sampling: equal draws for the same logits row.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.observability import metrics as jax_metrics
from paddle_tpu.serving import decode as jd
from paddle_tpu_torch.observability import metrics as torch_metrics
from paddle_tpu_torch.serving import decode as td

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SPEC = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            seed=11)
ENGINE_KW = dict(slots=[1, 2], page_size=4, num_pages=40, max_seq_len=32,
                 prefill_chunk=8)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix: np.asarray(tree.cpu() if isinstance(tree, torch.Tensor)
                               else tree)}


def test_build_decoder_params_bitwise_equal_and_params_from_jax():
    jtree = jd.build_decoder_params(jd.DecoderSpec(**SPEC))
    ttree = td.build_decoder_params(td.DecoderSpec(**SPEC), device="cpu")
    jf, tf = _flat(jtree), _flat(ttree)
    assert sorted(jf) == sorted(tf)
    for k in jf:
        assert tf[k].dtype == np.float32
        np.testing.assert_array_equal(tf[k], jf[k], err_msg=k)
    carried = td.params_from_jax(jtree, device="cpu")
    cf = _flat(carried)
    assert sorted(cf) == sorted(tf)
    for k in cf:
        np.testing.assert_array_equal(cf[k], tf[k], err_msg=k)
    assert isinstance(carried["lnf"], tuple)


def _step_inputs(chunked: bool):
    """One mixed step on a pool that already holds history: slot 0
    decodes (or prefills a 3-token chunk) after 6 cached tokens, slot 1
    prefills, slot 2 is dead."""
    rng = np.random.RandomState(5)
    spec = td.DecoderSpec(**SPEC)
    P, ps, W = 12, 4, 4
    pool_shape = (spec.n_layers, P, ps, spec.n_kv_heads, spec.head_dim)
    k_pool = rng.randn(*pool_shape).astype(np.float32)
    v_pool = rng.randn(*pool_shape).astype(np.float32)
    tables = np.array([[3, 4, 5, 0], [6, 7, 0, 0], [0, 0, 0, 0]], np.int32)
    if chunked:
        C = 4
        q_lens = np.array([3, 4, 0], np.int32)
        kv_lens = np.array([9, 4, 0], np.int32)
    else:
        C = 1
        q_lens = np.array([1, 1, 0], np.int32)
        kv_lens = np.array([7, 1, 0], np.int32)
    tokens = np.zeros((3, C), np.int32)
    positions = np.zeros((3, C), np.int32)
    for b in range(3):
        start = kv_lens[b] - q_lens[b]
        for j in range(q_lens[b]):
            tokens[b, j] = rng.randint(0, spec.vocab)
            positions[b, j] = start + j
    return spec, (tokens, positions, q_lens, k_pool, v_pool, tables,
                  kv_lens)


@pytest.mark.parametrize("form", ["decode", "chunked", "all_lanes"])
def test_decoder_step_chunked_matches_jax(form):
    spec, arrays = _step_inputs(chunked=form != "decode")
    tokens, positions, q_lens, k_pool, v_pool, tables, kv_lens = arrays
    all_lanes = form == "all_lanes"
    jparams = jd.build_decoder_params(jd.DecoderSpec(**SPEC))
    jk, jv, jlog = jd.decoder_step_chunked(
        jparams, jd.DecoderSpec(**SPEC), jnp.asarray(tokens),
        jnp.asarray(positions), jnp.asarray(q_lens), jnp.asarray(k_pool),
        jnp.asarray(v_pool), jnp.asarray(tables), jnp.asarray(kv_lens),
        all_lanes=all_lanes)
    tparams = td.build_decoder_params(spec, device="cpu")
    tk_in = torch.from_numpy(k_pool.copy())
    tv_in = torch.from_numpy(v_pool.copy())
    with torch.no_grad():
        tk, tv, tlog = td.decoder_step_chunked(
            tparams, spec, torch.from_numpy(tokens),
            torch.from_numpy(positions), torch.from_numpy(q_lens), tk_in,
            tv_in, torch.from_numpy(tables), torch.from_numpy(kv_lens),
            all_lanes=all_lanes)
    expect = (3, tokens.shape[1], spec.vocab) if all_lanes \
        else (3, spec.vocab)
    assert tuple(tlog.shape) == expect == np.asarray(jlog).shape
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5,
                               rtol=0)
    # the step wrote the live lanes' K/V in place into the pool it was given
    assert tk is tk_in and not np.array_equal(tk.numpy(), k_pool)


def test_decoder_step_single_token_form_matches_chunked():
    spec, arrays = _step_inputs(chunked=False)
    tokens, positions, q_lens, k_pool, v_pool, tables, kv_lens = arrays
    params = td.build_decoder_params(spec, device="cpu")
    t = [torch.from_numpy(a.copy()) for a in arrays]
    with torch.no_grad():
        _, _, a = td.decoder_step(params, spec, t[0][:, 0], t[1][:, 0],
                                  t[3], t[4], t[5], t[6])
        t = [torch.from_numpy(a.copy()) for a in arrays]
        _, _, b = td.decoder_step_chunked(params, spec, *t)
    assert torch.equal(a, b)


def test_sample_token_draws_equal_jax():
    rng = np.random.RandomState(0)
    for i in range(20):
        row = rng.randn(64).astype(np.float32) * 3
        kw = dict(temperature=float(rng.choice([0.0, 0.7, 1.3])),
                  top_k=int(rng.choice([0, 1, 5])),
                  seed=int(rng.randint(0, 2 ** 31)), position=i)
        assert td.sample_token(row, **kw) == jd.sample_token(row, **kw)


def test_sample_draw_margin_replays_sample_token():
    rng = np.random.RandomState(1)
    for i in range(40):
        row = rng.randn(64).astype(np.float32) * 3
        kw = dict(temperature=float(rng.choice([0.7, 1.0, 1.3])),
                  top_k=int(rng.choice([0, 1, 5, 40])),
                  seed=int(rng.randint(0, 2 ** 31)), position=i)
        tok, margin = td.sample_draw_margin(row, **kw)
        assert tok == td.sample_token(row, **kw)
        assert margin >= 0.0
    with pytest.raises(ValueError):
        td.sample_draw_margin(row, 0.0, 0, 0, 0)


# --- the engines --------------------------------------------------------

COUNTERS = ("serving.kv.page_allocs", "serving.kv.page_frees",
            "serving.kv.preemptions", "serving.kv.restores",
            "serving.kv.demotions", "serving.prefix.hits",
            "serving.prefix.misses", "serving.prefix.cached_tokens",
            "serving.prefix.published_pages", "serving.prefix.cow_copies",
            "serving.decode.steps", "serving.decode.tokens")


def _counts(m):
    return {k: m.counter(k).value() for k in COUNTERS}


def _run_batch(engine, prompts, max_new):
    """Submit every prompt while holding the engine's condition, so the
    scheduler admits them in one go — both engines then see the same
    queue and schedule identically."""
    with engine._cond:
        reqs = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    for r in reqs:
        assert r.ev.wait(120)
        if r.error is not None:
            raise r.error
    return [r.result for r in reqs]


def _both(engine_kw, batches):
    """Run the same sequence of batches through a JAX engine and a port
    engine (device="cpu"); return per-engine results and counter
    deltas."""
    out = {}
    for name, mod, m in (("jax", jd, jax_metrics),
                         ("torch", td, torch_metrics)):
        extra = {"warm": False} if name == "jax" else {"device": "cpu"}
        eng = mod.DecodeEngine(mod.DecoderSpec(**SPEC), name=f"cmp-{name}",
                               **engine_kw, **extra)
        before = _counts(m)
        try:
            res = [_run_batch(eng, prompts, n) for prompts, n in batches]
            pages_used = eng.cache.allocator.pages_used
        finally:
            eng.stop()
        after = _counts(m)
        out[name] = (res, {k: after[k] - before[k] for k in COUNTERS},
                     pages_used)
    return out


def _assert_margins(prompt, tokens):
    """Top-2 logit margin of every generated position, from one
    all-lanes pass of the port's decoder over prompt + generated."""
    spec = td.DecoderSpec(**SPEC)
    params = td.build_decoder_params(spec, device="cpu")
    seq = list(prompt) + list(tokens)
    n = len(seq)
    ps = 4
    w = -(-n // ps)
    pool = (spec.n_layers, w + 1, ps, spec.n_kv_heads, spec.head_dim)
    with torch.no_grad():
        _, _, logits = td.decoder_step_chunked(
            params, spec, torch.tensor([seq], dtype=torch.int32),
            torch.arange(n, dtype=torch.int32)[None],
            torch.tensor([n], dtype=torch.int32), torch.zeros(pool),
            torch.zeros(pool),
            torch.arange(1, w + 1, dtype=torch.int32)[None],
            torch.tensor([n], dtype=torch.int32), all_lanes=True)
    lg = logits[0].numpy()
    for i, tok in enumerate(tokens):
        row = lg[len(prompt) - 1 + i]
        top2 = np.sort(row)[-2:]
        assert int(np.argmax(row)) == tok
        assert top2[1] - top2[0] > 1e-3, (i, top2)


def _assert_same(out, want_preempt=False):
    (jres, jcnt, jused), (tres, tcnt, tused) = out["jax"], out["torch"]
    assert tcnt == jcnt
    assert tused == jused == 0
    for jb, tb in zip(jres, tres):
        for j, t in zip(jb, tb):
            for key in ("tokens", "steps_to_first_token", "cached_tokens",
                        "prompt_len"):
                assert t[key] == j[key], key
    if want_preempt:
        assert tcnt["serving.kv.preemptions"] > 0
        assert tcnt["serving.kv.restores"] > 0


def test_engine_matches_jax_chunked_prefill_and_prefix_hit():
    rng = np.random.RandomState(3)
    prompts = [[int(t) for t in rng.randint(0, 64, size=n)]
               for n in (5, 13, 20, 3)]
    # batch 2 re-sends batch 1's 20-token prompt with a new tail: a
    # prefix-cache hit with a copy-on-write tail page
    hit = prompts[2][:18] + [7, 9]
    batches = [(prompts, 6), ([hit, [1, 2, 3, 4, 5, 6, 7, 8, 9]], 5)]
    out = _both(ENGINE_KW, batches)
    _assert_same(out)
    tres = out["torch"][0]
    assert tres[1][0]["cached_tokens"] == 18
    assert tres[0][2]["steps_to_first_token"] >= 3   # ceil(20/8) at least
    for batch, (prompts_b, _) in zip(tres, batches):
        for res, p in zip(batch, prompts_b):
            _assert_margins(p, res["tokens"])


def test_engine_matches_jax_under_demand_preemption():
    kw = dict(slots=[2], page_size=4, num_pages=9, max_seq_len=32,
              prefill_chunk=4, reservation="demand", prefix_cache=False)
    prompts = [[1 + i, 2 + i] for i in range(3)]
    out = _both(kw, [(prompts, 18)])
    _assert_same(out, want_preempt=True)
    for res, p in zip(out["torch"][0][0], prompts):
        assert len(res["tokens"]) == 18
        _assert_margins(p, res["tokens"])


def test_engine_refuses_unported_options_and_missing_card(monkeypatch):
    spec = td.DecoderSpec(**SPEC)
    # the ported load-time checks: a draft must share vocab and eos, and
    # a misspelled spec field is refused, never dropped
    td.validate_draft_spec(spec, td.DecoderSpec(**dict(SPEC, n_layers=1)))
    with pytest.raises(ValueError, match="'vocab'"):
        td.validate_draft_spec(spec, td.DecoderSpec(**dict(SPEC, vocab=32)))
    with pytest.raises(ValueError, match="unknown DecoderSpec field"):
        td.DecoderSpec.from_dict(dict(SPEC, nheads=4))
    # a mesh of two devices needs a world of two ranks (the sharded
    # engine itself: tests/test_torch_mesh_serving.py)
    with pytest.raises(RuntimeError, match="needs 2 processes"):
        td.DecodeEngine(spec, mesh="tp=2", device="cpu", warm=False)
    # slots="auto" resolves through the autotune layer: a cached ladder
    # for this device kind, else the static default on no traffic
    from paddle_tpu_torch import autotune

    autotune.reset_histograms()
    with autotune.scoped() as cache:
        eng = td.DecodeEngine(spec, slots="auto", device="cpu", warm=False)
        assert eng.stats()["slots"] == [1, 2, 4]
        eng.stop()
        cache.put("decode_slots", [1, 3], shape_key="ladder",
                  source="derived")
        eng = td.DecodeEngine(spec, slots="auto", device="cpu", warm=False)
        assert eng.stats()["slots"] == [1, 3]
        eng.stop()
    # no device means the card: with none present it raises, never
    # drifting to the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.DecodeEngine(spec, warm=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.build_decoder_params(spec)


def test_engine_stats_and_warm_shapes():
    eng = td.DecodeEngine(td.DecoderSpec(**SPEC), device="cpu",
                          **ENGINE_KW)
    try:
        st = eng.stats()
        assert st["device"] == "cpu"
        # slots [1, 2] x widths [1, 2, 4, 8] x chunks [1, 8]
        assert len(st["compiled_shapes"]) == 16
        r = eng.generate([3, 1, 4, 1, 5, 9, 2, 6, 5, 3], max_new_tokens=4)
        assert len(r["tokens"]) == 4
        assert r["steps_to_first_token"] == 2        # ceil(10 / 8)
        assert len(eng.stats()["compiled_shapes"]) == 16
    finally:
        eng.stop()
    assert eng.cache.k is None
