"""The port's speculative decoding (paddle_tpu_torch/serving/decode.py:
draft proposals, the all-lane verify step, acceptance, rollback, the
mirrored draft pool) against the JAX engine's, on the CPU, at a small
size.

Tolerances, and why:
  - tokens, target/draft step counts and the serving.decode.spec.*
    counters EQUAL the JAX engine's, and tokens equal the port's own
    spec-off engine. Equal tokens only mean something where the top-2
    logit margin of every compared position exceeds the step's float
    error, so the greedy cases assert a margin above 1e-3 (the
    decoder's float32 logits agree with JAX's within 1e-4,
    tests/test_torch_decode.py);
  - allocator counters (allocs, frees, shrunk pages, preemptions,
    restores) and the pool's pages_used after the drain: equal.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.observability import metrics as jax_metrics
from paddle_tpu.serving import decode as jd
from paddle_tpu_torch.distributed import faults as torch_faults
from paddle_tpu_torch.observability import metrics as torch_metrics
from paddle_tpu_torch.serving import decode as td
from paddle_tpu_torch.serving import ServingClient, ServingServer
from paddle_tpu_torch.serving.errors import ServingError
from paddle_tpu_torch.serving.kv_cache import (HostSpillStore,
                                               PageAllocator, PagedKvCache)

torch.backends.cuda.matmul.allow_tf32 = False

SPEC = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            seed=11)
# the target's first layer (the same seed draws tok_emb and layer0
# first): agrees with the target often, not always
DRAFT_SMALL = dict(SPEC, n_layers=1)
# a draft of its own seed: rejects most proposals on [7, 2]
DRAFT_OTHER = dict(SPEC, seed=5)
ENGINE_KW = dict(slots=[2], page_size=8, num_pages=24, max_seq_len=32,
                 prefill_chunk=8)
COUNTERS = ("serving.decode.target_steps", "serving.decode.spec.draft_steps",
            "serving.decode.spec.proposed", "serving.decode.spec.accepted",
            "serving.decode.spec.rejected", "serving.decode.steps",
            "serving.decode.tokens", "serving.kv.page_allocs",
            "serving.kv.page_frees", "serving.kv.shrunk_pages",
            "serving.kv.preemptions", "serving.kv.restores")


def _counts(m):
    return {k: m.counter(k).value() for k in COUNTERS}


def _engine(mod, name, engine_kw, draft=None, spec_k=None, spec=SPEC):
    extra = {"warm": False} if mod is jd else {"device": "cpu"}
    kw = dict(engine_kw, **extra)
    if draft is not None:
        kw.update(draft_spec=mod.DecoderSpec(**draft), spec_k=spec_k)
    return mod.DecodeEngine(mod.DecoderSpec(**spec), name=name, **kw)


def _run(engine, prompts, max_new, **gen):
    """Submit every prompt under the engine's condition so the scheduler
    admits them in one go — both packages then schedule identically."""
    with engine._cond:
        reqs = [engine.submit(p, max_new_tokens=max_new, **gen)
                for p in prompts]
    for r in reqs:
        assert r.ev.wait(120)
        if r.error is not None:
            raise r.error
    return [r.result for r in reqs]


@pytest.fixture(scope="module")
def jax_engines():
    """JAX engines shared by the module, one per (engine kwargs, draft,
    spec_k): each compiles its step shapes once."""
    made = {}

    def get(engine_kw, draft, spec_k):
        key = (repr(sorted(engine_kw.items())), repr(draft), spec_k)
        if key not in made:
            made[key] = _engine(jd, f"sd-jax{len(made)}", engine_kw,
                                draft, spec_k)
        return made[key]

    yield get
    for eng in made.values():
        eng.stop()


def _both(jax_engines, engine_kw, prompts, max_new, draft, spec_k, **gen):
    """The same batch through a JAX engine and a port engine with the
    same draft: results, counter deltas over the traffic, pages_used."""
    out = {}
    for name, mod, m in (("jax", jd, jax_metrics),
                         ("torch", td, torch_metrics)):
        eng = (jax_engines(engine_kw, draft, spec_k) if mod is jd else
               _engine(mod, f"sd-{name}", engine_kw, draft, spec_k))
        before = _counts(m)
        try:
            res = _run(eng, prompts, max_new, **gen)
            used = eng.cache.allocator.pages_used
        finally:
            if mod is td:
                eng.stop()
        after = _counts(m)
        out[name] = (res, {k: after[k] - before[k] for k in COUNTERS},
                     used)
    return out


def _assert_margins(prompt, tokens, spec=SPEC):
    """Top-2 logit margin of every generated position, from one
    all-lanes pass of the port's decoder over prompt + generated."""
    sp = td.DecoderSpec(**spec)
    params = td.build_decoder_params(sp, device="cpu")
    seq = list(prompt) + list(tokens)
    n, ps = len(seq), 4
    w = -(-n // ps)
    pool = (sp.n_layers, w + 1, ps, sp.n_kv_heads, sp.head_dim)
    with torch.no_grad():
        _, _, logits = td.decoder_step_chunked(
            params, sp, torch.tensor([seq], dtype=torch.int32),
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


PROMPTS = [[4, 9, 1], [7, 2], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11]]


@pytest.mark.parametrize("draft", ["identical", "disagreeing"])
def test_spec_matches_jax_and_spec_off(jax_engines, draft):
    dspec = SPEC if draft == "identical" else DRAFT_SMALL
    out = _both(jax_engines, ENGINE_KW, PROMPTS, 12, dspec, 3)
    (jres, jcnt, jused), (tres, tcnt, tused) = out["jax"], out["torch"]
    assert tcnt == jcnt
    assert tused == jused == 0
    for j, t in zip(jres, tres):
        for key in ("tokens", "steps_to_first_token", "spec_proposed",
                    "spec_accepted", "accept_rate"):
            assert t[key] == j[key], key
    off = _engine(td, "sd-off", ENGINE_KW)
    before = torch_metrics.counter("serving.decode.target_steps").value()
    try:
        ref = _run(off, PROMPTS, 12)
    finally:
        off.stop()
    off_steps = (torch_metrics.counter("serving.decode.target_steps")
                 .value() - before)
    assert [r["tokens"] for r in tres] == [r["tokens"] for r in ref]
    for p, r in zip(PROMPTS, tres):
        _assert_margins(p, r["tokens"])
    assert tcnt["serving.decode.spec.proposed"] == \
        tcnt["serving.decode.spec.accepted"] + \
        tcnt["serving.decode.spec.rejected"] > 0
    if draft == "identical":
        assert tcnt["serving.decode.spec.rejected"] == 0
        assert all(r["accept_rate"] == 1.0 for r in tres)
        # the trade: strictly fewer target steps for the same tokens
        assert tcnt["serving.decode.target_steps"] < off_steps
    else:
        assert tcnt["serving.decode.spec.rejected"] > 0


def test_seeded_sampling_equal_spec_on_off_and_jax(jax_engines):
    """The verify walk re-derives the per-(seed, position) draw, so
    acceptance cannot perturb a sampled realization."""
    prompts = [[7, 2, 19], [3, 3, 8, 1]]
    gen = dict(temperature=0.9, top_k=6, seed=303)
    out = _both(jax_engines, ENGINE_KW, prompts, 10, DRAFT_SMALL, 3, **gen)
    tres = [r["tokens"] for r in out["torch"][0]]
    assert tres == [r["tokens"] for r in out["jax"][0]]
    assert out["torch"][1] == out["jax"][1]
    off = _engine(td, "sd-soff", ENGINE_KW)
    try:
        assert [r["tokens"] for r in _run(off, prompts, 10, **gen)] == tres
    finally:
        off.stop()


def test_rejected_suffix_rolls_back_pages_exactly(jax_engines):
    """page_size 2 and spec_k 4: a verify chunk spans pages, so some
    rejection leaves a grown page holding only rejected positions — it
    goes back to the pool (serving.kv.shrunk_pages), and every page is
    back after the drain, as in the JAX engine."""
    kw = dict(slots=[1], page_size=2, num_pages=24, max_seq_len=24,
              prefill_chunk=4, reservation="demand")
    out = _both(jax_engines, kw, [[7, 2]], 16, DRAFT_OTHER, 4)
    (jres, jcnt, jused), (tres, tcnt, tused) = out["jax"], out["torch"]
    assert tres[0]["tokens"] == jres[0]["tokens"]
    assert len(tres[0]["tokens"]) == 16
    assert tcnt == jcnt
    assert tused == jused == 0
    assert tcnt["serving.decode.spec.rejected"] > 0
    assert tcnt["serving.kv.shrunk_pages"] > 0


def test_preempt_restore_with_draft_spills_both_pools_bitwise(jax_engines):
    """Demand reservation on a pool too small for two growing slots:
    preemption spills the target AND the mirrored draft pages in one
    put; restore scatters both back. Tokens equal a worst-case engine
    that never preempts, and the JAX engine's, counters included."""
    prompts = [[1 + i] * 4 for i in range(4)]
    kw = dict(slots=[2], page_size=4, num_pages=1 + 8, max_seq_len=20,
              prefill_chunk=4, reservation="demand", prefix_cache=False)
    out = _both(jax_engines, kw, prompts, 16, DRAFT_SMALL, 2)
    (jres, jcnt, jused), (tres, tcnt, tused) = out["jax"], out["torch"]
    assert [r["tokens"] for r in tres] == [r["tokens"] for r in jres]
    assert tcnt == jcnt
    assert tused == jused == 0
    assert tcnt["serving.kv.preemptions"] > 0
    assert tcnt["serving.kv.restores"] == tcnt["serving.kv.preemptions"]
    ref = _engine(td, "sd-ref", dict(kw, num_pages=1 + 4 * 5,
                                     reservation="worst_case"),
                  DRAFT_SMALL, 2)
    try:
        want = [ref.generate(p, max_new_tokens=16)["tokens"]
                for p in prompts]
    finally:
        ref.stop()
    assert [r["tokens"] for r in tres] == want


def test_spill_store_and_fault_site():
    """HostSpillStore carries the four-array (target + draft) spill
    through RAM and disk; the serving.decode.spec fault site fails the
    round's request typed and the engine keeps serving."""
    rng = np.random.RandomState(2)
    arrays = tuple(rng.randn(1, 2, 4, 1, 8).astype(np.float32)
                   for _ in range(4))
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        for directory in ("", tmp):
            store = HostSpillStore(directory, label="t")
            store.put(5, *arrays)
            got = store.pop(5)
            assert len(got) == 4
            for a, b in zip(arrays, got):
                np.testing.assert_array_equal(a, b)
    eng = _engine(td, "sd-fault", ENGINE_KW, DRAFT_SMALL, 2)
    try:
        with torch_faults.scoped("error@serving.decode.spec:0"):
            req = eng.submit([4, 9], max_new_tokens=6)
            assert req.ev.wait(60)
            assert isinstance(req.error, ServingError)
        assert len(eng.generate([4, 9], max_new_tokens=6)["tokens"]) == 6
        assert eng.cache.allocator.pages_used == 0
    finally:
        eng.stop()
    assert eng._draft_cache is None and eng.cache.k is None


def test_mirrored_geometry_and_mismatched_drafts_refused_typed():
    alloc = PageAllocator(num_pages=8, page_size=4)
    with pytest.raises(ValueError, match="geometry"):
        PagedKvCache(1, 1, 8, page_size=8, num_pages=8, allocator=alloc,
                     device="cpu")
    with pytest.raises(ValueError, match="geometry"):
        PagedKvCache(1, 1, 8, page_size=4, num_pages=16, allocator=alloc,
                     device="cpu")
    pool = PagedKvCache(1, 1, 8, page_size=4, num_pages=8,
                        allocator=alloc, device="cpu")
    assert pool.allocator is alloc
    pool.release()
    spec = td.DecoderSpec(**SPEC)
    for field, val in (("vocab", 32), ("eos_id", 3)):
        bad = dict(SPEC, **{field: val})
        with pytest.raises(ValueError, match=f"field '{field}'"):
            td.DecodeEngine(spec, draft_spec=bad, spec_k=2, device="cpu",
                            warm=False, **ENGINE_KW)
        with pytest.raises(ValueError, match=f"field '{field}'"):
            jd.validate_draft_spec(jd.DecoderSpec(**SPEC),
                                   jd.DecoderSpec(**bad))
    with pytest.raises(ValueError, match="needs a draft"):
        td.DecodeEngine(spec, spec_k=2, device="cpu", warm=False)
    with pytest.raises(ValueError, match="spec_k"):
        td.DecodeEngine(spec, draft_spec=DRAFT_SMALL, spec_k=-1,
                        device="cpu", warm=False)
    # a flag-sourced spec_k (None here: the flag's 0) leaves the draft off
    eng = td.DecodeEngine(spec, draft_spec=DRAFT_SMALL, device="cpu",
                          warm=False, **ENGINE_KW)
    try:
        assert eng.spec_k == 0 and eng.stats()["draft"] is None
    finally:
        eng.stop()


def test_load_decoder_rpc_with_draft_matches_jax(jax_engines):
    load = dict(ENGINE_KW, draft_spec=SPEC, spec_k=3)
    srv = ServingServer(device="cpu")
    cli = ServingClient(srv.serve())
    try:
        st = cli.load_decoder("sgen", SPEC, **load)
        assert st["spec_k"] == 3 and st["draft"]["seed"] == 11
        out = cli.generate("sgen", [3, 1, 4], max_new_tokens=6)
        assert out["spec_proposed"] > 0 and out["accept_rate"] == 1.0
        assert cli.load_report()["models"]["sgen"]["spec_k"] == 3
        with pytest.raises(ValueError, match="field 'vocab'"):
            cli.load_decoder("sbad", SPEC, **dict(
                load, draft_spec=dict(SPEC, vocab=32)))
    finally:
        cli.close()
        srv.shutdown()
    ref = jax_engines(ENGINE_KW, SPEC, 3).generate([3, 1, 4],
                                                   max_new_tokens=6)
    for key in ("tokens", "spec_proposed", "spec_accepted"):
        assert out[key] == ref[key], key
