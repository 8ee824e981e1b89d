"""The port's typed serving workloads (paddle_tpu_torch/serving/workloads
and the engine's mask, fork-point and embed paths) against the JAX
package's, on the CPU, at a small size.

Tolerances, and why:
  - mask automata: the allowed set of every state reached EQUALS JAX's
    (numpy on both sides, the same code);
  - constrained and beam tokens, first_topk, cached_tokens and
    shared_prompt_pages: EQUAL (the decoder's logits agree within 1e-4,
    and these small models' top-2 margins are far above that);
  - embeddings and logprobs: within rtol 1e-5, atol 1e-6 — as the JAX
    package holds its chunk-width invariance (float32 hidden states,
    float64 pooling and log-softmax on the host).
"""
import threading
import time

import numpy as np
import pytest

from paddle_tpu.serving import decode as jd
from paddle_tpu.serving import workloads as jw
from paddle_tpu_torch.distributed import faults as torch_faults
from paddle_tpu_torch.observability import metrics as torch_metrics
from paddle_tpu_torch.serving import decode as td
from paddle_tpu_torch.serving import workloads as tw
from paddle_tpu_torch.serving import ServingClient, ServingServer
from paddle_tpu_torch.serving.errors import ServingError

SPEC = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            seed=11)
ENGINE_KW = dict(slots=[1, 2], page_size=4, num_pages=40, max_seq_len=32,
                 prefill_chunk=8, prefix_cache=True, embeddings=True)


def _engine(mod, name, **kw):
    extra = {"warm": False} if mod is jd else {"device": "cpu"}
    return mod.DecodeEngine(mod.DecoderSpec(**SPEC), name=name,
                            **dict(ENGINE_KW, **kw), **extra)


@pytest.fixture(scope="module")
def engines():
    """One all-kinds engine of each package (embeddings + prefix cache
    on), shared by the module."""
    jeng = _engine(jd, "wl-jax")
    teng = _engine(td, "wl-torch")
    yield jeng, teng
    jeng.stop()
    teng.stop()


# --- mask automata --------------------------------------------------------

PATTERNS = [("regex", "5 ( 7 | 9 ) + 11"), ("regex", "[ 1 2 3 ] * 4 . ?"),
            ("regex", "[^ 0 1 ] 3"), ("regex", "( 5 | 6 ) *"),
            ("regex", "( 5 | 9 | 13 ) + 2"),
            ("one_of", [[8, 9, 10], [8, 6], [3]])]


def _walk(auto, vocab=16, depth=4):
    """Allowed set and accepting flag of every state reached by every
    token path of up to ``depth`` steps, in a fixed order."""
    out, frontier = [], [((), auto.start)]
    for _ in range(depth):
        nxt = []
        for path, s in frontier:
            allowed = auto.allowed(s, vocab)
            out.append((path, tuple(np.nonzero(allowed)[0]),
                        bool(auto.accepting(s))))
            for t in np.nonzero(allowed)[0][:3]:
                ns = auto.step(s, int(t))
                if ns is not None:
                    nxt.append((path + (int(t),), ns))
        frontier = nxt
    return out


@pytest.mark.parametrize("kind,pattern", PATTERNS)
def test_mask_allowed_sets_equal_jax(kind, pattern):
    mk = {"regex": "regex", "one_of": "one_of"}[kind]
    jspec = getattr(jw.TokenMaskSpec, mk)(pattern)
    tspec = getattr(tw.TokenMaskSpec, mk)(pattern)
    assert tspec.to_dict() == jspec.to_dict()
    assert _walk(tspec.compile()) == _walk(jspec.compile())
    again = tw.TokenMaskSpec.from_dict(jspec.to_dict()).compile()
    assert _walk(again) == _walk(jspec.compile())


@pytest.mark.parametrize("pattern", ["5 ( 7", "* 5", "( )", "[ 3"])
def test_mask_malformed_refused_like_jax(pattern):
    with pytest.raises(jw.MaskError) as je:
        jw.TokenMaskSpec.regex(pattern).compile()
    with pytest.raises(tw.MaskError) as te:
        tw.TokenMaskSpec.regex(pattern).compile()
    assert str(te.value) == str(je.value)


# --- constrained decode ----------------------------------------------------

@pytest.mark.parametrize("gen", [
    dict(pattern="5 ( 7 | 9 ) 11", max_new_tokens=8),
    dict(pattern="( 5 | 9 | 13 ) + 2", max_new_tokens=6, temperature=0.9,
         top_k=8, seed=123),
    dict(pattern="[ 20 21 22 23 ] *", max_new_tokens=5)])
def test_constrained_tokens_equal_jax(engines, gen):
    jeng, teng = engines
    gen = dict(gen)
    pattern = gen.pop("pattern")
    mask = tw.TokenMaskSpec.regex(pattern)
    m0 = torch_metrics.counter("serving.decode.masked_tokens").value()
    got = teng.generate([4, 9, 1], mask=mask, **gen)
    ref = jeng.generate([4, 9, 1], mask=mask.to_dict(), **gen)
    assert got["tokens"] == ref["tokens"]
    auto = mask.compile()
    s = auto.start
    for t in got["tokens"]:
        assert auto.allowed(s, 64)[t]
        s = auto.step(s, t)
    # finished by max_new or because the automaton has no transition
    assert len(got["tokens"]) == gen["max_new_tokens"] or \
        not auto.allowed(s, 64).any()
    assert torch_metrics.counter("serving.decode.masked_tokens").value() \
        - m0 == len(got["tokens"])
    assert teng.cache.allocator.pages_used == 0


def test_constrained_submit_validation(engines):
    _, teng = engines
    with pytest.raises(ValueError, match="outside this decoder"):
        teng.generate([1], max_new_tokens=2,
                      mask=tw.TokenMaskSpec.regex("99"))
    empty = "[^ " + " ".join(str(i) for i in range(64)) + " ]"
    with pytest.raises(ValueError, match="no first token"):
        teng.generate([1], max_new_tokens=2,
                      mask=tw.TokenMaskSpec.regex(empty))
    with pytest.raises(ValueError, match="mask must be"):
        teng.generate([1], max_new_tokens=2, mask=42)


# --- embeddings --------------------------------------------------------------

def test_embed_agrees_with_jax(engines):
    jeng, teng = engines
    prompt = [int(t) for t in np.random.RandomState(4).randint(0, 64, 21)]
    got = teng.embed(prompt)
    ref = jeng.embed(prompt)
    assert len(got["embedding"]) == 32 and len(got["logprobs"]) == 20
    assert got["steps"] == ref["steps"] == 3       # ceil(21 / 8)
    np.testing.assert_allclose(got["embedding"], ref["embedding"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["logprobs"], ref["logprobs"],
                               rtol=1e-5, atol=1e-6)
    assert teng.cache.allocator.pages_used == 0
    with pytest.raises(ServingError, match="embeddings=True"):
        td.DecodeEngine(td.DecoderSpec(**SPEC), device="cpu",
                        warm=False).embed([1, 2])


def test_embed_chunk_invariant_and_zero_decode_slots(engines):
    """The pooled embedding does not depend on how prefill was chunked,
    and an embed churn never occupies a decode slot (gauge sampled
    DURING the churn)."""
    _, teng = engines
    prompt = list(range(2, 18))
    e4 = _engine(td, "wl-c4", prefill_chunk=4, slots=[1])
    try:
        a = teng.embed(prompt)
        b = e4.embed(prompt)
    finally:
        e4.stop()
    np.testing.assert_allclose(a["embedding"], b["embedding"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(a["logprobs"], b["logprobs"],
                               rtol=1e-5, atol=1e-6)
    assert a["steps"] == 2 and b["steps"] == 4

    live = torch_metrics.gauge("serving.decode.live_slots.wl-torch.v1")
    seen, stop = [], threading.Event()

    def probe():
        while not stop.is_set():
            seen.append(live.value())
            time.sleep(0.001)

    t = threading.Thread(target=probe)
    t.start()
    reqs = [teng.submit_embed(prompt[:4 + i]) for i in range(8)]
    assert all(r.ev.wait(120) and r.error is None for r in reqs)
    stop.set()
    t.join(timeout=5)
    assert not t.is_alive()
    assert seen and max(seen) == 0
    assert teng.cache.allocator.pages_used == 0


# --- beam --------------------------------------------------------------------

def test_beam_equals_jax_and_independent_decodes(engines):
    jeng, teng = engines
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5]
    got = tw.beam_search(teng, prompt, k=3, max_new_tokens=5)
    ref = jw.beam_search(jeng, prompt, k=3, max_new_tokens=5)
    for key in ("beams", "cached_tokens", "shared_prompt_pages"):
        assert got[key] == ref[key], key
    assert got["shared_prompt_pages"] > 0
    assert len({tuple(b) for b in got["beams"]}) == 3
    assert teng.cache.allocator.pages_used == 0
    # page sharing is invisible to the numerics: each beam equals an
    # independent decode of prompt + [head] on an engine without a
    # prefix cache
    cold = _engine(td, "wl-cold", prefix_cache=False, embeddings=False)
    try:
        for b in got["beams"]:
            assert cold.generate(prompt + [b[0]],
                                 max_new_tokens=4)["tokens"] == b[1:]
        with pytest.raises(ServingError, match="prefix cache"):
            tw.beam_search(cold, prompt, k=2, max_new_tokens=3)
    finally:
        cold.stop()


# --- dispatch ----------------------------------------------------------------

@pytest.mark.parametrize("wire", [
    {"kind": "beam", "prompt": [1, 2], "k": 2},
    {"prompt": [1]},
    {"kind": "classify", "prompt": [1]},
    {"kind": "embed", "prompt": [1], "seed": 3},
    {"kind": "generate"},
    [1, 2],
    {"kind": "beam", "prompt": [1], "k": 0},
    {"kind": "constrained", "prompt": [1], "mask": {"kind": "regex",
                                                    "pattern": "1",
                                                    "bogus": True}}])
def test_parse_workload_strict_like_jax(wire):
    try:
        ref = jw.parse_workload(wire)
    except ValueError as e:
        with pytest.raises(ValueError) as te:
            tw.parse_workload(wire)
        assert str(te.value) == str(e)
        return
    got = tw.parse_workload(wire)
    assert got.to_dict() == ref.to_dict()
    assert tw.parse_workload(got.to_dict()).to_dict() == got.to_dict()


def test_workload_rpc_and_dedup_answers_a_retransmit():
    srv = ServingServer(device="cpu")
    cli = ServingClient(srv.serve())
    try:
        cli.load_decoder("wl", SPEC, **ENGINE_KW)
        gen = cli.workload("wl", {"kind": "generate", "prompt": [4, 9, 1],
                                  "max_new_tokens": 4})
        assert gen["kind"] == "generate" and len(gen["tokens"]) == 4
        con = cli.constrained("wl", [4, 9, 1],
                              tw.TokenMaskSpec.regex("5 ( 7 | 9 ) 11"))
        assert con["kind"] == "constrained" and con["tokens"][0] == 5
        with pytest.raises(ValueError, match="unknown workload kind"):
            cli.workload("wl", {"kind": "classify", "prompt": [1]})
        # a lost embed reply: the retransmit is answered from the dedup
        # cache, the prefill ran once
        c = {k: torch_metrics.counter(k).value() for k in (
            "rpc.server.dedup_hits", "serving.decode.embed.steps",
            "serving.workload.embed.requests")}
        with torch_faults.scoped("drop@recv.workload:0") as plan:
            emb = cli.embed("wl", list(range(1, 17)))
        assert [(k, s) for k, s, _i in plan.injected()] == \
            [("drop", "recv.workload")]
        d = {k: torch_metrics.counter(k).value() - v for k, v in c.items()}
        assert d == {"rpc.server.dedup_hits": 1,
                     "serving.decode.embed.steps": 2,     # ceil(16 / 8)
                     "serving.workload.embed.requests": 1}
        assert len(emb["embedding"]) == 32
        beam = cli.beam("wl", [3, 1, 4, 1, 5, 9, 2, 6, 5], k=2,
                        max_new_tokens=3)
        assert len(beam["beams"]) == 2 and beam["shared_prompt_pages"] > 0
        assert cli.list_models()["wl"]["kv"]["pages_used"] == 0
    finally:
        cli.close()
        srv.shutdown()
