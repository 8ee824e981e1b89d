"""The port's autotune layer (paddle_tpu_torch/autotune) against the JAX
package's (paddle_tpu/autotune), on the CPU, on the same seeded inputs:

  - derive_ladder and expected_padding_waste EQUAL on seeded histograms
    (the ladder DP is copied pure Python: exact equality, no tolerance);
  - the cache file BYTE-EQUAL after the same puts and timings with
    ``device=`` given; the corrupt-file and the crash-between-write-and-
    rename paths as the JAX cache's;
  - resolve_ladder's cache -> histogram -> default order, with the same
    answers and the same cache records;
  - measure_or_model: the same choice and the same repeat-session skip;
  - jit_cost flops (and transcendentals) EQUAL to XLA's cost_analysis on
    matmul + elementwise functions; bytes equal where the function has
    no scalar constant, and within [0.8, 1] of XLA's where XLA also
    counts the broadcast of one (BYTES_SCALAR_FLOOR);
  - buckets="auto" / slots="auto": the port's engines resolve the JAX
    engines' ladders from the same observed traffic; prefill_chunk reads
    through the cache; the executor logs steady-state step timings;
  - the CLI selftest (``--selftest --device cpu``).
"""
import json
import os

import numpy as np
import pytest
import torch

from paddle_tpu import autotune as jat
from paddle_tpu.distributed import faults as jfaults
from paddle_tpu.fluid.flags import FLAGS as JFLAGS
from paddle_tpu_torch import autotune as tat
from paddle_tpu_torch.distributed import faults as tfaults
from paddle_tpu_torch.flags import FLAGS as TFLAGS
from paddle_tpu_torch.observability import metrics as tmetrics

# where XLA also counts a broadcast scalar constant, the eager op's bytes
# are at least this share of XLA's (and never more)
BYTES_SCALAR_FLOOR = 0.8


def _hist(seed):
    """A lumpy request-size histogram: a few heavy sizes and a tail."""
    rng = np.random.RandomState(seed)
    sizes = rng.choice(np.arange(1, 65), size=rng.randint(3, 12),
                       replace=False)
    return {int(s): int(rng.randint(1, 200)) for s in sizes}


@pytest.mark.parametrize("seed", range(8))
def test_derive_ladder_and_waste_equal_jax(seed):
    hist = _hist(seed)
    for k in (1, 2, 3, 5, 8):
        for cov in (0.9, 0.99, 1.0):
            lad = tat.derive_ladder(hist, max_buckets=k, coverage=cov)
            assert lad == jat.derive_ladder(hist, max_buckets=k,
                                            coverage=cov)
            assert tat.expected_padding_waste(hist, lad) == \
                jat.expected_padding_waste(hist, lad)
    static = [1, 2, 4, 8, 16, 32, 64]
    assert tat.expected_padding_waste(hist, static) == \
        jat.expected_padding_waste(hist, static)
    assert tat.percentile_size(hist, 0.5) == jat.percentile_size(hist, 0.5)


def test_derive_ladder_compressed_histogram_equal_jax():
    """Above 512 distinct sizes both thin the histogram the same way."""
    rng = np.random.RandomState(5)
    hist = {int(s): int(c) for s, c in zip(
        rng.choice(np.arange(1, 4000), 900, replace=False),
        rng.randint(1, 50, 900))}
    lad = tat.derive_ladder(hist, max_buckets=6)
    assert lad == jat.derive_ladder(hist, max_buckets=6)
    assert lad[-1] == max(hist)


def _same_puts(mod, dirname):
    c = mod.TuningCache(dirname)
    c.put("prefill_chunk", 32, source="measured", device="card_a")
    c.put("serving_buckets", [1, 3, 6], shape_key="ladder",
          source="derived", device="card_a",
          extra={"observations": 211, "expected_waste": 0.0123})
    c.put("decode_slots", [2, 5], shape_key="ladder", source="derived",
          device="cpu")
    for ms in (1.5, 2.5, 0.75, 3.0):
        c.note_timing("executor.step", "abc|x:float32(4, 8)", ms,
                      device="card_a")
    assert c.flush()
    return c


def test_cache_json_byte_equal_jax(tmp_path):
    a, b = tmp_path / "torch", tmp_path / "jax"
    tc = _same_puts(tat, str(a))
    _same_puts(jat, str(b))
    got = (a / tat.CACHE_FILENAME).read_bytes()
    assert got == (b / jat.CACHE_FILENAME).read_bytes()
    # each package reads the other's file
    assert jat.TuningCache(str(a)).lookup(
        "serving_buckets", shape_key="ladder", device="card_a") == [1, 3, 6]
    assert tat.TuningCache(str(b)).timing(
        "executor.step", "abc|x:float32(4, 8)", device="card_a")["n"] == 4
    assert tc.stats() == {"dirname": str(a), "device_kinds":
                          ["card_a", "cpu"], "entries": 4}


def test_cache_corrupt_and_crash_between_write_and_rename(tmp_path):
    corrupt = tmetrics.counter("autotune.cache.corrupt")
    path = tmp_path / tat.CACHE_FILENAME
    path.write_text('{"schema": 1, "entries": {"cpu": ')  # torn JSON
    c0 = corrupt.value()
    c = tat.TuningCache(str(tmp_path))
    assert corrupt.value() == c0 + 1
    assert c.lookup("prefill_chunk", default=16, device="cpu") == 16
    c.put("prefill_chunk", 8, device="cpu")
    assert c.flush()
    assert tat.TuningCache(str(tmp_path)).lookup(
        "prefill_chunk", device="cpu") == 8
    # a crash between the tmp write and the rename keeps the old file
    # and the cache dirty, in both packages
    for mod, faults, d in ((tat, tfaults, tmp_path / "t"),
                           (jat, jfaults, tmp_path / "j")):
        c = mod.TuningCache(str(d))
        c.put("prefill_chunk", 4, device="cpu")
        assert c.flush()
        c.put("prefill_chunk", 64, device="cpu")
        with faults.scoped("crash@autotune.save:0"):
            with pytest.raises(Exception):
                c.flush()
        assert mod.TuningCache(str(d)).lookup(
            "prefill_chunk", device="cpu") == 4
        assert c.flush()  # still dirty: the retry writes everything
        assert mod.TuningCache(str(d)).lookup(
            "prefill_chunk", device="cpu") == 64


def test_resolve_ladder_order_equal_jax():
    """cache -> histogram -> default, the same answers and records."""
    default = [1, 2, 4, 8, 16]
    rng = np.random.RandomState(3)
    traffic = [int(x) for x in rng.choice([1, 3, 3, 6, 6, 6, 11], 80)]
    results = []
    for mod in (tat, jat):
        mod.reset_histograms()
        c = mod.TuningCache()
        mod.observe("t_buckets", 3)
        few = mod.resolve_ladder("t_buckets", default, cache=c)
        for v in traffic:
            mod.observe("t_buckets", v)
        derived = mod.resolve_ladder("t_buckets", default, max_buckets=3,
                                     cache=c)
        mod.reset_histograms()
        cached = mod.resolve_ladder("t_buckets", default, cache=c)
        results.append((few, derived, cached,
                        c.entries()[mod.device_kind()]))
        mod.reset_histograms()
    (tf, td, tc, trec), (jf, jd, jc, jrec) = results
    assert tf == jf == default
    assert td == jd == tc == jc and td != default and len(td) <= 3
    assert trec == jrec


def test_merge_observed_and_seed_cache_equal_jax(tmp_path):
    saved = {"2": 40, "5": 30, "7": 12, "16": 1}
    out = []
    for mod, d in ((tat, tmp_path / "t"), (jat, tmp_path / "j")):
        mod.reset_histograms()
        mod.merge_observed("serving_buckets", saved)
        c = mod.TuningCache(str(d))
        out.append(mod.seed_cache_from_observed(max_buckets=3, cache=c))
        mod.reset_histograms()
    assert out[0] == out[1] and out[0]["serving_buckets"][-1] == 16
    assert (tmp_path / "t" / tat.CACHE_FILENAME).read_bytes() == \
        (tmp_path / "j" / jat.CACHE_FILENAME).read_bytes()


def test_measure_or_model_same_choice_and_repeat_skip(tmp_path):
    costs = {1: {"flops": 100.0, "bytes accessed": 10.0},
             (2, 3): {"flops": 10.0, "bytes accessed": 5.0}}
    for mod in (tat, jat):
        c = mod.TuningCache(str(tmp_path / mod.__name__))
        runs = {"a": 0, "b": 0}

        def runner(cand):
            runs[cand] += 1
            if cand == "b":
                sum(range(200000))  # measurably slower

        best, ev = mod.measure_or_model("toy", ["a", "b"], runner=runner,
                                        k=3, cache=c)
        assert (best, ev["source"], runs) == ("a", "measured",
                                              {"a": 4, "b": 4})
        best2, ev2 = mod.measure_or_model("toy", ["a", "b"], runner=runner,
                                          k=3, cache=c)
        assert (best2, ev2["source"], runs) == ("a", "cache",
                                                {"a": 4, "b": 4})
        bm, evm = mod.measure_or_model(
            "toy_model", [1, (2, 3)], cost_fn=lambda k: costs[k], cache=c)
        assert bm == (2, 3) and evm["source"] == "model"
        c.flush()
        # a repeat SESSION: the persisted list matches the tuple
        again = mod.TuningCache(str(tmp_path / mod.__name__))
        b3, ev3 = mod.measure_or_model(
            "toy_model", [1, (2, 3)],
            cost_fn=lambda k: pytest.fail("must not model"), cache=again)
        assert b3 == (2, 3) and ev3["source"] == "cache"


def _jax_fns():
    import jax
    import jax.numpy as jnp

    return {
        "matmul": lambda a, b, c: a @ b,
        "matmul_add": lambda a, b, c: a @ b + c,
        "matmul_mul_sub": lambda a, b, c: (a @ b) * c - c,
        "tanh_scale_add": lambda a, b, c: jnp.tanh(a @ b) * 2.0 + c,
        "relu": lambda a, b, c: jax.nn.relu(a @ b + c),
    }


TORCH_FNS = {
    "matmul": lambda a, b, c: a @ b,
    "matmul_add": lambda a, b, c: a @ b + c,
    "matmul_mul_sub": lambda a, b, c: (a @ b) * c - c,
    "tanh_scale_add": lambda a, b, c: torch.tanh(a @ b) * 2.0 + c,
    "relu": lambda a, b, c: torch.relu(a @ b + c),
}
SCALAR_CONSTANT = {"tanh_scale_add", "relu"}


@pytest.mark.parametrize("name", sorted(TORCH_FNS))
def test_jit_cost_flops_equal_xla(name):
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    a, b, c = (rng.randn(*s).astype(np.float32)
               for s in ((16, 32), (32, 8), (16, 8)))
    want = jat.jit_cost(_jax_fns()[name], jnp.asarray(a), jnp.asarray(b),
                        jnp.asarray(c))
    got = tat.jit_cost(TORCH_FNS[name], torch.from_numpy(a),
                       torch.from_numpy(b), torch.from_numpy(c))
    assert got["flops"] == want["flops"]
    assert got["transcendentals"] == want.get("transcendentals", 0.0)
    if name in SCALAR_CONSTANT:
        assert BYTES_SCALAR_FLOOR * want["bytes accessed"] <= \
            got["bytes accessed"] <= want["bytes accessed"]
    else:
        assert got["bytes accessed"] == want["bytes accessed"]


def test_model_fallback_picks_the_cheaper_torch_function():
    x = torch.ones(16, 16)

    def deep(a):
        for _ in range(6):
            a = a @ a
        return a

    best, ev = tat.measure_or_model(
        "depth", ["shallow", "deep"],
        cost_fn=lambda k: tat.jit_cost(
            (lambda a: a @ a) if k == "shallow" else deep, x),
        cache=tat.TuningCache())
    assert best == "shallow" and ev["scores"]["deep"] > \
        ev["scores"]["shallow"]


def test_auto_buckets_resolve_the_jax_engines_ladder(tmp_path):
    """The same skewed traffic through both packages' InferenceEngines
    (the submit path records each request's rows), then a buckets="auto"
    engine in each: the same derived ladder."""
    from paddle_tpu.serving.__main__ import make_model_dir
    from paddle_tpu.serving.engine import InferenceEngine as JEngine
    from paddle_tpu_torch.serving.engine import InferenceEngine as TEngine

    d, _probe, _ref = make_model_dir(str(tmp_path / "m"))
    rng = np.random.RandomState(4)
    sizes = [int(s) for s in rng.choice([1, 3, 3, 5, 5, 5, 6, 13], 48)]
    ladders = []
    for mod, make in (
            (tat, lambda b: TEngine.from_inference_dir(
                d, buckets=b, max_wait_ms=0.0, device="cpu")),
            (jat, lambda b: JEngine.from_inference_dir(
                d, buckets=b, max_wait_ms=0.0))):
        mod.reset_histograms()
        with mod.scoped():
            eng = make([1, 2, 4, 8, 16])
            try:
                for n in sizes:
                    eng.infer({"x": np.ones((n, 8), np.float32)})
            finally:
                eng.stop()
            auto = make("auto")
            ladders.append(list(auto.buckets))
            auto.stop()
        mod.reset_histograms()
    assert ladders[0] == ladders[1] != [1, 2, 4, 8, 16]
    assert ladders[0][-1] == 13


def test_auto_slots_and_prefill_chunk_resolve_like_jax():
    """slots="auto" from the same observed slot demand, and a
    prefill_chunk override read through the cache, in both decode
    engines."""
    from paddle_tpu.serving import decode as jd
    from paddle_tpu_torch.serving import decode as td

    spec = dict(vocab=32, d_model=16, n_layers=1, n_heads=2, n_kv_heads=1,
                seed=3)
    demand = {1: 10, 2: 6, 3: 25, 6: 9}
    got = []
    for mod, dec, kw in ((tat, td, {"device": "cpu"}), (jat, jd, {})):
        mod.reset_histograms()
        mod.merge_observed("decode_slots", demand)
        with mod.scoped() as cache:
            cache.put("prefill_chunk", 4, source="override")
            eng = dec.DecodeEngine(dec.DecoderSpec(**spec), slots="auto",
                                   page_size=4, num_pages=16,
                                   max_seq_len=16, warm=False, **kw)
            st = eng.stats()
            got.append((list(st["slots"]), st["prefill_chunk"]))
            eng.stop()
        mod.reset_histograms()
    assert got[0] == got[1] and got[0][1] == 4
    assert got[0][0][-1] == 6


def test_effective_flag_reads_through_the_cache_per_device_kind():
    from paddle_tpu_torch.flags import effective_flag

    hits = tmetrics.counter("autotune.cache.hits")
    misses = tmetrics.counter("autotune.cache.misses")
    with tat.scoped(enable=True) as cache:
        h0, m0 = hits.value(), misses.value()
        assert effective_flag("prefill_chunk") == TFLAGS["prefill_chunk"]
        assert misses.value() == m0 + 1
        cache.put("prefill_chunk", 128, device="another_card")
        assert effective_flag("prefill_chunk") == TFLAGS["prefill_chunk"]
        cache.put("prefill_chunk", 32, device=tat.device_kind())
        assert effective_flag("prefill_chunk") == 32
        assert hits.value() == h0 + 1
    assert effective_flag("prefill_chunk") == TFLAGS["prefill_chunk"]
    assert tat.device_kind() == "cpu"  # this machine has no card
    assert set(k for k in JFLAGS if k.startswith(("autotune", "fleet_"))) \
        <= set(TFLAGS)
    for k in TFLAGS:
        if k.startswith("fleet_"):
            assert TFLAGS[k] == JFLAGS[k], k


def test_executor_logs_steady_state_step_timings():
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import layers, unique_name

    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data(name="x", shape=[4], dtype="float32")
        y = layers.fc(input=x, size=3)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.ones((2, 4), np.float32)}
    with tat.scoped(enable=True) as cache:
        for _ in range(3):
            exe.run(main, feed=feed, fetch_list=[y], scope=scope)
        exe.run(main, feed=feed, fetch_list=[y], scope=scope,
                return_numpy=False)
        key = tat.step_shape_key(main, feed)
        rec = cache.timing("executor.step", key)
        # the plan-building first run and the return_numpy=False run
        # are not logged
        assert rec is not None and rec["n"] == 2, rec
        assert tat.cached_step_ms("executor.step", main, feed) == \
            rec["median_ms"]
    # a torch feed of the same dtype and shape shares the key
    assert tat.step_shape_key(main, {"x": torch.ones(2, 4)}) == key


def test_autotune_selftest_cli(capsys):
    from paddle_tpu_torch.autotune.__main__ import main

    assert main(["--selftest", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "10 cases on cpu, all ok" in out
    assert main(["--dump"]) == 0
    dump = json.loads(capsys.readouterr().out)
    assert set(dump) == {"cache", "entries", "histograms"}


def test_autotune_selftest_without_a_card_raises(monkeypatch):
    from paddle_tpu_torch.autotune.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--selftest"])


def test_autotune_dir_flag_seeds_the_process_cache(tmp_path, monkeypatch):
    monkeypatch.setitem(TFLAGS, "autotune_dir", str(tmp_path))
    tat.reset_cache()
    try:
        c = tat.get_cache()
        assert c.dirname == str(tmp_path) and c is tat.get_cache()
        c.put("prefill_chunk", 8)
        assert c.flush() == os.path.join(str(tmp_path), tat.CACHE_FILENAME)
    finally:
        tat.reset_cache()
