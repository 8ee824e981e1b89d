"""CLI driver for the autotune subsystem — the counterpart of
``python -m paddle_tpu.autotune``.

    python -m paddle_tpu_torch.autotune --selftest [--device cpu]
        In-process proof (no datasets): ladder-derivation properties
        (P99 coverage, waste monotone in bucket budget, determinism,
        beats the static default on skewed traffic), cache round-trip
        through a real directory, corrupt-file degradation,
        measure-then-skip (a second session answers from the cache with
        ZERO new timed runs), the cost-model fallback, ``jit_cost`` on
        meta tensors, the per-device-kind knob read-through of
        ``prefill_chunk``, and a measurement of two candidates on
        ``--device`` (default: the card; raises without one). Exit
        non-zero on any failure.

    python -m paddle_tpu_torch.autotune --dump
        Print the live tuning cache (FLAGS['autotune_dir'] /
        PADDLE_TPU_AUTOTUNE_DIR) and every recorded shape histogram as
        JSON — the operator's view of what the tuner knows.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


# --- selftest cases -----------------------------------------------------

def case_ladder_properties():
    from . import derive_ladder, expected_padding_waste, percentile_size

    hist = {1: 120, 2: 40, 3: 25, 6: 30, 7: 22, 13: 4, 16: 1}
    lad = derive_ladder(hist, max_buckets=5)
    assert lad == sorted(set(lad)) and lad[0] >= 1, lad
    assert lad[-1] >= percentile_size(hist, 0.99), (lad, hist)
    assert lad[-1] >= max(hist), "top bucket must keep the max admissible"
    assert derive_ladder(hist, max_buckets=5) == lad, "must be pure"
    wastes = [expected_padding_waste(hist, derive_ladder(hist, k))
              for k in (1, 2, 3, 4, 5, 6)]
    for a, b in zip(wastes, wastes[1:]):
        assert b <= a + 1e-12, f"waste not monotone in buckets: {wastes}"


def case_ladder_beats_static():
    from . import derive_ladder, expected_padding_waste

    # lumpy traffic the geometric default fits badly: 5s pad to 8,
    # 6s pad to 8, 3s pad to 4
    hist = {1: 50, 3: 30, 5: 60, 6: 40, 16: 2}
    static = [1, 2, 4, 8, 16]
    derived = derive_ladder(hist, max_buckets=5)
    w_static = expected_padding_waste(hist, static)
    w_derived = expected_padding_waste(hist, derived)
    assert w_derived < w_static, (w_derived, w_static, derived)


def case_cache_roundtrip():
    from . import TuningCache

    with tempfile.TemporaryDirectory() as tmp:
        c = TuningCache(tmp)
        c.put("prefill_chunk", 2048, source="measured")
        c.put("serving_buckets", [1, 3, 6], shape_key="ladder",
              source="derived")
        c.note_timing("executor.step", "abc|x:f32(4,8)", 1.5)
        c.note_timing("executor.step", "abc|x:f32(4,8)", 2.5)
        assert c.flush(), "flush must write when dirty"
        c2 = TuningCache(tmp)
        assert c2.lookup("prefill_chunk", default=-1) == 2048
        assert c2.lookup("serving_buckets", shape_key="ladder") == [1, 3, 6]
        t = c2.timing("executor.step", "abc|x:f32(4,8)")
        assert t and t["n"] == 2 and abs(t["median_ms"] - 2.0) < 1e-9, t


def case_cache_corrupt_degrades():
    from . import CACHE_FILENAME, TuningCache

    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, CACHE_FILENAME), "w") as f:
            f.write('{"schema": 1, "entries": {"cpu": ')  # torn JSON
        c = TuningCache(tmp)  # must not raise
        assert c.lookup("prefill_chunk", default=3072) == 3072
        c.put("prefill_chunk", 99)
        assert c.flush(), "a corrupt file must still be replaceable"
        assert TuningCache(tmp).lookup("prefill_chunk") == 99


def case_measure_then_skip():
    from . import TuningCache, measure_or_model
    from ..observability import metrics

    c = TuningCache()
    runs = {"a": 0, "b": 0}

    def runner(cand):
        runs[cand] += 1
        if cand == "b":  # 'b' is measurably slower
            sum(range(20000))

    best, ev = measure_or_model("toy_knob", ["a", "b"], runner=runner,
                                k=3, cache=c)
    assert best == "a" and ev["source"] == "measured", ev
    assert runs["a"] == 4 and runs["b"] == 4  # warmup + k each
    m0 = metrics.counter("autotune.measurements").value()
    best2, ev2 = measure_or_model("toy_knob", ["a", "b"], runner=runner,
                                  k=3, cache=c)
    assert best2 == "a" and ev2["source"] == "cache", ev2
    assert runs["a"] == 4 and runs["b"] == 4, "repeat must not re-run"
    assert metrics.counter("autotune.measurements").value() == m0


def case_model_fallback():
    from . import TuningCache, measure_or_model

    c = TuningCache()
    costs = {1: {"flops": 100.0, "bytes accessed": 10.0},
             2: {"flops": 10.0, "bytes accessed": 5.0}}
    best, ev = measure_or_model("toy_model_knob", [1, 2],
                                cost_fn=lambda cand: costs[cand], cache=c)
    assert best == 2 and ev["source"] == "model", ev
    assert c.lookup("toy_model_knob") == 2


def case_jit_cost_model():
    """The zero-run path end-to-end: count real torch callables on meta
    tensors, pick the structurally cheaper one."""
    import torch

    from . import TuningCache, jit_cost, measure_or_model

    x = torch.ones((16, 16), dtype=torch.float32)

    def shallow(a):
        return a @ a

    def deep(a):
        for _ in range(6):
            a = a @ a
        return a

    cost = jit_cost(shallow, x)
    assert float(cost.get("flops") or 0) == 2 * 16 ** 3, cost
    best, ev = measure_or_model(
        "matmul_depth", ["shallow", "deep"],
        cost_fn=lambda cand: jit_cost(
            shallow if cand == "shallow" else deep, x),
        cache=TuningCache())
    assert best == "shallow" and ev["source"] == "model", ev


def case_knob_read_through():
    """The JAX selftest tunes its attention routing threshold; the port
    has none, so the knob here is ``prefill_chunk`` (the decode
    engine's chunked-prefill width, read through effective_flag)."""
    from . import device_kind, scoped
    from ..flags import FLAGS, effective_flag
    from ..observability import metrics

    hits = metrics.counter("autotune.cache.hits")
    misses = metrics.counter("autotune.cache.misses")
    with scoped(enable=True) as cache:
        m0, h0 = misses.value(), hits.value()
        # cold cache: the FLAGS constant is the default
        assert effective_flag("prefill_chunk") == FLAGS["prefill_chunk"]
        assert misses.value() == m0 + 1
        # an override for ANOTHER device kind must not apply here
        cache.put("prefill_chunk", 128, device="some_other_card",
                  source="override")
        assert effective_flag("prefill_chunk") == FLAGS["prefill_chunk"]
        # ... but one for THIS kind wins
        cache.put("prefill_chunk", 32, device=device_kind(),
                  source="override")
        assert effective_flag("prefill_chunk") == 32
        assert hits.value() == h0 + 1
    # autotune off: the constant again, no cache consulted
    m1 = misses.value()
    assert effective_flag("prefill_chunk") == FLAGS["prefill_chunk"]
    assert misses.value() == m1


def case_resolve_ladder_end_to_end():
    from . import (histogram, observe, reset_histograms, resolve_ladder,
                   scoped)

    with scoped(enable=True) as cache:
        reset_histograms()
        default = [1, 2, 4, 8, 16]
        # too few observations: the static default
        observe("selftest_buckets", 3)
        assert resolve_ladder("selftest_buckets", default,
                              min_observations=32) == default
        for size, count in {1: 40, 3: 25, 6: 20}.items():
            for _ in range(count):
                observe("selftest_buckets", size)
        lad = resolve_ladder("selftest_buckets", default,
                             min_observations=32)
        assert lad != default and lad[-1] == 6, lad
        # the derivation was cached: a fresh resolve with an EMPTY
        # histogram still answers the derived ladder
        reset_histograms()
        assert resolve_ladder("selftest_buckets", default,
                              min_observations=32) == lad
        assert cache.lookup("selftest_buckets", shape_key="ladder",
                            count=False) == lad
    reset_histograms()


def case_measure_on_device(device):
    """Two candidates timed on ``device`` (a CUDA-synced wall clock on
    a card): the decision is the faster median and lands in the cache
    under this device kind (which one wins is the clock's answer: a
    busy host can slow any run)."""
    import torch

    from . import TuningCache, device_kind, measure_or_model

    x = torch.randn(128, 128, device=device) / 128.0

    def runner(n):
        y = x
        for _ in range(n):
            y = y @ x
        return y

    c = TuningCache()
    best, ev = measure_or_model("selftest_matmuls", [1, 64], runner=runner,
                                k=5, cache=c)
    scores = ev["scores"]
    assert ev["source"] == "measured" and min(scores.values()) > 0, ev
    assert scores[str(best)] == min(scores.values()), ev
    assert c.lookup("selftest_matmuls", device=device_kind()) == best


CASES = [
    ("ladder_properties", case_ladder_properties),
    ("ladder_beats_static", case_ladder_beats_static),
    ("cache_roundtrip", case_cache_roundtrip),
    ("cache_corrupt_degrades", case_cache_corrupt_degrades),
    ("measure_then_skip", case_measure_then_skip),
    ("model_fallback", case_model_fallback),
    ("jit_cost_model", case_jit_cost_model),
    ("knob_read_through", case_knob_read_through),
    ("resolve_ladder_end_to_end", case_resolve_ladder_end_to_end),
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m paddle_tpu_torch.autotune")
    ap.add_argument("--selftest", action="store_true",
                    help="run the in-process proof suite")
    ap.add_argument("--dump", action="store_true",
                    help="print the live cache + shape histograms as "
                         "JSON")
    ap.add_argument("--device", default=None,
                    help="device of the measurement case (default: the "
                         "card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    if args.dump:
        from . import get_cache, histograms

        cache = get_cache()
        print(json.dumps({
            "cache": cache.stats(),
            "entries": cache.entries(),
            "histograms": histograms(),
        }, indent=2, sort_keys=True))
        return 0

    if not args.selftest:
        ap.print_help()
        return 2

    from ..device import resolve_device

    device = resolve_device(args.device)
    cases = CASES + [("measure_on_device",
                      lambda: case_measure_on_device(device))]
    failed = 0
    for name, fn in cases:
        try:
            fn()
        except BaseException as e:
            failed += 1
            print(f"  {name}: FAILED — {type(e).__name__}: {e}")
        else:
            print(f"  {name}: ok")
    print(f"autotune selftest: {len(cases)} cases on {device}, "
          f"{'all ok' if not failed else f'{failed} FAILED'}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
