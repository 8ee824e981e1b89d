"""paddle_tpu_torch.autotune — the counterpart of ``paddle_tpu.autotune``:
cost-model-driven autotuning.

Turns the measurement substrate the port already has (the zero-run cost
of a torch function, request shapes flowing through serving, step wall
times) into DECISIONS:

  - a persistent **tuning cache** keyed ``(device_kind, tunable_id,
    shape_key)`` (cache.py — atomic JSON under
    ``PADDLE_TPU_AUTOTUNE_DIR``, the JAX package's file format; corrupt
    files degrade to defaults);
  - a **measure-or-model engine** (measure.py — median-of-k timed runs
    ending in a CUDA sync when a runner exists, the ``CostProbe`` count
    of a meta-tensor run as the zero-run fallback, repeat sessions
    answered from the cache);
  - a **shape-histogram recorder + ladder deriver** (ladder.py —
    observed request-size distributions become ``buckets="auto"`` /
    ``slots="auto"`` serving ladders that minimize expected padding
    waste).

Consumers: ``flags.effective_flag`` reads a tunable knob
(``prefill_chunk``, ``spec_k``) through the cache when
``FLAGS['autotune']`` is on; the serving engines resolve ``"auto"``
ladders at load; the executor logs per-shape step timings under
``FLAGS['autotune']``. The histogram recorder is always on. The JAX
package also tunes its attention routing thresholds (``flash_min_seq``,
``paged_min_slots``); the port has no routing thresholds — a kernel
wrapper routes on its tensor's device alone.

    python -m paddle_tpu_torch.autotune --selftest --device cpu
    python -m paddle_tpu_torch.autotune --dump
"""
from .cache import (CACHE_FILENAME, TuningCache, device_kind, get_cache,
                    reset_cache, scoped, tuned_value)
from .ladder import (ShapeHistogram, derive_ladder, expected_padding_waste,
                     histogram, histograms, merge_observed, observe,
                     percentile_size, reset_histograms, resolve_ladder,
                     seed_cache_from_observed)
from .measure import (CostProbe, cached_step_ms, jit_cost, measure_or_model,
                      model_score, note_step_timing, step_shape_key)

__all__ = [
    "TuningCache", "CACHE_FILENAME", "device_kind", "get_cache",
    "reset_cache", "scoped", "tuned_value",
    "ShapeHistogram", "observe", "histogram", "histograms",
    "merge_observed", "reset_histograms", "derive_ladder",
    "expected_padding_waste",
    "percentile_size", "resolve_ladder", "seed_cache_from_observed",
    "measure_or_model", "jit_cost", "model_score", "CostProbe",
    "step_shape_key", "note_step_timing", "cached_step_ms",
]
