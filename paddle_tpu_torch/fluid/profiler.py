"""Profiler (reference python/paddle/fluid/profiler.py +
platform/profiler.cc): host RecordEvent table + chrome-trace export on
top of paddle_tpu_torch.observability — the counterpart of
``paddle_tpu/fluid/profiler.py``, with the same API, table and span
trace.

The reference aggregates per-op host/CUDA timings into a table and exports
chrome://tracing JSON via CUPTI (device_tracer.cc + tools/timeline.py).
Here the observability trace recorder plays the host half: every
RecordEvent (and every framework-internal span — executor steps, RPC
calls, reader pops) lands in one ring buffer, and `profiler(profile_path=
...)` exports it as chrome://tracing JSON loadable in Perfetto. The
device half is `torch.profiler` with CUDA activity (CUPTI, as the
reference's device_tracer): under a state other than "CPU", on a machine
with a card, its events — every kernel launched, by name — join the
exported file's ``traceEvents`` beside the spans (their own pid and
clock). The table is the RecordEvent table, as in the JAX package.

Enable-state is captured at `__enter__`, not checked at `__exit__` — a
span straddling stop_profiler() is counted in the table it STARTED under
instead of being silently dropped, and start_profiler() resets
aggregation state like the reference's profiler begin does.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Optional

import torch

from ..observability import tracing

_events = defaultdict(lambda: [0, 0.0, float("inf"), 0.0])  # calls,total,min,max
_enabled = False


class RecordEvent:
    """RAII span (reference platform/profiler.h:73). Feeds BOTH the
    aggregated table and the observability trace buffer."""

    def __init__(self, name: str):
        self.name = name
        self._t0 = None
        self._armed = False
        self._span = None

    def __enter__(self):
        # capture enable-state NOW: a span that straddles stop_profiler()
        # belongs to the profile it started under
        self._armed = _enabled
        self._span = tracing.span(self.name)
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = (time.perf_counter() - self._t0) * 1000.0
        self._span.__exit__(*exc)
        if not self._armed:
            return False
        rec = _events[self.name]
        rec[0] += 1
        rec[1] += dt
        rec[2] = min(rec[2], dt)
        rec[3] = max(rec[3], dt)
        return False


def reset_profiler():
    _events.clear()


def _print_table(sorted_key: Optional[str]):
    rows = [
        (name, c, total, total / max(c, 1), mn, mx)
        for name, (c, total, mn, mx) in _events.items()
    ]
    key_idx = {"calls": 1, "total": 2, "ave": 3, "min": 4, "max": 5}.get(
        sorted_key or "total", 2
    )
    rows.sort(key=lambda r: r[key_idx], reverse=True)
    print(f"{'Event':<40}{'Calls':>8}{'Total(ms)':>12}{'Ave(ms)':>10}"
          f"{'Min(ms)':>10}{'Max(ms)':>10}")
    for name, c, total, ave, mn, mx in rows:
        print(f"{name:<40}{c:>8}{total:>12.3f}{ave:>10.3f}{mn:>10.3f}{mx:>10.3f}")


def _device_profiler(state: str):
    """A started torch.profiler session with CUDA activity, when the
    state asks for the device and there is a card; else None."""
    if state == "CPU" or not torch.cuda.is_available():
        return None
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def _device_events(prof):
    """The chrome-trace events of a finished torch.profiler session."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)


def _export(profile_path: str, prof) -> str:
    """The span trace, with the device session's events joined in."""
    path = tracing.trace_export(profile_path)
    if prof is not None:
        with open(path) as f:
            doc = json.load(f)
        doc["traceEvents"] += _device_events(prof)
        with open(path, "w") as f:
            json.dump(doc, f)
    return path


@contextlib.contextmanager
def profiler(state: str = "All", sorted_key: Optional[str] = None,
             profile_path: Optional[str] = None):
    """reference fluid/profiler.py:76. With profile_path, exports the
    scope's spans (RecordEvents + executor/RPC/reader instrumentation),
    and under state "GPU" or "All" on a card the device's events, as
    chrome://tracing JSON to that path — open it in Perfetto
    (ui.perfetto.dev) or chrome://tracing. A directory path gets
    <dir>/trace.json."""
    global _enabled
    _enabled = True
    reset_profiler()
    was_tracing = tracing.trace_enabled()
    tracing.trace_enable()
    if not was_tracing:
        tracing.trace_reset()
    prof = _device_profiler(state)
    try:
        yield
    finally:
        _enabled = False
        if prof is not None:
            prof.__exit__(None, None, None)
        if profile_path:
            _export(profile_path, prof)
        if not was_tracing:
            tracing.trace_disable()
        _print_table(sorted_key)


@contextlib.contextmanager
def cuda_profiler(output_file=None, output_mode=None, config=None):
    """reference fluid/profiler.py:33: a device trace of the block, by
    torch.profiler with CUDA activity on a card (the CPU's alone
    without one), written as chrome://tracing JSON to `output_file`
    (default: paddle_tpu_torch_trace.json in the temp directory)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(output_file or os.path.join(
        tempfile.gettempdir(), "paddle_tpu_torch_trace.json"))


# was span recording already on (env flag / explicit trace_enable) when
# start_profiler turned it on? stop_profiler restores that state instead
# of leaving the recorder running process-wide forever. None = no
# start_profiler pending — an unpaired stop_profiler() must NOT touch a
# session someone else (PADDLE_TPU_TRACE, trace_enable) started.
_prev_tracing: Optional[bool] = None
# the device session start_profiler opened, closed by stop_profiler
_device_prof = None


def start_profiler(state: str = "All"):
    """reference fluid/profiler.py:51 — begins a fresh profile: resets
    aggregation (the reference's EnableProfiler starts a new recording)
    and turns span recording on (and, under "GPU" or "All" on a card,
    a device session)."""
    global _enabled, _prev_tracing, _device_prof
    reset_profiler()
    _enabled = True
    if _prev_tracing is None:  # nested starts keep the OUTERMOST state
        _prev_tracing = tracing.trace_enabled()
    tracing.trace_enable()
    if not _prev_tracing:
        tracing.trace_reset()
    if _device_prof is None:
        _device_prof = _device_profiler(state)


def stop_profiler(sorted_key=None, profile_path=None):
    global _enabled, _prev_tracing, _device_prof
    _enabled = False
    prof, _device_prof = _device_prof, None
    if prof is not None:
        prof.__exit__(None, None, None)
    if profile_path:
        _export(profile_path, prof)
    if _prev_tracing is False:
        tracing.trace_disable()
    _prev_tracing = None
    _print_table(sorted_key)
