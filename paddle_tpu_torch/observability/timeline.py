"""Timeline CLI — the counterpart of ``paddle_tpu/observability/
timeline.py`` (the tools/timeline.py role for exported traces), reading
the shards the port's ``observability/tracing.py`` writes.

  python -m paddle_tpu_torch.observability.timeline trace.json [--top N]
      print a per-span-name summary (calls, total/avg/max ms, % of
      wall) of a chrome://tracing JSON file, heaviest first.

  python -m paddle_tpu_torch.observability.timeline merge \
      -o merged.json shard1.json shard2.json ...
      combine per-process trace shards (each process exports
      its own ring buffer — see PADDLE_TPU_TRACE_DIR) into ONE
      Perfetto-loadable timeline. Every shard's process-local timestamps
      are rebased onto a shared axis using the shard's wall-clock epoch
      anchor plus its RPC-handshake clock-offset estimate (both recorded
      in otherData by trace_export), so a client span and its server
      handler span line up even across skewed clocks. Flow events and
      trace ids pass through untouched — Perfetto draws the
      client→server arrows.

  python -m paddle_tpu_torch.observability.timeline --selftest
      record a synthetic multi-thread trace through the real recorder,
      export it, and validate the JSON round-trips with well-formed
      ph/ts/dur fields and correct cross-thread nesting; then exercise
      merge on overlapping, clock-skewed shards and the missing-shard
      error path. Exit 0 on success.

Traces open in Perfetto (https://ui.perfetto.dev) or chrome://tracing.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from typing import Any, Dict, List


def load_events(path: str) -> List[Dict[str, Any]]:
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    if not isinstance(events, list):
        raise ValueError(f"{path}: no traceEvents list")
    return events


def summarize(events: List[Dict[str, Any]], top: int = 20) -> str:
    """Top-N table by total duration. Only complete ("X") events carry
    dur; B/E pairs from foreign tools are ignored rather than guessed."""
    agg = defaultdict(lambda: [0, 0.0, 0.0])  # calls, total_us, max_us
    t_min, t_max = float("inf"), float("-inf")
    for ev in events:
        if ev.get("ph") != "X":
            continue
        dur = float(ev.get("dur", 0.0))
        ts = float(ev.get("ts", 0.0))
        rec = agg[ev.get("name", "?")]
        rec[0] += 1
        rec[1] += dur
        rec[2] = max(rec[2], dur)
        t_min = min(t_min, ts)
        t_max = max(t_max, ts + dur)
    wall_us = (t_max - t_min) if t_max > t_min else 0.0
    rows = sorted(agg.items(), key=lambda kv: kv[1][1], reverse=True)[:top]
    lines = [
        f"{'Span':<44}{'Calls':>7}{'Total(ms)':>11}{'Avg(ms)':>10}"
        f"{'Max(ms)':>10}{'%Wall':>8}"
    ]
    for name, (calls, total, mx) in rows:
        pct = (total / wall_us * 100.0) if wall_us else 0.0
        lines.append(
            f"{name[:44]:<44}{calls:>7}{total / 1e3:>11.3f}"
            f"{total / calls / 1e3:>10.3f}{mx / 1e3:>10.3f}{pct:>7.1f}%"
        )
    lines.append(
        f"-- {sum(r[0] for r in agg.values())} spans, "
        f"{len(agg)} distinct names, wall {wall_us / 1e3:.3f} ms"
    )
    return "\n".join(lines)


# --- multi-process merge -------------------------------------------------


def merge_shards(paths: List[str]) -> Dict[str, Any]:
    """Combine per-process shards into one timeline document.

    Alignment: a shard's ts values are µs since ITS process's trace
    epoch. otherData.wall_epoch_us (wall time of that epoch) maps them
    onto the wall clock; otherData.rpc_clock_offset_us (the NTP-style
    estimate the RPC layer maintains: peer_wall - local_wall) corrects
    residual skew toward the servers the process talked to. Everything
    is then rebased to the earliest event so Perfetto opens at t=0.

    Raises FileNotFoundError/ValueError on a missing or malformed shard
    — a partial merge would silently present an incomplete job as the
    whole job.
    """
    if not paths:
        raise ValueError("merge needs at least one shard")
    shards = []
    for p in paths:
        try:
            with open(p) as f:
                doc = json.load(f)
        except FileNotFoundError:
            raise FileNotFoundError(f"shard not found: {p}") from None
        except json.JSONDecodeError as e:
            raise ValueError(f"{p}: not valid trace JSON ({e})") from None
        if not isinstance(doc, dict) or \
                not isinstance(doc.get("traceEvents"), list):
            raise ValueError(f"{p}: no traceEvents list")
        other = doc.get("otherData") or {}
        shards.append({
            "path": p,
            "events": doc["traceEvents"],
            "wall_epoch_us": float(other.get("wall_epoch_us", 0.0)),
            "offset_us": float(other.get("rpc_clock_offset_us", 0.0)),
            "pid": other.get("pid"),
            "label": other.get("process_label"),
            "dropped": int(other.get("dropped_spans", 0)),
        })

    # two shards can share an OS pid (pid reuse across hosts/restarts);
    # remap collisions to synthetic pids so Perfetto keeps the process
    # tracks separate
    used_pids: set = set()
    for i, sh in enumerate(shards):
        pid = sh["pid"]
        ev_pids = {e.get("pid") for e in sh["events"]
                   if e.get("pid") is not None}
        if pid is None:
            pid = next(iter(ev_pids), 1000 + i)
        remap = pid in used_pids
        new_pid = pid
        while new_pid in used_pids:
            new_pid += 100000
        used_pids.add(new_pid)
        sh["out_pid"] = new_pid
        sh["remap_from"] = pid if remap else None

    # Rebase in SMALL numbers: wall anchors are ~1e15 µs, and adding a
    # shard-local ts (~1e3 µs) to them in float64 quantizes at ~0.25 µs —
    # subtracting two such sums can surface as a (tiny) negative ts.
    # Subtract the anchors from each other FIRST (one cancellation per
    # shard), then work in per-shard relative shifts.
    base = min(sh["wall_epoch_us"] + sh["offset_us"] for sh in shards)
    for sh in shards:
        sh["rel_us"] = (sh["wall_epoch_us"] + sh["offset_us"]) - base
    t_min = min((float(ev["ts"]) + sh["rel_us"]
                 for sh in shards for ev in sh["events"] if "ts" in ev),
                default=0.0)
    merged: List[Dict[str, Any]] = []
    for sh in shards:
        shift = sh["rel_us"] - t_min
        for ev in sh["events"]:
            ev = dict(ev)
            if "ts" in ev:
                ev["ts"] = max(0.0, float(ev["ts"]) + shift)
            if sh["out_pid"] is not None:
                ev["pid"] = sh["out_pid"]
            merged.append(ev)
        if not any(ev.get("ph") == "M" and ev.get("name") == "process_name"
                   for ev in sh["events"]):
            merged.append({"name": "process_name", "ph": "M",
                           "pid": sh["out_pid"],
                           "args": {"name": sh["label"]
                                    or f"pid {sh['pid']}"}})
    # Perfetto doesn't require order, but a sorted file diffs/tails sanely
    merged.sort(key=lambda e: e.get("ts", -1.0))
    return {
        "traceEvents": merged,
        "displayTimeUnit": "ms",
        "otherData": {
            "merged_shards": [
                {"path": sh["path"], "pid": sh["pid"],
                 "process_label": sh["label"],
                 "clock_offset_us": sh["offset_us"],
                 "dropped_spans": sh["dropped"]}
                for sh in shards
            ],
            "dropped_spans": sum(sh["dropped"] for sh in shards),
        },
    }


def _merge_main(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.observability.timeline merge",
        description="Merge per-process trace shards into one "
                    "Perfetto-loadable timeline.")
    ap.add_argument("shards", nargs="+", help="per-process trace JSONs "
                    "(PADDLE_TPU_TRACE_DIR exports trace-<pid>.json)")
    ap.add_argument("-o", "--out", default="merged_trace.json",
                    help="output path (default merged_trace.json)")
    args = ap.parse_args(argv)
    try:
        doc = merge_shards(args.shards)
    except (FileNotFoundError, ValueError) as e:
        print(f"merge failed: {e}", file=sys.stderr)
        return 2
    with open(args.out, "w") as f:
        json.dump(doc, f)
    n_x = sum(1 for e in doc["traceEvents"] if e.get("ph") == "X")
    n_flow = sum(1 for e in doc["traceEvents"] if e.get("ph") in ("s", "f"))
    print(f"merged {len(args.shards)} shard(s) -> {args.out}: "
          f"{n_x} spans, {n_flow} flow events, "
          f"{doc['otherData']['dropped_spans']} dropped")
    print(summarize(doc["traceEvents"]))
    return 0


# --- selftest ------------------------------------------------------------


def _selftest() -> int:
    """End-to-end recorder -> exporter -> parser check on a synthetic
    workload with nested and cross-thread spans, then a merge check over
    overlapping clock-skewed shards and the missing-shard error path."""
    import os
    import tempfile
    import threading
    import time

    from . import tracing

    tracing.trace_enable(buffer_size=4096)
    tracing.trace_reset()
    try:
        with tracing.span("selftest.parent", step=1):
            with tracing.span("selftest.child"):
                time.sleep(0.002)
            with tracing.span("selftest.child"):
                time.sleep(0.001)

        def worker():
            with tracing.span("selftest.worker"):
                time.sleep(0.001)

        t = threading.Thread(target=worker)
        t.start()
        t.join()
        with tempfile.TemporaryDirectory() as d:
            path = tracing.trace_export(os.path.join(d, "trace.json"))
            events = load_events(path)
    finally:
        tracing.trace_disable()
        tracing.trace_reset()

    by_name = defaultdict(list)
    for ev in events:
        if ev.get("ph") == "M":
            continue  # process metadata carries no ts/dur
        for field in ("name", "ph", "ts", "dur", "pid", "tid"):
            assert field in ev, f"event missing {field!r}: {ev}"
        assert ev["ph"] == "X", ev
        assert ev["dur"] >= 0 and ev["ts"] >= 0, ev
        by_name[ev["name"]].append(ev)
    assert len(by_name["selftest.parent"]) == 1, by_name
    assert len(by_name["selftest.child"]) == 2, by_name
    assert len(by_name["selftest.worker"]) == 1, by_name
    parent = by_name["selftest.parent"][0]
    assert parent["args"]["step"] == 1, parent
    # every span carries trace context; children inherit the parent's
    # trace_id, roots start their own
    assert "trace_id" in parent["args"] and "span_id" in parent["args"]
    p0, p1 = parent["ts"], parent["ts"] + parent["dur"]
    for child in by_name["selftest.child"]:
        assert p0 <= child["ts"] and child["ts"] + child["dur"] <= p1, \
            (parent, child)
        assert child["tid"] == parent["tid"]
        assert child["args"]["trace_id"] == parent["args"]["trace_id"]
        assert child["args"]["parent_span_id"] == parent["args"]["span_id"]
    assert by_name["selftest.worker"][0]["tid"] != parent["tid"]
    print(summarize(events))

    _selftest_merge()
    print("timeline selftest ok")
    return 0


def _selftest_merge():
    """Merge validation: two overlapping shards with deliberate clock
    skew must land on one corrected axis with both processes' spans,
    flow events intact; a missing shard must be a hard error."""
    import os
    import tempfile

    def shard(pid, label, wall_epoch_us, offset_us, events):
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"pid": pid, "process_label": label,
                              "wall_epoch_us": wall_epoch_us,
                              "rpc_clock_offset_us": offset_us,
                              "dropped_spans": 0}}

    # client's clock runs 500µs BEHIND the server's (its recorded wall
    # epoch is low by 500); the RPC handshake measured offset +500.
    # True client window: (1_000_000+500) + 100..500 = 1_000_600..1_001_000;
    # server handler (epoch 1_000_200, no skew) at 450..550 = 1_000_650..750
    # sits INSIDE it. Uncorrected, the handler would appear to start
    # AFTER the client call already returned — physically impossible.
    client = shard(11, "trainer:0", 1_000_000.0, 500.0, [
        {"name": "rpc.client.push_grad", "ph": "X", "ts": 100.0,
         "dur": 400.0, "pid": 11, "tid": 1,
         "args": {"trace_id": "T1", "span_id": "C1"}},
        {"name": "rpc", "cat": "rpc", "ph": "s", "id": "F1",
         "ts": 120.0, "pid": 11, "tid": 1},
    ])
    server = shard(22, "pserver:7000", 1_000_200.0, 0.0, [
        {"name": "rpc.server.push_grad", "ph": "X", "ts": 450.0,
         "dur": 100.0, "pid": 22, "tid": 9,
         "args": {"trace_id": "T1", "span_id": "S1",
                  "parent_span_id": "C1"}},
        {"name": "rpc", "cat": "rpc", "ph": "f", "bp": "e", "id": "F1",
         "ts": 455.0, "pid": 22, "tid": 9},
    ])
    # the BROKEN ordering the offset correction fixes: on raw wall
    # anchors alone the handler would start at 1_000_650 but the client
    # call would END at 1_000_500 — assert the skew scenario is real
    assert (1_000_200.0 + 450.0) > (1_000_000.0 + 500.0)
    with tempfile.TemporaryDirectory() as d:
        pa = os.path.join(d, "a.json")
        pb = os.path.join(d, "b.json")
        with open(pa, "w") as f:
            json.dump(client, f)
        with open(pb, "w") as f:
            json.dump(server, f)
        doc = merge_shards([pa, pb])
        evs = doc["traceEvents"]
        cl = next(e for e in evs if e["name"] == "rpc.client.push_grad")
        sv = next(e for e in evs if e["name"] == "rpc.server.push_grad")
        # shared trace id + parentage survived the merge
        assert sv["args"]["trace_id"] == cl["args"]["trace_id"]
        assert sv["args"]["parent_span_id"] == cl["args"]["span_id"]
        # corrected axis: the server handler runs INSIDE the client call
        # window (client 100..500 + offset 500 -> wall 1_000_600..
        # 1_001_000; server 250..350 -> wall 1_000_650..750)
        assert cl["ts"] <= sv["ts"], (cl["ts"], sv["ts"])
        assert sv["ts"] + sv["dur"] <= cl["ts"] + cl["dur"]
        # flow pair intact, ids matching, start before finish
        fs = next(e for e in evs if e.get("ph") == "s")
        fe = next(e for e in evs if e.get("ph") == "f")
        assert fs["id"] == fe["id"] == "F1"
        assert fs["ts"] <= fe["ts"]
        # both processes present, distinctly named
        names = {e["args"]["name"] for e in evs
                 if e.get("ph") == "M" and e.get("name") == "process_name"}
        assert names == {"trainer:0", "pserver:7000"}, names
        # missing shard: loud failure, not a partial merge
        try:
            merge_shards([pa, os.path.join(d, "nope.json")])
        except FileNotFoundError:
            pass
        else:
            raise AssertionError("missing shard did not raise")
    print("merge selftest ok")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "merge":
        return _merge_main(argv[1:])
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.observability.timeline",
        description="Summarize a chrome://tracing JSON exported by "
                    "paddle_tpu_torch (trace_export / profiler "
                    "profile_path), "
                    "or `merge` per-process shards into one timeline.")
    ap.add_argument("trace", nargs="?", help="path to trace JSON")
    ap.add_argument("--top", type=int, default=20,
                    help="rows in the summary table (default 20)")
    ap.add_argument("--selftest", action="store_true",
                    help="validate the recorder/exporter/merger round trip")
    args = ap.parse_args(argv)
    if args.selftest:
        return _selftest()
    if not args.trace:
        ap.error("need a trace file (or `merge`, or --selftest)")
    print(summarize(load_events(args.trace), top=args.top))
    return 0


if __name__ == "__main__":
    sys.exit(main())
