"""The port's debug server and timeline tool
(paddle_tpu_torch/observability/{debug_server,timeline}.py) against the
JAX package's, on the CPU:

  - the endpoints: the same paths, status codes and JSON keys; /statusz
    differs only in the decided device view (the JAX ``jax`` section,
    the port's ``device`` section: the server's device, the platform,
    the card count and names, the torch and CUDA versions), and
    ``DebugServer()`` means the card and raises without one;
  - the env-started shared server carries a ServingServer's
    ``serving:<port>`` section, a FleetController's ``fleet:<port>`` and
    the mesh layer's ``mesh``;
  - timeline: summarize and merge output EQUAL to the JAX tool's on the
    same shard files (shards the port's tracer wrote, and the JAX tool's
    clock-skewed pair), the CLI, and the selftest.
"""
import json
import os
import urllib.error
import urllib.request

import pytest
import torch

from paddle_tpu.observability import debug_server as jdebug
from paddle_tpu.observability import timeline as jtimeline
from paddle_tpu_torch.observability import debug_server as tdebug
from paddle_tpu_torch.observability import timeline as ttimeline
from paddle_tpu_torch.observability import tracing as ttracing


def _get(addr, path):
    host, port = addr
    try:
        with urllib.request.urlopen(f"http://{host}:{port}{path}",
                                    timeout=10) as r:
            return r.status, r.headers["Content-Type"], r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read().decode()


@pytest.fixture
def both_servers():
    j, t = jdebug.DebugServer(), tdebug.DebugServer(device="cpu")
    ja, ta = j.start(), t.start()
    try:
        yield (j, ja), (t, ta)
    finally:
        j.stop()
        t.stop()


def test_endpoints_same_paths_codes_and_keys(both_servers):
    (j, ja), (t, ta) = both_servers
    for srv in (j, t):
        srv.add_status("probe", lambda: {"n": (1, 2), "s": {3}})
        srv.add_status("broken", lambda: 1 / 0)
    for path in ("/healthz", "/metrics", "/tracez?n=5", "/statusz",
                 "/nope"):
        jc, jt, jb = _get(ja, path)
        tc, tt, tb = _get(ta, path)
        assert (tc, tt) == (jc, jt), path
        if path == "/healthz":
            assert tb == jb == "ok\n"
        elif path == "/nope":
            assert tc == 404 and tb == jb
        elif path == "/metrics":
            assert "# TYPE" in tb
        else:
            jd, td = json.loads(jb), json.loads(tb)
            if path == "/statusz":
                assert set(jd) - {"jax"} == set(td) - {"device"}
                assert set(jd["tracing"]) == set(td["tracing"])
                assert td["probe"] == jd["probe"] == {"n": [1, 2],
                                                       "s": [3]}
                assert td["broken"] == jd["broken"]
                assert td["device"]["device"] == "cpu"
                assert td["device"]["platform"] == "cpu"
                assert td["device"]["torch"] == torch.__version__
                assert set(td["device"]) == {
                    "device", "platform", "device_count", "devices",
                    "torch", "cuda"}
                assert set(td["flags"]) >= {"autotune", "autotune_dir",
                                            "fleet_lease_ttl"}
            else:
                assert set(td) == set(jd)


def test_device_view_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdebug.DebugServer()


def test_env_shared_server_serving_fleet_and_mesh_sections(monkeypatch):
    from paddle_tpu_torch.fleet import FleetController
    from paddle_tpu_torch.mesh.observe import _stats
    from paddle_tpu_torch.serving import ServingServer

    monkeypatch.setenv("PADDLE_TPU_DEBUG_PORT", "0")
    assert tdebug.shared_server() is None
    dbg = tdebug.ensure_shared(device="cpu")
    srv = ServingServer(device="cpu")
    ctl = FleetController(lease_ttl=30.0, sweep_interval=0)
    try:
        saddr = srv.serve()
        caddr = ctl.serve()
        assert tdebug.maybe_serve_from_env() is dbg  # one per process
        ctl._register("rX", ["127.0.0.1", 4242])
        _stats.note_mesh("probe", {"tp": 1})
        code, _t, body = _get(dbg.address, "/statusz")
        st = json.loads(body)
        assert code == 200
        assert st[f"serving:{saddr[1]}"]["models"] == {}
        fleet = st[f"fleet:{caddr[1]}"]
        assert fleet["replicas"]["rX"]["endpoint"] == ["127.0.0.1", 4242]
        assert "register" in fleet["rpc"]["methods"]
        assert st["mesh"]["meshes"]["probe"] == {"tp": 1}
        srv.shutdown()
        st = json.loads(_get(dbg.address, "/statusz")[2])
        assert f"serving:{saddr[1]}" not in st
    finally:
        ctl.shutdown()
        tdebug.stop_shared()
        with _stats._mu:
            _stats._meshes.pop("probe", None)
    monkeypatch.setenv("PADDLE_TPU_DEBUG_PORT", "not-a-port")
    assert tdebug.maybe_serve_from_env(device="cpu") is None


def _port_shards(d):
    """Two shards the port's tracer wrote: spans with a cross-process
    parent, exported as two 'processes'."""
    ttracing.trace_enable(buffer_size=4096)
    ttracing.trace_reset()
    paths = []
    try:
        for i, label in enumerate(("trainer:0", "serving:7001")):
            ttracing.trace_reset()
            ttracing.set_process_label(label)
            with ttracing.span(f"work.{i}", step=i):
                with ttracing.span("inner"):
                    pass
            paths.append(ttracing.trace_export(
                os.path.join(d, f"shard{i}.json")))
    finally:
        ttracing.trace_disable()
        ttracing.trace_reset()
    # the same pid wrote both: the merge must still keep two tracks
    return paths


def _skewed_shards(d):
    def shard(pid, label, wall, off, events):
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"pid": pid, "process_label": label,
                              "wall_epoch_us": wall,
                              "rpc_clock_offset_us": off,
                              "dropped_spans": 2}}

    docs = [shard(11, "trainer:0", 1_000_000.0, 500.0, [
        {"name": "rpc.client.push", "ph": "X", "ts": 100.0, "dur": 400.0,
         "pid": 11, "tid": 1, "args": {"trace_id": "T1", "span_id": "C1"}},
        {"name": "rpc", "cat": "rpc", "ph": "s", "id": "F1", "ts": 120.0,
         "pid": 11, "tid": 1}]),
        shard(22, "pserver:7000", 1_000_200.0, 0.0, [
            {"name": "rpc.server.push", "ph": "X", "ts": 450.0,
             "dur": 100.0, "pid": 22, "tid": 9,
             "args": {"trace_id": "T1", "span_id": "S1",
                      "parent_span_id": "C1"}},
            {"name": "rpc", "cat": "rpc", "ph": "f", "bp": "e",
             "id": "F1", "ts": 455.0, "pid": 22, "tid": 9}])]
    paths = []
    for i, doc in enumerate(docs):
        p = os.path.join(d, f"skew{i}.json")
        with open(p, "w") as f:
            json.dump(doc, f)
        paths.append(p)
    return paths


@pytest.mark.parametrize("which", ["port_tracer", "skewed"])
def test_timeline_summary_and_merge_equal_jax(tmp_path, which):
    paths = (_port_shards if which == "port_tracer" else _skewed_shards)(
        str(tmp_path))
    for p in paths:
        ev = ttimeline.load_events(p)
        assert ev == jtimeline.load_events(p)
        assert ttimeline.summarize(ev, top=5) == \
            jtimeline.summarize(ev, top=5)
    merged = ttimeline.merge_shards(paths)
    assert merged == jtimeline.merge_shards(paths)
    names = {e["args"]["name"] for e in merged["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    assert len(names) == 2
    assert len({e["pid"] for e in merged["traceEvents"]}) == 2


def test_timeline_cli_merge_and_errors(tmp_path, capsys):
    paths = _skewed_shards(str(tmp_path))
    out = str(tmp_path / "merged.json")
    assert ttimeline.main(["merge", "-o", out] + paths) == 0
    text = capsys.readouterr().out
    assert "merged 2 shard(s)" in text and "4 dropped" in text
    with open(out) as f:
        assert json.load(f) == jtimeline.merge_shards(paths)
    assert ttimeline.main(["merge", "-o", out, paths[0],
                           str(tmp_path / "missing.json")]) == 2
    assert "shard not found" in capsys.readouterr().err
    assert ttimeline.main([paths[0], "--top", "3"]) == 0
    assert "rpc.client.push" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError):
        ttimeline.merge_shards([str(tmp_path / "nope.json")])
    with pytest.raises(ValueError):
        ttimeline.merge_shards([])


def test_timeline_selftest():
    assert ttimeline.main(["--selftest"]) == 0
