"""The port's serving fleet (paddle_tpu_torch/fleet) against the JAX
package's (paddle_tpu/fleet), on the CPU:

  - auth: ``sign_intent`` hex and the canonical bytes EQUAL for the same
    seeded intents, each package verifies the other's signatures, and
    tamper, replay, unsigned and out-of-allowlist intents are refused
    with the same typed reasons; the key-rotation window;
  - the controller: the same seeded sequence of registrations, intents
    and heartbeats leaves the same intent log (compaction below the
    applied watermark included) in both;
  - FleetPolicy: the same decisions and scale intents on a seeded
    sequence of load reports;
  - decode tokens through the port's router EQUAL (bitwise) to the JAX
    fleet's for a tiny seeded decoder; the packages interoperate (a JAX
    member on the port's controller, a port member on the JAX
    controller, signed intents across them);
  - rollout canary, health gate and abort; a dropped reply answered
    from the dedup cache; a draining replica skipped; a replica killed
    mid-FleetTokenStream, the stream resumed on the survivor with the
    same tokens;
  - the launcher with ``--device cpu``: a real replica process spawned
    from a scale intent converges from the intent log and answers, is
    restarted after a SIGKILL, leaves on SIGTERM, and loaded neither jax
    nor paddle_tpu;
  - ``python -m paddle_tpu_torch.fleet --selftest --device cpu`` run in
    process.

Leases are 30 s with the sweeper off, or 6 s where a real process
joins; every wait polls a condition against a deadline.
"""
import json
import os
import signal
import sys
import time

import numpy as np
import pytest

from paddle_tpu import fleet as jfleet
from paddle_tpu.fleet import auth as jauth
from paddle_tpu.serving import ServingServer as JaxServer
from paddle_tpu_torch import fleet as tfleet
from paddle_tpu_torch.distributed import faults as tfaults
from paddle_tpu_torch.fleet import auth as tauth
from paddle_tpu_torch.observability import metrics as tm
from paddle_tpu_torch.serving import ServingClient, ServingServer
from paddle_tpu_torch.serving.errors import ServerOverloaded

# test_torch_serving.py's decoder (the two packages' greedy tokens agree
# on it), on a two-shape ladder so the JAX engine's warm stays short
SPEC = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            seed=11)
DEC_KW = dict(slots=[2], page_size=4, num_pages=32, max_seq_len=8,
              prefill_chunk=1)
NEW = 3


def _prompts(seed, n=4):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(0, SPEC["vocab"],
                                         size=rng.randint(2, 6))]
            for _ in range(n)]


def _wait(cond, timeout=60.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _port_fleet(n, ctl=None):
    ctl = ctl or tfleet.FleetController(lease_ttl=30.0, sweep_interval=0)
    addr = ctl.serve()
    servers, members = [], []
    for i in range(n):
        srv = ServingServer(device="cpu")
        srv.serve()
        servers.append(srv)
        members.append(tfleet.FleetMember(srv, addr, replica_id=f"r{i}",
                                          beat_interval=0.1))
    assert all(m.wait_registered(30.0) for m in members)
    return ctl, addr, servers, members


def _close(ctl, servers, members, routers=()):
    for r in routers:
        r.close()
    for m in members:
        m.stop(deregister=False)
    for s in servers:
        try:
            s.shutdown(drain=False)
        except Exception:
            pass
    ctl.shutdown()


def _c(name):
    return tm.counter(name).value()


# --- auth ---------------------------------------------------------------

def _intent(seed):
    rng = np.random.RandomState(seed)
    payload = {"version": int(rng.randint(1, 9)),
               "slots": [int(x) for x in sorted(rng.randint(1, 9, 3))],
               "spec": dict(SPEC, seed=int(rng.randint(100))),
               "max_wait_ms": float(rng.rand())}
    if seed % 2:
        payload["checkpoint_dir"] = f"/ckpt/run{seed}"
    return ("load_decoder" if seed % 2 else "load_model",
            f"model{seed}", payload, f"nonce-{seed}-{rng.randint(1e6)}")


@pytest.mark.parametrize("seed", range(4))
def test_sign_intent_hex_and_bytes_equal_jax(seed):
    action, model, payload, nonce = _intent(seed)
    key = f"key-{seed}"
    assert tauth.canonical_intent(action, model, payload, nonce) == \
        jauth.canonical_intent(action, model, payload, nonce)
    sig = tauth.sign_intent(key, action, model, payload, nonce)
    assert sig == jauth.sign_intent(key, action, model, payload, nonce)
    rec = {"seq": 1, "action": action, "model": model, "payload": payload,
           "nonce": nonce, "sig": sig}
    # each package verifies the other's signature, then refuses the
    # replay of the same nonce
    for mod in (tauth, jauth):
        w = mod.NonceWindow()
        mod.verify_intent(key, rec, window=w)
        with pytest.raises(mod.IntentRefused) as e:
            mod.verify_intent(key, rec, window=w)
        assert e.value.reason == "replayed"


def test_refusals_typed_like_jax(tmp_path):
    key = "k1"
    action, model, payload, nonce = _intent(1)
    good = {"seq": 3, "action": action, "model": model, "payload": payload,
            "nonce": nonce,
            "sig": tauth.sign_intent(key, action, model, payload, nonce)}
    tampered = dict(good, payload=dict(payload, version=99))
    unsigned = {k: v for k, v in good.items() if k not in ("nonce", "sig")}
    rotated = dict(good, nonce="n2", sig=tauth.sign_intent(
        "old", action, model, payload, "n2"))
    allowed = tmp_path / "allowed"
    allowed.mkdir()
    (tmp_path / "elsewhere").mkdir()
    (allowed / "escape").symlink_to(tmp_path / "elsewhere")
    reasons = {}
    for mod in (tauth, jauth):
        got = []
        for rec in (tampered, unsigned):
            with pytest.raises(mod.IntentRefused) as e:
                mod.verify_intent(key, rec, window=mod.NonceWindow())
            got.append(e.value.reason)
        with pytest.raises(mod.IntentRefused) as e:
            mod.verify_intent(key, rotated, window=mod.NonceWindow())
        got.append(e.value.reason)
        mod.verify_intent(key, rotated, window=mod.NonceWindow(),
                          prev_key="old")  # inside the rotation window
        mod.verify_intent(None, unsigned)  # open mode
        allow = [os.path.realpath(str(allowed))]
        mod.check_allowlist(allow, {"payload": {
            "checkpoint_dir": str(allowed / "x")}})
        for bad in (str(allowed / "escape" / "x"), "/etc"):
            with pytest.raises(mod.IntentRefused) as e:
                mod.check_allowlist(allow, {"payload": {"dirname": bad}})
            got.append(e.value.reason)
        reasons[mod.__name__] = got
    assert reasons["paddle_tpu_torch.fleet.auth"] == \
        reasons["paddle_tpu.fleet.auth"] == [
            "bad_signature", "unsigned", "bad_signature",
            "path_not_allowed", "path_not_allowed"]


# --- controller + policy: same state from the same operations -----------

def _ops(seed, n=40):
    rng = np.random.RandomState(seed)
    ops = [("register", "r0"), ("register", "r1"), ("register", "r2")]
    models = ["m0", "m1", "m2"]
    for _ in range(n):
        k = rng.rand()
        if k < 0.45:
            act = ["load_decoder", "load_model", "unload_model"][
                rng.randint(3)]
            ops.append(("intent", act, models[rng.randint(3)],
                        {"version": int(rng.randint(1, 5))}))
        elif k < 0.9:
            ops.append(("beat", f"r{rng.randint(3)}",
                        float(rng.rand())))  # share of the log applied
        else:
            ops.append(("deregister", f"r{rng.randint(3)}"))
            ops.append(("register", f"r{rng.randint(3)}"))
    return ops


def _drive(ctl, ops):
    applied = {}
    out = []
    for op in ops:
        if op[0] == "register":
            out.append(ctl._register(op[1], ["127.0.0.1", 9000])
                       ["intent_seq"])
            applied[op[1]] = 0
        elif op[0] == "deregister":
            out.append(ctl._deregister(op[1])["was_registered"])
        elif op[0] == "intent":
            out.append(ctl._add_intent(op[1], op[2], op[3])["seq"])
        else:
            with ctl._mu:  # the declared guard of _next_seq
                seq = int(op[2] * ctl._next_seq)
            applied[op[1]] = max(applied.get(op[1], 0), seq)
            out.append(ctl._heartbeat(op[1], applied[op[1]], None))
    log = [{k: v for k, v in i.items() if k != "at"}
           for i in ctl._intents_since(0)]
    st = ctl._fleet_status()
    return out, log, {k: st[k] for k in ("intent_seq", "intent_log_len",
                                         "scale_seq")}


@pytest.mark.parametrize("seed", range(3))
def test_intent_log_and_compaction_same_state_as_jax(seed):
    ops = _ops(seed)
    c0 = _c("fleet.intents.compacted")
    t = _drive(tfleet.FleetController(lease_ttl=30.0, sweep_interval=0),
               ops)
    j = _drive(jfleet.FleetController(lease_ttl=30.0, sweep_interval=0),
               ops)
    assert t == j
    assert len(t[1]) < sum(1 for op in ops if op[0] == "intent")
    assert _c("fleet.intents.compacted") > c0


def test_policy_decisions_equal_jax():
    rng = np.random.RandomState(17)
    reports = []
    for _ in range(30):
        reports.append({
            rid: {"free_pages": int(rng.choice([1, 3, 20, 60])),
                  "queue_headroom": int(rng.choice([0, 4, 16])),
                  "cached_tokens": int(rng.randint(0, 500)),
                  "queue_depth": int(rng.choice([0, 0, 2])),
                  "live_slots": int(rng.choice([0, 0, 1])),
                  "models": {}}
            for rid in ("p0", "p1", "p2")})
    runs = []
    for mod in (tfleet, jfleet):
        ctl = mod.FleetController(lease_ttl=30.0, sweep_interval=0)
        for rid in ("p0", "p1", "p2"):
            ctl._register(rid, ["127.0.0.1", 10000])
        pol = mod.FleetPolicy(ctl, beats=2, cooldown=2, free_page_floor=10,
                              headroom_floor=2, margin=1.5, min_replicas=1,
                              max_replicas=4, start=False)
        decisions = []
        for rep in reports:
            for rid, load in rep.items():
                ctl._heartbeat(rid, 0, load)
            decisions.append(pol.tick())
        scale = [{k: v for k, v in i.items() if k != "at"}
                 for i in ctl._scale_intents_since(0)]
        runs.append((decisions, scale))
    assert runs[0] == runs[1]
    kinds = {d["decision"] for d in runs[0][0]}
    assert {"scale_up", "drain"} <= kinds


# --- decode routing: the JAX fleet's tokens -----------------------------

def test_router_tokens_bitwise_jax_fleet():
    prompts = _prompts(5)
    art = dict(spec=SPEC, **DEC_KW)
    ctl, addr, servers, members = _port_fleet(2)
    router = tfleet.FleetRouter(addr, scrape_ttl=0.0, replica_ttl=0.0)
    try:
        s = tfleet.RolloutDriver(addr).rollout(
            "gen", tfleet.decoder_artifact(**art), canary="r1",
            probe=lambda cli: cli.generate("gen", [1, 2], max_new_tokens=1))
        assert s["canary"] == "r1" and sorted(s["converged"]) == ["r0", "r1"]
        got = [router.generate("gen", p, max_new_tokens=NEW)["tokens"]
               for p in prompts]
    finally:
        _close(ctl, servers, members, [router])
    jctl = jfleet.FleetController(lease_ttl=30.0, sweep_interval=0)
    jaddr = jctl.serve()
    jsrv = JaxServer()
    jsrv.serve()
    jm = jfleet.FleetMember(jsrv, jaddr, replica_id="j0", beat_interval=0.1)
    jrouter = jfleet.FleetRouter(jaddr, scrape_ttl=0.0, replica_ttl=0.0)
    try:
        assert jm.wait_registered(30.0)
        jfleet.RolloutDriver(jaddr).rollout("gen",
                                            jfleet.decoder_artifact(**art))
        want = [jrouter.generate("gen", p, max_new_tokens=NEW)["tokens"]
                for p in prompts]
    finally:
        _close(jctl, [jsrv], [jm], [jrouter])
    assert got == want


def test_jax_member_on_port_controller_signed(monkeypatch):
    """A JAX replica joins the port's controller, verifies the port
    driver's signed intent and converges; the port's router answers
    from it with the port replica's tokens."""
    monkeypatch.setenv("PADDLE_TPU_FLEET_KEY", "interop-key")
    prompts = _prompts(6, n=2)
    ctl, addr, servers, members = _port_fleet(1)
    jsrv = JaxServer()
    jsrv.serve()
    jm = jfleet.FleetMember(jsrv, addr, replica_id="jax0",
                            beat_interval=0.1)
    router = tfleet.FleetRouter(addr, scrape_ttl=0.0, replica_ttl=0.0)
    try:
        assert jm.wait_registered(30.0)
        s = tfleet.RolloutDriver(addr).rollout(
            "gen", tfleet.decoder_artifact(SPEC, **DEC_KW), canary="r0")
        assert sorted(s["converged"]) == ["jax0", "r0"]
        assert jm.wait_converged(s["intent_seq"], 60.0)
        assert all(i.get("sig") for i in ctl._intents_since(0))
        outs = {}
        for rid, other in (("jax0", servers[0]), ("r0", jsrv)):
            alloc = other.registry.get("gen").cache.allocator
            alloc.alloc(777, alloc.pages_free * alloc.page_size)
            try:
                b = _c(f"fleet.routed.{rid}")
                outs[rid] = [router.generate("gen", p, max_new_tokens=NEW)
                             ["tokens"] for p in prompts]
                assert _c(f"fleet.routed.{rid}") == b + len(prompts)
            finally:
                alloc.free(777)
        assert outs["jax0"] == outs["r0"]
    finally:
        _close(ctl, servers + [jsrv], members + [jm], [router])


def test_port_member_on_jax_controller():
    jctl = jfleet.FleetController(lease_ttl=30.0, sweep_interval=0)
    jaddr = jctl.serve()
    srv = ServingServer(device="cpu")
    srv.serve()
    m = tfleet.FleetMember(srv, jaddr, replica_id="torch0",
                           beat_interval=0.1)
    try:
        assert m.wait_registered(30.0)
        seq = jctl._add_intent("load_decoder", "gen",
                               dict(spec=SPEC, version=3, **DEC_KW))["seq"]
        assert m.wait_converged(seq, 60.0)
        assert srv.registry.get("gen").version == 3
        # the member's heartbeat carries its applied seq and load summary
        _wait(lambda: (jctl.policy_view()["torch0"]["applied_seq"] == seq
                       and jctl.policy_view()["torch0"]["load"]),
              what="the port member's heartbeat")
        load = jctl.policy_view()["torch0"]["load"]
        assert load["models"] == {"gen": 3} and load["free_pages"] > 0
        jctl._add_intent("unload_model", "gen", {})
        _wait(lambda: "gen" not in srv.load_report()["models"],
              what="the unload to converge")
    finally:
        _close(jctl, [srv], [m])


# --- rollout, failover, drain -------------------------------------------

def test_rollout_canary_gate_and_abort(tmp_path):
    from paddle_tpu.serving.__main__ import make_model_dir

    d1, probe, ref1 = make_model_dir(str(tmp_path / "v1"), scale=1.0)
    d2, _p, _r = make_model_dir(str(tmp_path / "v2"), scale=-1.0)
    ctl, addr, servers, members = _port_fleet(2)
    router = tfleet.FleetRouter(addr, scrape_ttl=0.0, replica_ttl=0.0)
    try:
        drv = tfleet.RolloutDriver(addr)

        def probe_v1(cli):
            out, _v = cli.infer("m", {"x": probe})
            np.testing.assert_allclose(out[0], ref1, atol=1e-5)

        r0 = _c("fleet.rollouts")
        s = drv.rollout("m", tfleet.model_artifact(d1, buckets=[4],
                                                   max_wait_ms=1.0),
                        canary="r1", probe=probe_v1)
        assert s["canary"] == "r1" and s["version"] == 1
        assert sorted(s["converged"]) == ["r0", "r1"] and not s["skipped"]
        assert _c("fleet.rollouts") == r0 + 1
        out, ver = router.infer("m", {"x": probe})
        np.testing.assert_allclose(out[0], ref1, atol=1e-5)

        def bad_probe(cli):
            raise AssertionError("canary output rejected by the gate")

        a0 = _c("fleet.rollout.aborts")
        with pytest.raises(tfleet.RolloutError, match="probe"):
            drv.rollout("m", tfleet.model_artifact(d2, buckets=[4]),
                        version=2, canary="r1", probe=bad_probe)
        assert _c("fleet.rollout.aborts") == a0 + 1
        assert servers[0].registry.get("m").version == 1  # untouched
        assert all(i["payload"].get("version") != 2
                   for i in ctl._intents_since(0))
        with pytest.raises(tfleet.RolloutError, match="canary 'rz'"):
            drv.rollout("m", tfleet.model_artifact(d1), canary="rz")
    finally:
        _close(ctl, servers, members, [router])


def test_failover_dedup_drain_and_stream_resume():
    ctl, addr, servers, members = _port_fleet(2)
    router = tfleet.FleetRouter(addr, scrape_ttl=0.0, replica_ttl=0.0)
    try:
        tfleet.RolloutDriver(addr).rollout(
            "gen", tfleet.decoder_artifact(SPEC, **DEC_KW))
        ref = router.generate("gen", [5, 7, 9], max_new_tokens=4)["tokens"]
        # a reply dropped on a live replica: answered from its dedup
        # cache, the engine ran once
        d0, q0 = _c("rpc.server.dedup_hits"), _c("serving.decode.requests")
        with tfaults.scoped("drop@recv.generate:0") as plan:
            out = router.generate("gen", [5, 7, 9], max_new_tokens=4)
        assert [s for _k, s, _i in plan.injected()] == ["recv.generate"]
        assert out["tokens"] == ref
        assert _c("rpc.server.dedup_hits") == d0 + 1
        assert _c("serving.decode.requests") == q0 + 1
        # a draining replica takes no new work
        ctl._set_draining("r0", True)
        b0, b1 = _c("fleet.routed.r0"), _c("fleet.routed.r1")
        for _ in range(3):
            router.generate("gen", [1, 2], max_new_tokens=2)
        assert (_c("fleet.routed.r0"), _c("fleet.routed.r1")) == \
            (b0, b1 + 3)
        ctl._set_draining("r0", False)
        # both pools pinned full: the fleet sheds
        allocs = [s.registry.get("gen").cache.allocator for s in servers]
        for i, a in enumerate(allocs):
            a.alloc(900 + i, a.pages_free * a.page_size)
        s0 = _c("fleet.sheds")
        with pytest.raises(ServerOverloaded, match="no replica"):
            router.generate("gen", [1], max_new_tokens=1)
        assert _c("fleet.sheds") == s0 + 1
        for i, a in enumerate(allocs):
            a.free(900 + i)
        # the replica serving a stream dies mid-stream: the stream
        # resumes on the survivor with the same tokens
        f0, r0 = _c("fleet.failovers"), _c("fleet.stream.resumes")
        with tfaults.scoped("delay@serving.decode.step:*=0.05"):
            st = router.generate("gen", [5, 7, 9], max_new_tokens=4,
                                 stream=True)
            first = next(st)
            victim = int(st.replica[1:])
            servers[victim].kill()
            members[victim].stop(deregister=False)
            toks = [first] + list(st)
        assert toks == ref and st.delivered == 4
        assert _c("fleet.failovers") == f0 + 1
        assert _c("fleet.stream.resumes") == r0 + 1
    finally:
        _close(ctl, servers, members, [router])


# --- launcher: a real replica process -----------------------------------

_PROBE = ("import atexit, json, runpy, sys\n"
          "def _dump():\n"
          "    bad = sorted(m for m in sys.modules if m in ('jax', "
          "'paddle_tpu') or m.startswith(('jax.', 'jaxlib', "
          "'paddle_tpu.')))\n"
          "    with open({path!r}, 'w') as f:\n"
          "        json.dump(bad, f)\n"
          "atexit.register(_dump)\n"
          "sys.argv = {argv!r}\n"
          "runpy.run_module('paddle_tpu_torch.fleet', run_name='__main__',"
          " alter_sys=True)\n")


def test_launcher_spawns_restarts_and_stops_a_cpu_replica(tmp_path):
    ctl = tfleet.FleetController(lease_ttl=6.0, sweep_interval=0)
    addr = ctl.serve()
    srv = ServingServer(device="cpu")
    srv.serve()
    m0 = tfleet.FleetMember(srv, addr, replica_id="r0", beat_interval=0.5)
    router = tfleet.FleetRouter(addr, scrape_ttl=0.0, replica_ttl=0.0)
    probe = str(tmp_path / "modules.json")
    ln = tfleet.ReplicaLauncher(addr, backoff=0.05, grace=20.0,
                                start=False, device="cpu")
    default = ln._default_command("auto-1")
    assert default[1:3] == ["-m", "paddle_tpu_torch.fleet"]
    assert default[-2:] == ["--device", "cpu"]
    ln._command_factory = lambda rid: [sys.executable, "-c", _PROBE.format(
        path=probe, argv=["paddle_tpu_torch.fleet"]
        + ln._default_command(rid)[3:])]
    try:
        assert m0.wait_registered(30.0)
        tfleet.RolloutDriver(addr).rollout(
            "gen", tfleet.decoder_artifact(SPEC, **DEC_KW))
        ref = router.generate("gen", [3, 1, 4], max_new_tokens=NEW)
        ctl._add_scale_intent("scale_up", {"replica_id": "auto-1"})
        ln.poll_once()
        pid1 = ln.pid_of("auto-1")
        assert pid1 is not None and _c("fleet.launcher.spawns") >= 1

        def converged():
            rep = ctl._list_replicas().get("auto-1")
            if rep is None:
                return False
            cli = ServingClient(tuple(rep["endpoint"]), retries=0)
            try:
                return "gen" in cli.load_report()["models"]
            except (ConnectionError, OSError, RuntimeError):
                return False
            finally:
                cli.close()

        _wait(converged, 120.0, "the spawned replica to converge")
        alloc = srv.registry.get("gen").cache.allocator
        alloc.alloc(555, alloc.pages_free * alloc.page_size)
        b = _c("fleet.routed.auto-1")
        out = router.generate("gen", [3, 1, 4], max_new_tokens=NEW)
        assert out["tokens"] == ref["tokens"]
        assert _c("fleet.routed.auto-1") == b + 1
        alloc.free(555)
        # SIGKILL = crash: restarted under the same id
        r0 = _c("fleet.launcher.restarts")
        assert ln.kill_replica("auto-1") == pid1

        def restarted():
            ln.poll_once()
            pid = ln.pid_of("auto-1")
            return pid is not None and pid != pid1

        _wait(restarted, 60.0, "the crash restart")
        assert _c("fleet.launcher.restarts") == r0 + 1
        _wait(converged, 120.0, "the restarted replica to converge")
        proc = ln._procs["auto-1"]["proc"]
        # scale_down = SIGTERM: a clean leave (deregistered, exit 0)
        ctl._add_scale_intent("scale_down", {"replica_id": "auto-1"})
        ln.poll_once()
        assert proc.wait(60.0) == 0
        ln.poll_once()
        assert not ln.stats()["replicas"]["auto-1"]["alive"]
        assert "auto-1" not in ctl._list_replicas()
        with open(probe) as f:
            assert json.load(f) == []  # the child loaded no jax
    finally:
        ln.stop()
        _close(ctl, [srv], [m0], [router])


def test_launcher_and_replica_need_a_card(monkeypatch):
    import torch

    from paddle_tpu_torch.fleet.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfleet.ReplicaLauncher(("127.0.0.1", 1), start=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--replica", "--controller-addr", "127.0.0.1:1"])


def test_fleet_selftest_in_process():
    from paddle_tpu_torch.fleet.__main__ import run_selftest

    assert run_selftest(device="cpu", verbose=False) == 0
    assert "PADDLE_TPU_FLEET_KEY" not in os.environ
