"""CLI driver for the serving fleet — the counterpart of
``python -m paddle_tpu.fleet``.

    python -m paddle_tpu_torch.fleet --selftest [--device cpu]
        In-process end-to-end proof (no external network): a
        controller, two ServingServer replicas on ``--device`` (default:
        the card; raises without one) joined by FleetMembers, a
        FleetRouter, and a RolloutDriver. Proves from counters:
          * rollout: canary → health-gate → fleet-wide, both replicas
            converge to the version
          * decode-aware routing: with one replica's KV pool pinned
            full, every request lands on the free replica
            (fleet.routed.<replica> counters)
          * cluster-wide shed: only when BOTH replicas report zero
            capacity does the router shed (fleet.sheds +
            ServerOverloaded)
          * failover-no-reexecute: a dropped reply is answered from
            the SAME replica's dedup cache (rpc.server.dedup_hits,
            zero extra engine work); a killed replica's traffic fails
            over to the survivor (fleet.failovers)
          * signed intents, the autoscale policy and the launcher
        Exit non-zero on any failure.

    python -m paddle_tpu_torch.fleet --controller [--port N]
        Operator mode: run a FleetController until interrupted.

    python -m paddle_tpu_torch.fleet --replica --controller-addr \
            HOST:PORT [--replica-id RID] [--device D]
        Replica mode — what the ReplicaLauncher spawns: a ServingServer
        on ``--device`` (default: the card) joined to the fleet by a
        FleetMember. The model set converges entirely from the
        controller's intent log (checkpoint-dir deploys included), so
        the process needs no model arguments. SIGTERM = clean leave
        (deregister, drain); SIGKILL = crash, and the launcher's backoff
        brings it back.
"""
from __future__ import annotations

import argparse
import os
import sys


def run_selftest(device=None, verbose: bool = True) -> int:
    from ..distributed import faults
    from ..observability import metrics as _metrics
    from ..serving import ServerOverloaded, ServingServer
    from ..serving.decode import DecoderSpec

    from . import (FleetController, FleetMember, FleetRouter,
                   RolloutDriver, decoder_artifact)

    def say(msg):
        if verbose:
            print(f"  {msg}")

    failures = []

    def check(ok, what):
        say(("ok  " if ok else "FAIL") + f" {what}")
        if not ok:
            failures.append(what)

    spec = DecoderSpec(vocab=32, d_model=16, n_layers=1, n_heads=2,
                       n_kv_heads=1, seed=3)
    ctl = FleetController(lease_ttl=30.0, sweep_interval=0)
    ctl_addr = ctl.serve()
    servers, members = [], []
    for i in range(2):
        srv = ServingServer(device=device)
        srv.serve()
        servers.append(srv)
        members.append(FleetMember(srv, ctl_addr, replica_id=f"r{i}",
                                   beat_interval=0.1))
    router = FleetRouter(ctl_addr, scrape_ttl=0.0, replica_ttl=0.0)
    try:
        check(all(m.wait_registered(30.0) for m in members),
              "both replicas registered with the controller")
        # -- 1. rollout: canary → gate → fleet-wide ----------------------
        art = decoder_artifact(spec.to_dict(), slots=[1, 2], page_size=4,
                               num_pages=24, max_seq_len=12,
                               prefill_chunk=1)
        drv = RolloutDriver(ctl_addr)
        summary = drv.rollout(
            "m", art, version=1, canary="r0",
            probe=lambda cli: cli.generate("m", [1, 2], max_new_tokens=2))
        check(summary["canary"] == "r0"
              and sorted(summary["converged"]) == ["r0", "r1"],
              f"rollout converged fleet-wide ({summary['converged']})")

        # -- 2. decode-aware routing: freer replica wins -----------------
        alloc0 = servers[0].registry.get("m").cache.allocator
        held = alloc0.alloc(99001, alloc0.pages_free * alloc0.page_size)
        del held
        n = 6
        base1 = _metrics.counter("fleet.routed.r1").value()
        base0 = _metrics.counter("fleet.routed.r0").value()
        for i in range(n):
            router.generate("m", [1, 2, 3], max_new_tokens=2)
        routed1 = _metrics.counter("fleet.routed.r1").value() - base1
        routed0 = _metrics.counter("fleet.routed.r0").value() - base0
        check(routed1 >= n and routed0 == 0,
              f"KV-saturated r0 took nothing; r1 took all "
              f"({routed1} routed to r1, {routed0} to r0)")

        # -- 3. cluster-wide shed only at zero capacity ------------------
        alloc1 = servers[1].registry.get("m").cache.allocator
        held1 = alloc1.alloc(99002,
                             alloc1.pages_free * alloc1.page_size)
        del held1
        base_sheds = _metrics.counter("fleet.sheds").value()
        try:
            router.generate("m", [1, 2, 3], max_new_tokens=2)
            check(False, "cluster-wide shed raises ServerOverloaded")
        except ServerOverloaded:
            check(True, "cluster-wide shed raises ServerOverloaded")
        check(_metrics.counter("fleet.sheds").value() == base_sheds + 1,
              "fleet.sheds counted the cluster-wide shed")
        alloc0.free(99001)
        alloc1.free(99002)
        out = router.generate("m", [1, 2, 3], max_new_tokens=2)
        check(len(out["tokens"]) == 2, "capacity back, routing resumed")

        # -- 4. failover-no-reexecute ------------------------------------
        # 4a: dropped reply on a live replica = dedup answer, zero extra
        # engine work (the retransmit rides the SAME (client_id, seq))
        _metrics.reset_metrics()
        with faults.scoped("drop@recv.generate:0") as plan:
            out = router.generate("m", [3, 1], max_new_tokens=2)
        drops = [s for _k, s, _i in plan.injected()]
        check(drops == ["recv.generate"] and len(out["tokens"]) == 2,
              "dropped reply answered on retransmit")
        check(_metrics.counter("rpc.server.dedup_hits").value() == 1
              and _metrics.counter("serving.decode.requests").value() == 1,
              "retransmit was dedup-answered, NOT re-executed "
              "(1 dedup hit, 1 engine request)")
        # 4b: killed replica = failover to the survivor. A long
        # scrape-TTL router holds a cached load snapshot in which r0
        # (more free pages: r1 gets some pinned) ranks FIRST, so the
        # post-kill request deterministically contacts the dead r0,
        # fails over, and lands on r1.
        router2 = FleetRouter(ctl_addr, scrape_ttl=60.0, replica_ttl=60.0)
        try:
            held1 = alloc1.alloc(99003, 4 * alloc1.page_size)
            del held1
            out = router2.generate("m", [1], max_new_tokens=1)
            check(len(out["tokens"]) == 1, "pre-kill probe through r0")
            servers[0].kill()  # SIGKILL-shaped: connections sever
            base_fo = _metrics.counter("fleet.failovers").value()
            out = router2.generate("m", [2, 4], max_new_tokens=2)
            check(len(out["tokens"]) == 2,
                  "request answered after replica kill")
            fo = _metrics.counter("fleet.failovers").value() - base_fo
            check(fo == 1, f"exactly one failover for the kill ({fo})")
            alloc1.free(99003)
        finally:
            router2.close()

        # -- 5. signed intents + autoscale policy + launcher -------------
        import subprocess  # noqa: F401  (spawned via ReplicaLauncher)
        import time as _time

        from ..distributed.rpc import RpcClient

        from . import FleetPolicy, ReplicaLauncher
        from . import auth as _fauth

        os.environ["PADDLE_TPU_FLEET_KEY"] = "selftest-key"
        ctl2 = FleetController(lease_ttl=30.0, sweep_interval=0)
        ctl2_addr = ctl2.serve()
        cli2 = RpcClient(ctl2_addr, retries=0)
        ln = None
        try:
            # 5a: unsigned append refused typed + counted; signed lands
            base_ref = _metrics.counter(
                "fleet.auth.refused.unsigned").value()
            try:
                cli2.call("add_intent", "unload_model", "ghost", {})
                check(False, "unsigned intent refused on a keyed fleet")
            except RuntimeError as e:
                check("intent refused (unsigned)" in str(e),
                      "unsigned intent refused on a keyed fleet")
            check(_metrics.counter("fleet.auth.refused.unsigned").value()
                  == base_ref + 1,
                  "refusal counted (fleet.auth.refused.unsigned)")
            f = _fauth.signed_fields("unload_model", "ghost", {})
            r = cli2.call("add_intent", "unload_model", "ghost", {},
                          f["nonce"], f["sig"])
            check(r.get("ok"), "signed intent accepted")
            try:
                cli2.call("add_intent", "unload_model", "ghost", {},
                          f["nonce"], f["sig"])
                check(False, "replayed intent refused")
            except RuntimeError as e:
                check("intent refused (replayed)" in str(e),
                      "replayed intent refused")

            # 5b: policy — hysteretic scale-up, cache-aware scale-down
            for i, rid in enumerate(("p0", "p1")):
                cli2.call("register", rid, ["127.0.0.1", 10000 + i])

            def beat(rid, free, cached):
                cli2.call("heartbeat", rid, 0,
                          {"free_pages": free, "queue_headroom": 4,
                           "cached_tokens": cached, "queue_depth": 0,
                           "live_slots": 0, "models": {}})

            pol = FleetPolicy(ctl2, beats=2, cooldown=0,
                              free_page_floor=8, headroom_floor=1,
                              margin=1.0, min_replicas=1,
                              max_replicas=3, start=False)
            beat("p0", 2, 0)
            beat("p1", 2, 500)
            d1 = pol.tick()  # under floor (4 < 8): streak 1 -> hold
            d2 = pol.tick()  # streak 2 == beats -> scale_up
            check(d1["decision"] == "hold"
                  and d2["decision"] == "scale_up",
                  "policy scales UP only after N consecutive "
                  f"under-floor beats ({d1['decision']}, "
                  f"{d2['decision']})")
            beat("p0", 50, 0)
            beat("p1", 50, 500)
            d3 = pol.tick()  # capacity back: drain the COLDEST (p0)
            d4 = pol.tick()  # p0 idle -> scale_down intent
            check(d3["decision"] == "drain" and d3["replica"] == "p0",
                  "cache-aware scale-down drains the COLDEST replica "
                  f"({d3})")
            check(d4["decision"] == "scale_down"
                  and d4["replica"] == "p0",
                  "drained-idle replica handed to the launcher "
                  f"({d4['decision']})")
            scale_log = cli2.call("scale_intents", 0)
            check(len(scale_log) == 2
                  and all(i.get("sig") for i in scale_log),
                  "policy's scale intents are signed")

            # 5c: launcher — spawn, SIGKILL resurrection, signed stop
            def fake_cmd(rid):
                return [sys.executable, "-c",
                        "import time; time.sleep(60)"]

            ln = ReplicaLauncher(ctl2_addr, command_factory=fake_cmd,
                                 backoff=0.05, grace=2.0, start=False,
                                 device=device)
            ln.poll_once()
            rep = ln.stats()["replicas"]
            check(rep.get("auto-1", {}).get("alive")
                  and "p0" not in rep,
                  "launcher spawned the scale_up replica (and ignored "
                  "the never-spawned drain victim)")
            pid1 = ln.pid_of("auto-1")
            ln.kill_replica("auto-1")
            pid2 = None
            deadline = _time.monotonic() + 20.0
            while _time.monotonic() < deadline:
                ln.poll_once()
                pid2 = ln.pid_of("auto-1")
                if pid2 is not None and pid2 != pid1:
                    break
                _time.sleep(0.05)
            check(pid2 is not None and pid2 != pid1,
                  "launcher resurrected the SIGKILLed replica "
                  f"(pid {pid1} -> {pid2})")
            check(_metrics.counter("fleet.launcher.restarts").value()
                  >= 1, "resurrection counted as a crash-restart")
            f2 = _fauth.signed_fields("scale_down", "_fleet",
                                      {"replica_id": "auto-1"})
            cli2.call("add_scale_intent", "scale_down",
                      {"replica_id": "auto-1"}, f2["nonce"], f2["sig"])
            deadline = _time.monotonic() + 20.0
            while _time.monotonic() < deadline:
                ln.poll_once()
                if not ln.stats()["replicas"]["auto-1"]["alive"]:
                    break
                _time.sleep(0.05)
            check(not ln.stats()["replicas"]["auto-1"]["alive"],
                  "signed scale_down stopped the replica")
        finally:
            os.environ.pop("PADDLE_TPU_FLEET_KEY", None)
            if ln is not None:
                ln.stop()
            cli2.close()
            ctl2.shutdown()
    finally:
        router.close()
        for m in members:
            m.stop(deregister=False)
        for srv in servers:
            try:
                srv.shutdown(drain=False)
            except Exception:
                pass
        ctl.shutdown()

    if failures:
        print(f"fleet selftest: {len(failures)} FAILURE(S): {failures}")
        return 1
    print("fleet selftest: OK")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m paddle_tpu_torch.fleet")
    ap.add_argument("--selftest", action="store_true",
                    help="run the in-process end-to-end selftest")
    ap.add_argument("--controller", action="store_true",
                    help="run a FleetController until interrupted")
    ap.add_argument("--replica", action="store_true",
                    help="run one fleet replica (a ServingServer + "
                         "FleetMember) — what the ReplicaLauncher "
                         "spawns; converges its model set from the "
                         "controller's intent log")
    ap.add_argument("--controller-addr", default=None,
                    help="HOST:PORT of the fleet controller "
                         "(replica mode)")
    ap.add_argument("--replica-id", default=None)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--lease-ttl", type=float, default=None)
    ap.add_argument("--device", default=None,
                    help="device the replica (or the selftest's replicas) "
                         "serve on (default: the card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    if args.replica:
        import signal
        import threading

        from ..serving import ServingServer
        from . import FleetMember

        if not args.controller_addr:
            ap.error("--replica requires --controller-addr HOST:PORT")
        chost, _, cport = args.controller_addr.rpartition(":")
        srv = ServingServer(device=args.device)
        host, port = srv.serve(args.host, args.port)
        member = FleetMember(srv, (chost or "127.0.0.1", int(cport)),
                             replica_id=args.replica_id)
        done = threading.Event()
        # SIGTERM is the launcher's polite stop: deregister (the
        # controller must not count this as an eviction) and drain
        # in-flight work before exiting. SIGKILL needs no handler —
        # that is the crash path the launcher resurrects.
        for s in (signal.SIGTERM, signal.SIGINT):
            signal.signal(s, lambda *_: done.set())
        print(f"fleet replica {member.replica_id} on {host}:{port} "
              f"({srv.device})", flush=True)
        done.wait()
        member.stop(deregister=True)
        srv.shutdown(drain=True)
        return 0
    if args.controller:
        from . import FleetController

        ctl = FleetController(lease_ttl=args.lease_ttl)
        host, port = ctl.serve(args.host, args.port)
        print(f"fleet controller on {host}:{port} (ctrl-c to stop)")
        try:
            import time

            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            ctl.shutdown()
        return 0
    return run_selftest(device=args.device)


if __name__ == "__main__":
    sys.exit(main())
