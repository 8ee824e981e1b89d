"""The port's elastic data service and its coordination
(``paddle_tpu_torch/distributed/master.py``, ``tcp_lease.py``,
``election.py``, ``membership.py``) against the JAX package's on the CPU:
the same task-protocol sequences, snapshots recovered across the
packages, clients and lease clients of one package against the other's
servers, shared lease files and registry roots, and the /statusz
sections of the master and the pserver. Servers run as threads of this
process on 127.0.0.1."""
import json
import os
import pickle
import struct
import subprocess
import sys
import time
import urllib.request
import zlib

import numpy as np
import pytest

import paddle_tpu.distributed as jdist
import paddle_tpu.distributed.master as jmaster
import paddle_tpu.distributed.tcp_lease as jlease

import paddle_tpu_torch.distributed as tdist
import paddle_tpu_torch.distributed.master as tmaster
import paddle_tpu_torch.distributed.tcp_lease as tlease
from paddle_tpu_torch.native.recordio import RecordIOWriter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": (jdist, jmaster, jlease), "port": (tdist, tmaster, tlease)}


def _shards(tmp_path, n_files=6, per_file=5):
    paths = []
    for i in range(n_files):
        p = str(tmp_path / f"shard-{i:02d}.rio")
        w = RecordIOWriter(p)
        for j in range(per_file):
            w.write(f"{i}:{j}".encode())
        w.close()
        paths.append(p)
    return paths


def _t(task):
    return None if task is None else (task.id, list(task.paths),
                                      task.num_failures, task.epoch)


def _protocol(master_mod):
    """One seeded sequence of the task protocol on an in-process
    service: every result and stats() after each call."""
    svc = master_mod.MasterService(chunks_per_task=2, lease_timeout=600,
                                   failure_max=2)
    paths = [f"s{i}" for i in range(7)]
    out = []

    def note(what, v):
        out.append((what, _t(v) if hasattr(v, "paths") else v,
                    svc.stats()))

    svc.set_dataset(paths)
    note("set", None)
    svc.set_dataset(paths)  # idempotent for an unchanged list
    note("set again", None)
    a, b, c = svc.get_task(), svc.get_task(), svc.get_task()
    for t in (a, b, c):
        note("get", t)
    note("finish a", svc.task_finished(a.id, a.epoch))
    note("finish a again", svc.task_finished(a.id, a.epoch))
    note("fail b", svc.task_failed(b.id, b.epoch))
    note("stale finish b", svc.task_finished(b.id, b.epoch))
    note("release c", svc.task_released(c.id, c.epoch))
    note("new_pass early", svc.new_pass())
    rng = np.random.RandomState(7)
    while True:
        t = svc.get_task()
        if t is None:
            break
        note("get", t)
        verb = ["finish", "fail", "release"][rng.randint(3)]
        fn = {"finish": svc.task_finished, "fail": svc.task_failed,
              "release": svc.task_released}[verb]
        note(verb, fn(t.id, t.epoch))
    note("all_done", svc.all_done())
    note("new_pass", svc.new_pass())
    note("get after pass", svc.get_task())
    return out


def test_task_protocol_sequences_equal_jax():
    port = _protocol(tmaster)
    assert port == _protocol(jmaster)
    assert port[-1][2]["pass"] == 1 and port[-1][2]["dropped"] == 0


def _state(svc):
    return {"todo": [_t(t) for t in svc._todo],
            "done": [_t(t) for t in svc._done],
            "dropped": [_t(t) for t in svc._failed_dropped],
            "next_id": svc._next_id, "epoch": svc._epoch,
            "dataset": svc._dataset_paths, "pass": svc._cur_pass,
            "term": svc._snapshot_term}


def _drive(master_mod, snap, term):
    """A service at ``term`` whose snapshot holds todo, pending, done and
    dropped tasks."""
    svc = master_mod.MasterService(chunks_per_task=1, lease_timeout=600,
                                   failure_max=1, snapshot_path=snap,
                                   snapshot_term=term)
    svc.set_dataset([f"p{i}" for i in range(6)])
    a, b, _c = svc.get_task(), svc.get_task(), svc.get_task()
    svc.task_finished(a.id, a.epoch)
    svc.task_failed(b.id, b.epoch)  # failure_max 1: dropped
    return svc


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_snapshot_recovers_across_packages(tmp_path, writer, reader):
    snap = str(tmp_path / "m.snap")
    _drive(PKGS[writer][1], snap, term=3)
    rec = PKGS[reader][1].MasterService(chunks_per_task=1,
                                        snapshot_path=snap)
    # the pending lease survives as todo; the term is adopted
    ref = PKGS[writer][1].MasterService(chunks_per_task=1,
                                        snapshot_path=snap)
    assert _state(rec) == _state(ref)
    assert rec._snapshot_term == 3
    assert rec.stats() == {"todo": 4, "pending": 0, "done": 1,
                           "dropped": 1, "pass": 0}
    # the recovered service keeps committing under the writer's format
    t = rec.get_task()
    assert rec.task_finished(t.id, t.epoch)
    again = PKGS[writer][1].MasterService(chunks_per_task=1,
                                          snapshot_path=snap)
    assert _state(again) == _state(rec)


def test_snapshot_bytes_differ_only_in_the_class_path(tmp_path):
    """The same state written by both packages: the magic, term and term
    crc are byte-equal, and the payloads, which name each package's Task
    class, decode to equal states."""
    blobs = {}
    for name in PKGS:
        snap = str(tmp_path / f"{name}.snap")
        _drive(PKGS[name][1], snap, term=9)
        with open(snap, "rb") as f:
            blobs[name] = f.read()
    assert blobs["jax"][:20] == blobs["port"][:20]
    assert blobs["jax"][:8] == b"PTSNAP2\x00"
    assert struct.unpack("<Q", blobs["jax"][8:16]) == (9,)
    pj, pp = blobs["jax"][24:], blobs["port"][24:]
    assert b"paddle_tpu.distributed.master" in pj
    assert b"paddle_tpu_torch.distributed.master" in pp
    assert b"paddle_tpu_torch" not in pj
    decode = tmaster._load_snapshot_payload
    assert decode(pj) == decode(pp)


@pytest.mark.parametrize("task_cls", ["jax", "port"])
def test_legacy_snapshot_recovers_in_both(tmp_path, task_cls):
    task = PKGS[task_cls][1].Task
    state = {"todo": [task(0, ["a"])], "pending": [task(1, ["b"], 1, 4)],
             "done": [task(2, ["c"], 0, 2)], "dropped": [], "next_id": 3,
             "epoch": 4, "dataset_paths": ["a", "b", "c"], "pass": 2}
    payload = pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
    snap = str(tmp_path / "legacy.snap")
    with open(snap, "wb") as f:
        f.write(struct.pack("<I", zlib.crc32(payload)) + payload)
    got = [_state(PKGS[n][1].MasterService(snapshot_path=snap))
           for n in ("jax", "port")]
    assert got[0] == got[1]
    assert got[1]["term"] == 0 and got[1]["pass"] == 2
    assert [t[0] for t in got[1]["todo"]] == [0, 1]
    # recommits in the v2 format, readable by the other package
    svc = tmaster.MasterService(snapshot_path=snap)
    svc.set_dataset(["a", "b", "c", "d"])
    with open(snap, "rb") as f:
        assert f.read(8) == b"PTSNAP2\x00"
    assert jmaster.MasterService(snapshot_path=snap)._dataset_paths == [
        "a", "b", "c", "d"]


@pytest.mark.parametrize("name", ["jax", "port"])
def test_corrupt_snapshot_refused(tmp_path, name):
    snap = str(tmp_path / "m.snap")
    _drive(jmaster if name == "port" else tmaster, snap, term=2)
    blob = bytearray(open(snap, "rb").read())
    blob[-3] ^= 0xFF
    open(snap, "wb").write(bytes(blob))
    with pytest.raises(IOError, match="corrupt"):
        PKGS[name][1].MasterService(snapshot_path=snap)


def test_snapshot_naming_another_class_is_refused(tmp_path):
    payload = pickle.dumps({"todo": [os.getcwd], "pending": []})
    snap = str(tmp_path / "evil.snap")
    with open(snap, "wb") as f:
        f.write(struct.pack("<I", zlib.crc32(payload)) + payload)
    with pytest.raises(pickle.UnpicklingError, match="posix.getcwd"):
        tmaster.MasterService(snapshot_path=snap)


def test_port_recovers_a_jax_snapshot_without_importing_it(tmp_path):
    snap = str(tmp_path / "j.snap")
    _drive(jmaster, snap, term=4)
    code = ("import sys, json; "
            "from paddle_tpu_torch.distributed.master import MasterService; "
            f"s = MasterService(snapshot_path={snap!r}); "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.')); "
            "print(json.dumps([s.stats(), s._snapshot_term, bad]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    stats, term, bad = json.loads(out.stdout.strip().splitlines()[-1])
    assert bad == [] and term == 4
    assert stats == {"todo": 4, "pending": 0, "done": 1, "dropped": 1,
                     "pass": 0}


@pytest.mark.parametrize("old,new", [("jax", "port"), ("port", "jax")])
def test_deposed_writes_are_fenced_across_packages(tmp_path, old, new):
    snap = str(tmp_path / "m.snap")
    stale = PKGS[old][1].MasterService(chunks_per_task=1,
                                       snapshot_path=snap, snapshot_term=3)
    leader = PKGS[new][1].MasterService(chunks_per_task=1,
                                        snapshot_path=snap, snapshot_term=5)
    leader.set_dataset(["s1", "s2"])
    with pytest.raises(PKGS[old][1].MasterDeposed):
        stale.set_dataset(["stale"])
    rec = PKGS[old][1].MasterService(snapshot_path=snap)
    assert rec._dataset_paths == ["s1", "s2"] and rec._snapshot_term == 5
    # a FileLease of the new package fences the old package's commit
    lp = str(tmp_path / "lease")
    a = PKGS[old][0].FileLease(lp, "a", ttl=60)
    assert a.try_acquire(("h", 1))
    svc = PKGS[old][1].MasterService(chunks_per_task=1,
                                     snapshot_path=str(tmp_path / "f.snap"),
                                     snapshot_fence=a.fenced)
    svc.set_dataset(["x"])
    a2 = PKGS[new][0].FileLease(lp, "a", ttl=60)
    b = PKGS[new][0].FileLease(lp, "b", ttl=60)
    a2.release()  # the holder's lease is gone (its JSON file rewritten)
    assert b.try_acquire(("h", 2)) and b.term == a.term + 1
    with pytest.raises(PKGS[old][1].MasterDeposed):
        svc.get_task()


@pytest.mark.parametrize("server,client", [("port", "jax"), ("jax", "port")])
def test_master_client_of_either_package(tmp_path, server, client):
    shards = _shards(tmp_path)
    svc = PKGS[server][1].MasterService(chunks_per_task=2, lease_timeout=60)
    addr = svc.serve()
    try:
        cli = PKGS[client][1].MasterClient(addr=f"{addr[0]}:{addr[1]}",
                                           timeout=30)
        cli.set_dataset(shards)
        t = cli.get_task()
        assert type(t).__module__ == PKGS[client][1].__name__
        assert (t.id, t.paths, t.epoch) == (0, shards[:2], 1)
        assert cli.task_released(t.id, t.epoch)
        recs = sorted(cli.records())
        assert recs == sorted(f"{i}:{j}".encode() for i in range(6)
                              for j in range(5))
        assert cli.all_done() and not cli.task_finished(t.id, t.epoch)
        assert cli.stats() == {"todo": 0, "pending": 0, "done": 3,
                               "dropped": 0, "pass": 0}
        assert cli.new_pass() and cli.stats()["todo"] == 3
        with pytest.raises(RuntimeError, match="unknown RPC method"):
            cli._call("shutdown")
        cli.close()
    finally:
        svc.shutdown()


def test_master_sockets_set_nodelay(tmp_path):
    import socket

    svc = tmaster.MasterService(chunks_per_task=1, lease_timeout=60)
    addr = svc.serve()
    try:
        cli = tmaster.MasterClient(addr=addr, timeout=30)
        assert cli.stats()["todo"] == 0
        assert cli._sock.getsockopt(socket.IPPROTO_TCP,
                                    socket.TCP_NODELAY)
        with svc._conns_mu:
            (conn,) = svc._conns
        assert conn.getsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY)
        cli.close()
    finally:
        svc.shutdown()


@pytest.mark.parametrize("server,client", [("port", "jax"), ("jax", "port")])
def test_tcp_lease_of_either_package(server, client):
    srv = PKGS[server][2].LeaseServer()
    addr = srv.serve()
    lease_cls = PKGS[client][2].TcpLease
    deposed = PKGS[client][1].MasterDeposed
    try:
        a = lease_cls(addr, "m", "a", ttl=60)
        b = lease_cls(addr, "m", "b", ttl=60)
        assert a.try_acquire(("h", 1)) and a.term == 1
        assert not b.try_acquire(("h", 2))
        assert a.renew(("h", 1)) and not b.renew(("h", 2))
        a.fenced(lambda: None)
        assert a.current()["holder"] == "a" and a.current()["live"]
        resolve = PKGS[client][2].tcp_endpoint_resolver(addr, "m")
        assert resolve() == ("h", 1)
        a.release()
        with pytest.raises(ConnectionError):
            resolve()
        assert b.try_acquire(("h", 2)) and b.term == 2
        with pytest.raises(deposed):
            a.fenced(lambda: None)
        c = lease_cls(addr, "m2", "c", ttl=0.3)
        d = lease_cls(addr, "m2", "d", ttl=60)
        assert c.try_acquire() and not d.try_acquire()
        deadline = time.monotonic() + 30
        while not d.try_acquire():
            assert time.monotonic() < deadline
            time.sleep(0.05)
        with pytest.raises(deposed):
            c.fenced(lambda: None)
    finally:
        srv.shutdown()


def test_lease_server_terms_persist_across_packages(tmp_path):
    state = str(tmp_path / "leases.json")
    srv = jlease.LeaseServer(state_path=state)
    addr = srv.serve()
    try:
        a = tlease.TcpLease(addr, "m", "a", ttl=60)
        assert a.try_acquire() and a.term == 1
    finally:
        srv.shutdown()
    srv2 = tlease.LeaseServer(state_path=state)
    addr2 = srv2.serve()
    try:
        b = jlease.TcpLease(addr2, "m", "b", ttl=60)
        assert b.try_acquire() and b.term == 2
    finally:
        srv2.shutdown()


@pytest.mark.parametrize("first,second", [("port", "jax"), ("jax", "port")])
def test_file_lease_mutual_exclusion_and_expiry(tmp_path, first, second):
    lp = str(tmp_path / "lease")
    a = PKGS[first][0].FileLease(lp, "a", ttl=0.4)
    b = PKGS[second][0].FileLease(lp, "b", ttl=60)
    assert a.try_acquire(("h", 1)) and a.term == 1
    assert not b.try_acquire(("h", 2))
    assert PKGS[second][0].endpoint_resolver(lp)() == ("h", 1)
    a.fenced(lambda: None)
    deadline = time.monotonic() + 30
    while not b.try_acquire(("h", 2)):  # a stops renewing: expiry
        assert time.monotonic() < deadline
        time.sleep(0.05)
    assert b.term == 2 and not a.renew(("h", 1))
    with pytest.raises(PKGS[first][1].MasterDeposed):
        a.fenced(lambda: None)
    assert PKGS[first][0].endpoint_resolver(lp)() == ("h", 2)
    b.release()
    with pytest.raises(ConnectionError):
        PKGS[first][0].endpoint_resolver(lp)()


@pytest.mark.parametrize("leader,standby", [("jax", "port"), ("port", "port")])
def test_elected_master_standby_takeover_mid_epoch(tmp_path, leader, standby):
    """The leader dies mid-epoch without releasing its lease: the standby
    recovers the shared snapshot, the client re-resolves, and every
    record is delivered (leases the dead leader handed out time out). A
    JAX standby recovers a port snapshot's state (above) but cannot serve
    its tasks: its wire form tags only its own Task class."""
    lease = str(tmp_path / "master.lease")
    snap = str(tmp_path / "master.snap")
    shards = _shards(tmp_path)
    a = PKGS[leader][0].ElectedMaster(lease, snap, holder_id="A", ttl=1.0,
                                      chunks_per_task=1, lease_timeout=2.0)
    b = PKGS[standby][0].ElectedMaster(lease, snap, holder_id="B", ttl=1.0,
                                       chunks_per_task=1, lease_timeout=2.0)
    a.start()
    try:
        assert a.wait_leader(30)
        b.start()
        client = tdist.MasterClient(
            addr_resolver=tdist.endpoint_resolver(lease),
            reconnect_retries=60, reconnect_backoff=0.1, timeout=30)
        client.set_dataset(shards)
        it = client.records()
        recs = [next(it) for _ in range(7)]  # partway through the epoch
        assert not b.is_leader.is_set()
        a.crash()
        recs += list(it)
        assert b.wait_leader(30)
        assert sorted(set(recs)) == sorted(
            f"{i}:{j}".encode() for i in range(6) for j in range(5))
        assert client.all_done()
        client.close()
    finally:
        a.crash()
        b.stop()


def test_worker_registries_share_one_root(tmp_path):
    root = str(tmp_path / "workers")
    a = tdist.WorkerRegistry(root, "port-a", ttl=60)
    b = jdist.WorkerRegistry(root, "jax-b", ttl=60)
    c = tdist.WorkerRegistry(root, "port-c", ttl=60)
    try:
        assert (a.register(), b.register(), c.register()) == (0, 1, 2)
        want = {0: "port-a", 1: "jax-b", 2: "port-c"}
        assert a.members() == b.members() == want
        assert b.wait_for(3) == ["port-a", "jax-b", "port-c"]
        b.deregister()
        assert a.members() == {0: "port-a", 2: "port-c"}
        d = jdist.WorkerRegistry(root, "jax-d", ttl=60)
        assert d.register() == 1  # the freed slot
        assert c.wait_for(3) == ["port-a", "jax-d", "port-c"]
        assert c.ensure_registered() == 2
        d.deregister()
    finally:
        a.deregister()
        c.deregister()
    assert tdist.WorkerRegistry(root, "probe").members() == {}


def _get_json(addr, path):
    with urllib.request.urlopen(f"http://{addr[0]}:{addr[1]}{path}",
                                timeout=30) as r:
        return json.loads(r.read())


def _pserver_status(pkg_name):
    """A one-trainer async pserver over fc(4 -> 1) + SGD: its /statusz
    section after one push."""
    if pkg_name == "jax":
        import paddle_tpu.fluid as fluid
        from paddle_tpu.fluid import layers, unique_name
        dev = {}
    else:
        import paddle_tpu_torch.fluid as fluid
        from paddle_tpu_torch.fluid import layers, unique_name
        dev = {"device": "cpu"}
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data(name="x", shape=[4], dtype="float32")
        y = layers.data(name="y", shape=[1], dtype="float32")
        pred = layers.fc(input=x, size=1,
                         param_attr=fluid.ParamAttr(name="st.w"),
                         bias_attr=fluid.ParamAttr(name="st.b"))
        cost = layers.mean(layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(cost)
    t = fluid.DistributeTranspiler()
    t.transpile(trainer_id=0, program=main, startup_program=startup,
                pservers="127.0.0.1:0", trainers=1, sync_mode=False)
    ps = t.start_pserver(t.pserver_endpoints[0], port=0, **dev)
    try:
        return ps._debug_status()
    finally:
        ps.shutdown()


def test_statusz_sections_of_master_and_pserver(monkeypatch, tmp_path):
    from paddle_tpu_torch.observability import debug_server as tdebug

    monkeypatch.setenv("PADDLE_TPU_DEBUG_PORT", "0")
    dbg = tdebug.ensure_shared(device="cpu")
    svc = tmaster.MasterService(chunks_per_task=1, lease_timeout=60,
                                snapshot_path=str(tmp_path / "m.snap"))
    try:
        addr = svc.serve()
        svc.set_dataset(["a", "b"])
        st = _get_json(dbg.address, "/statusz")[f"master:{addr[1]}"]
        jsvc = jmaster.MasterService(chunks_per_task=1, lease_timeout=60,
                                     snapshot_path=str(tmp_path / "j.snap"))
        jsvc.set_dataset(["a", "b"])
        want = jsvc._debug_status()
        assert sorted(st) == sorted(want)
        assert st["stats"] == want["stats"] == {
            "todo": 2, "pending": 0, "done": 0, "dropped": 0, "pass": 0}
        assert st["sweeper_running"] and st["lease_timeout_s"] == 60
        svc.shutdown()
        assert f"master:{addr[1]}" not in _get_json(dbg.address, "/statusz")
    finally:
        svc.shutdown()
        tdebug.stop_shared()
    port, jax = _pserver_status("port"), _pserver_status("jax")
    assert sorted(port) == sorted(jax)
    assert port["params"] == jax["params"] == {
        "st.b": {"shape": [1], "dtype": "float32"},
        "st.w": {"shape": [4, 1], "dtype": "float32"}}
    for k in ("sync", "trainers", "round", "steps", "evicted",
              "pending_params", "heartbeat_timeout_s"):
        assert port[k] == jax[k], k
    assert sorted(port["rpc"]) == sorted(jax["rpc"])


def test_pserver_registers_its_statusz_section(monkeypatch):
    from paddle_tpu_torch.observability import debug_server as tdebug

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import layers, unique_name

    monkeypatch.setenv("PADDLE_TPU_DEBUG_PORT", "0")
    dbg = tdebug.ensure_shared(device="cpu")
    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data(name="x", shape=[4], dtype="float32")
        cost = layers.mean(layers.fc(input=x, size=1))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(cost)
    t = fluid.DistributeTranspiler()
    t.transpile(trainer_id=0, program=main, startup_program=startup,
                pservers="127.0.0.1:0", trainers=1)
    ps = t.start_pserver(t.pserver_endpoints[0], port=0, device="cpu")
    try:
        key = f"pserver:{ps.address[1]}"
        st = _get_json(dbg.address, "/statusz")
        assert st[key]["trainers"] == 1 and st[key]["round"] == 0
        ps.shutdown()
        assert key not in _get_json(dbg.address, "/statusz")
    finally:
        ps.shutdown()
        tdebug.stop_shared()
