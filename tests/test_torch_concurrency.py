"""The port's native channel, buddy allocator and fluid.concurrency
(``paddle_tpu_torch/native/``, ``csrc/host/``, ``fluid/concurrency.py``)
against the JAX package's native ones (``paddle_tpu/native/``, built from
``csrc/``) on the same sequences."""
import ctypes
import os
import sys
import threading
import time

import numpy as np
import pytest

import paddle_tpu.native as jnative
from paddle_tpu.native.channel import Channel as JChannel
from paddle_tpu.native.channel import ChannelClosed as JClosed
from paddle_tpu.native.memory import BuddyAllocator as JBuddy

import paddle_tpu_torch.native as tnative
from paddle_tpu_torch.native.channel import Channel as TChannel
from paddle_tpu_torch.native.channel import ChannelClosed as TClosed
from paddle_tpu_torch.native.memory import BuddyAllocator as TBuddy

PAIRS = [(JChannel, JClosed), (TChannel, TClosed)]


def _both_native():
    assert jnative.available(), "the JAX package's csrc library must build"
    assert tnative.load_native() is not None


def _script(ch_cls, closed, capacity, ops):
    """Run ``ops`` on one channel, one thread; the outcome of each."""
    ch = ch_cls(capacity)
    out = []
    for op, *arg in ops:
        if op == "send":
            out.append(("send", ch.send(*arg)))
        elif op == "try_send":
            out.append(("try_send", ch.try_send(*arg)))
        elif op == "try_recv":
            out.append(("try_recv", ch.try_recv()))
        elif op == "recv":
            try:
                out.append(("recv", ch.recv()))
            except closed:
                out.append(("recv", "ChannelClosed"))
        elif op == "size":
            out.append(("size", ch.size()))
        elif op == "close":
            ch.close()
            out.append(("close", None))
    ch.destroy()
    return out


SEQUENCES = {
    "buffered": (3, [("send", {"i": 0}), ("try_send", [1, 2]), ("size",),
                     ("try_send", "x"), ("try_send", 4), ("size",),
                     ("recv",), ("try_recv",), ("send", (5,)), ("try_recv",),
                     ("try_recv",), ("try_recv",), ("close",), ("send", 9),
                     ("try_send", 9), ("try_recv",), ("recv",), ("size",)]),
    "buffered_drain_after_close": (2, [("send", "a"), ("send", "b"),
                                       ("close",), ("recv",), ("try_recv",),
                                       ("recv",), ("try_recv",)]),
    "rendezvous_alone": (0, [("try_send", "x"), ("try_recv",), ("size",),
                             ("close",), ("try_send", "y"), ("send", "z"),
                             ("try_recv",), ("recv",)]),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_channel_sequences_match_jax(name):
    _both_native()
    cap, ops = SEQUENCES[name]
    jax_out = _script(JChannel, JClosed, cap, ops)
    port_out = _script(TChannel, TClosed, cap, ops)
    assert port_out == jax_out, (port_out, jax_out)


def _rendezvous_handoff(ch_cls):
    """try_send is 'full' until a receiver waits, then 'sent'; a blocking
    send returns only once its item was taken."""
    ch = ch_cls(0)
    events = [("try_send", ch.try_send("early"))]
    got = []
    t = threading.Thread(target=lambda: got.append(ch.recv()), daemon=True)
    t.start()
    deadline = time.monotonic() + 30
    status = "full"
    while status == "full" and time.monotonic() < deadline:
        status = ch.try_send("y")
        time.sleep(0.005)
    t.join(30)
    events.append(("try_send", status))
    events.append(("got", list(got)))
    t = threading.Thread(target=lambda: got.append(ch.recv()), daemon=True)
    t.start()
    events.append(("send", ch.send("z")))
    t.join(30)
    events.append(("got", list(got)))
    ch.destroy()
    return events


def _close_while_blocked(ch_cls, closed, capacity):
    """A thread blocked in recv on an empty channel, and one blocked in
    send on a full (or rendezvous) channel, both woken by close."""
    ch = ch_cls(capacity)
    for i in range(capacity):
        assert ch.send(i)
    res = {}

    def recv_blocked(c):
        try:
            res["recv"] = c.recv()
        except closed:
            res["recv"] = "ChannelClosed"

    empty = ch_cls(capacity)
    threads = [threading.Thread(target=recv_blocked, args=(empty,),
                                daemon=True),
               threading.Thread(target=lambda: res.update(
                   send=ch.send("blocked")), daemon=True)]
    for t in threads:
        t.start()
    time.sleep(0.1)  # let both park (a later start reaches the same end)
    empty.close()
    ch.close()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    res["drained"] = list(ch)
    ch.destroy()
    empty.destroy()
    return res


@pytest.mark.parametrize("capacity", [0, 2])
def test_channel_blocking_paths_match_jax(capacity):
    _both_native()
    (jc, jclosed), (tc, tclosed) = PAIRS
    if capacity == 0:
        assert _rendezvous_handoff(tc) == _rendezvous_handoff(jc)
    assert (_close_while_blocked(tc, tclosed, capacity)
            == _close_while_blocked(jc, jclosed, capacity))


def test_channel_stress_many_threads():
    """More producers and consumers than cores on a small buffer, with a
    short switch interval: every item arrives exactly once."""
    n_prod, n_cons, per = 16, 16, 200
    ch = TChannel(3)
    got, mu = [], threading.Lock()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def produce(p):
            for i in range(per):
                assert ch.send((p, i))

        def consume():
            for v in ch:
                with mu:
                    got.append(v)

        cons = [threading.Thread(target=consume, daemon=True)
                for _ in range(n_cons)]
        prods = [threading.Thread(target=produce, args=(p,), daemon=True)
                 for p in range(n_prod)]
        for t in cons + prods:
            t.start()
        for t in prods:
            t.join(60)
            assert not t.is_alive()
        ch.close()
        for t in cons:
            t.join(60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
        ch.destroy()
    assert sorted(got) == [(p, i) for p in range(n_prod) for i in range(per)]


def _buddy_trace(cls, guard):
    """One alloc/free sequence: after each step the block's offset (from
    the first block's address), used bytes, check(), quarantined()."""
    a = cls(1 << 14, min_block=256, guard=guard)
    trace, live, base = [], {}, None

    def state(tag, view=None):
        off = None
        if view is not None:
            addr = a._handles[id(view)][0]
            off = addr - base
        trace.append((tag, off, a.memory_usage(), a.check(),
                      a.quarantined()))

    try:
        for key, n, dtype in [("a", 100, "uint8"), ("b", 256, "uint8"),
                              ("c", 1024, "uint8"), ("d", 37, "int64"),
                              ("e", 4096, "uint8"), ("f", 8, "float32")]:
            v = a.alloc(n, dtype)
            if base is None:
                base = a._handles[id(v)][0]
            live[key] = v
            state(f"alloc {key}", v)
        for key in ("b", "d"):
            a.free(live.pop(key))
            state(f"free {key}")
        g = a.alloc(200)
        live["g"] = g
        state("alloc g", g)
        # clobber the first byte past a's request: check() sees it and
        # free() quarantines the block
        addr = a._handles[id(live["a"])][0]
        ctypes.memset(addr + 100, 0x5A, 1)
        state("clobber a")
        with pytest.raises(MemoryError, match="quarantined"):
            a.free(live.pop("a"))
        state("free a")
        trace.append(("exhausted", a.alloc(1 << 14) is None))
        with pytest.raises(ValueError):
            a.free(np.zeros(4, np.uint8))
        for key in sorted(live):
            a.free(live.pop(key))
        state("free all")
        trace.append(("total", a.total))
    finally:
        a.close()
    return trace


@pytest.mark.parametrize("guard", ["slack", "always"])
def test_buddy_counters_and_offsets_match_jax(guard):
    _both_native()
    port = _buddy_trace(TBuddy, guard)
    assert port == _buddy_trace(JBuddy, guard)
    assert port[-2][2:] == (256, 0, 256)  # a's block stays held out


def test_buddy_arena_views_are_writable_numpy():
    b = TBuddy(1 << 16)
    try:
        v = b.alloc(64, "int64")
        v[:] = np.arange(64)
        w = np.frombuffer((ctypes.c_char * 512).from_address(
            b._handles[id(v)][0]), np.int64)
        assert w.tolist() == list(range(64))
        b.free(v)
        assert b.memory_usage() == 0 and b.check() == 0
    finally:
        b.close()


def test_failed_host_build_raises_with_the_compiler_message(
        tmp_path, monkeypatch):
    """The port builds its host library or raises; it never falls back
    to Python as the JAX package does."""
    for f in os.listdir(tnative.HOST_SRC):
        (tmp_path / f).write_bytes(
            open(os.path.join(tnative.HOST_SRC, f), "rb").read())
    (tmp_path / "channel.cc").write_text(
        (tmp_path / "channel.cc").read_text() + "\nint broken( {\n")
    monkeypatch.setattr(tnative, "HOST_SRC", str(tmp_path))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed.*error:"):
        tnative.load_native()
    with pytest.raises(RuntimeError, match=r"g\+\+ failed"):
        TChannel(1)
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        TBuddy(1 << 12)


def _select_run(cc):
    a = cc.make_channel(capacity=4)
    b = cc.make_channel(capacity=4)
    with cc.Go() as g:
        g.spawn(lambda: [cc.channel_send(a, i) for i in range(3)]
                and cc.channel_close(a))
        g.spawn(lambda: [cc.channel_send(b, i * 10) for i in range(3)]
                and cc.channel_close(b))
        got = {"a": [], "b": []}
        cases = [(a, "recv"), (b, "recv")]
        while cases:
            idx, val = cc.Select(cases).run()
            ch = cases[idx][0]
            if val is None:  # closed: drop the case (Go-style)
                cases.pop(idx)
                continue
            got["a" if ch is a else "b"].append(val)
        g.join(30)
    out = cc.make_channel(capacity=0)
    taker = []
    with cc.Go() as g:
        g.spawn(lambda: taker.append(cc.channel_recv(out)))
        idx, val = cc.Select([(out, "send", "v")]).run()
        g.join(30)
    cc.channel_close(out)
    got["send_case"] = (idx, val, taker)
    got["closed_recv"] = cc.channel_recv(out)
    return got


def test_select_and_go_match_jax():
    import paddle_tpu.fluid.concurrency as jcc

    import paddle_tpu_torch.fluid.concurrency as tcc

    port = _select_run(tcc)
    assert port == _select_run(jcc)
    assert port["a"] == [0, 1, 2] and port["b"] == [0, 10, 20]
    assert port["send_case"] == (0, None, [("v", True)])
    assert isinstance(tcc.make_channel(), TChannel)


def test_go_inherits_spawner_scope():
    """Go-routines run under the scope their spawner was in (scope guards
    are per-thread; spawn captures the creator's current scope)."""
    import torch

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import concurrency as cc

    sc = fluid.Scope()
    seen = {}
    with fluid.scope_guard(sc):
        sc.set_var("x", torch.arange(3))
        g = cc.Go()

        @g
        def probe(tag):
            seen[tag] = fluid.global_scope() is sc

        probe("decorated")
        g.spawn(lambda: seen.update(spawned=fluid.global_scope().has_var(
            "x")))
    g.join(30)
    assert seen == {"decorated": True, "spawned": True}
    assert fluid.concurrency is cc
