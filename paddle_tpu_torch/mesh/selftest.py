"""Mesh selftest (``python -m paddle_tpu_torch.mesh --selftest``): proves
the layer's core promises without pytest — spec/rules round-trips; in a
spawned gloo world of 8 CPU ranks (a torch process drives one device) a
sharded train step on dp=2 x tp=2 x fsdp=2 matching the single-device
step, with the weight sharded by its rule, collectives counted and the
mesh in ``mesh_status()``; in a world of 2, a tp=2 decode engine serving
the single-device engine's tokens with half the kv heads a rank, and the
indivisible-kv-heads refusal; a decoder checkpoint written sharded over
tp=2, loaded whole and shard by shard, a corrupt shard named. The JAX
selftest's ``/statusz`` case waits for the port's debug server.
"""
from __future__ import annotations

import os
import shutil
import tempfile

import numpy as np

WORLD = 8
AXES = "dp=2,tp=2,fsdp=2"


def _case_spec_roundtrip():
    from . import MeshSpec

    ms = MeshSpec.parse(AXES)
    assert ms.size == 8 and ms.axis_names == ("dp", "tp", "fsdp")
    assert MeshSpec.from_dict(ms.to_dict()) == ms
    assert MeshSpec.coerce(str(ms)) == ms
    for bad in ("dp=0", "dp", "dp=x", "dp=2,dp=2"):
        try:
            MeshSpec.parse(bad)
        except ValueError:
            pass
        else:
            raise AssertionError(f"MeshSpec.parse({bad!r}) not refused")


def _case_rules():
    from ..parallel import P
    from . import ShardingRules, decoder_rules, transformer_rules

    r = transformer_rules()
    assert tuple(r.spec_for("enc0.self.q.w", 2)) == ("fsdp", "tp")
    assert tuple(r.spec_for("enc0.self.out.w_moment1_0", 2)) == \
        ("tp", "fsdp")
    assert tuple(r.spec_for("enc0.self.q.w_beta1_pow_acc_0", 0)) == ()
    rt = ShardingRules.from_dict(r.to_dict())
    assert tuple(rt.spec_for("enc0.self.q.w", 2)) == ("fsdp", "tp")
    d = decoder_rules()
    assert tuple(d.spec_for("layer0/wk", 2)) == (None, "tp")
    assert tuple(d.spec_for("layer0/ln1/0", 1)) == ()
    assert tuple(d.feed_spec(2)) == ()
    assert tuple(ShardingRules([(r"x", P("a"))], batch_axis="b")
                 .feed_spec(2)) == ("b", None)


def _build():
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import layers, unique_name

    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 11
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = layers.data(name="x", shape=[16], dtype="float32")
        y = layers.data(name="y", shape=[4], dtype="float32")
        h = layers.fc(input=x, size=32, act="tanh")
        out = layers.fc(input=h, size=4)
        loss = layers.mean(layers.square_error_cost(input=out, label=y))
        fluid.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    return main, startup, loss


def _rank_main(rank, path, out_path):
    """One rank of the sharded-train case: the single-device loss and the
    dp x tp x fsdp one from the same startup state; rank 0 writes the
    result."""
    import json

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{path}",
                            rank=rank, world_size=WORLD)
    try:
        import paddle_tpu_torch.fluid as fluid
        from paddle_tpu_torch.observability import metrics

        from ..parallel import P
        from . import MeshSpec, ShardingRules, mesh_status

        rng = np.random.RandomState(0)
        xs = rng.randn(8, 16).astype(np.float32)
        feed = {"x": xs, "y": np.tanh(xs[:, :4])}
        main, startup, loss = _build()
        cpu = fluid.Executor(fluid.CPUPlace())
        ref_scope = fluid.Scope()
        cpu.run(startup, scope=ref_scope)
        (ref,) = cpu.run(main, feed=feed, fetch_list=[loss],
                         scope=ref_scope)
        main, startup, loss = _build()
        scope = fluid.Scope()
        cpu.run(startup, scope=scope)
        rules = ShardingRules(
            rules=[(r"fc_0\.w", P("fsdp", "tp")),
                   (r"fc_1\.w", P("tp", "fsdp")),
                   (r".", P("fsdp"))],
            batch_axis="dp")
        with fluid.scope_guard(scope):
            pe = fluid.ParallelExecutor(
                use_cuda=False, loss_name=loss.name, main_program=main,
                mesh=MeshSpec.parse(AXES), sharding_plan=rules)
            (sh,) = pe.run(fetch_list=[loss], feed=feed)
        w = scope.find_var("fc_0.w_0")
        snap = metrics.snapshot("mesh.")
        result = {
            "rel": abs(float(np.ravel(sh)[0]) - float(np.ravel(ref)[0]))
            / max(abs(float(np.ravel(ref)[0])), 1e-12),
            "placements": [repr(p) for p in w.placements],
            "sharded_steps": snap["mesh.sharded_steps"],
            "all_reduce": snap["mesh.collectives.all_reduce"],
            "meshes": mesh_status()["meshes"],
        }
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(result, f)
    finally:
        dist.destroy_process_group()


def join_world(ctx, timeout_s: float):
    """Join a ``torch.multiprocessing.spawn(..., join=False)`` context:
    a rank's exception re-raises here; ranks still running after
    ``timeout_s`` are killed and the wait fails instead of hanging."""
    import time

    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.01)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise AssertionError(f"the spawned ranks did not finish in "
                                 f"{timeout_s:.0f} s")


def _case_sharded_train_parity():
    """A seeded fc Adam step on dp=2 x tp=2 x fsdp=2 (8 gloo CPU ranks)
    matches the single-device step (f32 reduction reorder tolerance)."""
    import json

    import torch.multiprocessing as mp

    d = tempfile.mkdtemp(prefix="mesh_selftest_")
    out = os.path.join(d, "result.json")
    ctx = mp.spawn(_rank_main, args=(os.path.join(d, "store"), out),
                   nprocs=WORLD, join=False)
    join_world(ctx, 300)
    with open(out) as f:
        r = json.load(f)
    assert r["rel"] < 1e-5, f"sharded-vs-single rel err {r['rel']}"
    assert r["placements"] == ["Replicate()", "Shard(dim=1)",
                               "Shard(dim=0)"], r["placements"]
    assert r["sharded_steps"] >= 1
    assert r["all_reduce"] >= 1, \
        "dp training step ran without an all-reduce?"
    assert r["meshes"].get("parallel_executor") == \
        {"dp": 2, "tp": 2, "fsdp": 2}, r["meshes"]


def _decode_rank_main(rank, path, out_path):
    """One rank of the sharded-decode case: rank 0 generates on tp=2 and
    on one device; every rank records its pool's local kv heads."""
    import json

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{path}",
                            rank=rank, world_size=2)
    try:
        from ..serving.decode import DecodeEngine, DecoderSpec

        spec = DecoderSpec(vocab=32, d_model=32, n_heads=4, n_kv_heads=4,
                           n_layers=1)
        kw = dict(slots=[1], num_pages=16, page_size=4, max_seq_len=16,
                  device="cpu")
        e1 = DecodeEngine(spec, name="st-mesh", mesh="tp=2", **kw)
        result = {"local_heads": int(e1.cache.local_pools()[0].shape[3])}
        try:
            if rank == 0:
                result["out"] = e1.generate([3, 5, 7], max_new_tokens=5)
                result["out2"] = e1.generate([1, 2], max_new_tokens=4)
                result["mesh"] = e1.stats()["mesh"]
        finally:
            e1.stop(drain=True)
        if rank == 0:
            e0 = DecodeEngine(spec, name="st-ref", mesh="", **kw)
            result["ref"] = e0.generate([3, 5, 7], max_new_tokens=5)
            e0.stop(drain=True)
        with open(f"{out_path}.{rank}", "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()


def _case_sharded_decode():
    """A tp=2 engine (2 gloo CPU ranks) serves the single-device engine's
    tokens with half the kv heads a rank; indivisible kv heads are
    refused."""
    import json

    import torch.multiprocessing as mp

    from ..serving.decode import DecodeEngine, DecoderSpec

    d = tempfile.mkdtemp(prefix="mesh_selftest_decode_")
    out = os.path.join(d, "result.json")
    try:
        ctx = mp.spawn(_decode_rank_main,
                       args=(os.path.join(d, "store"), out), nprocs=2,
                       join=False)
        join_world(ctx, 300)
        rs = []
        for r in range(2):
            with open(f"{out}.{r}") as f:
                rs.append(json.load(f))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    r0 = rs[0]
    assert r0["out"]["tokens"] == r0["ref"]["tokens"], (r0["out"], r0["ref"])
    assert r0["out2"]["tokens"]
    assert r0["mesh"] == {"tp": 2}
    assert [r["local_heads"] for r in rs] == [2, 2]
    try:
        DecodeEngine(DecoderSpec(vocab=32, d_model=48, n_heads=6,
                                 n_kv_heads=3, n_layers=1),
                     name="st-bad", mesh="tp=2", warm=False, device="cpu")
    except ValueError:
        pass
    else:
        raise AssertionError("indivisible kv heads not refused")


def _case_sharded_checkpoint():
    from ..checkpoint import (CheckpointCorruptError,
                              load_decoder_checkpoint,
                              load_sharded_checkpoint,
                              save_decoder_checkpoint)
    from ..serving.decode import DecoderSpec, build_decoder_params

    spec = DecoderSpec(vocab=32, d_model=32, n_heads=4, n_kv_heads=4,
                       n_layers=1)
    params = build_decoder_params(spec, device="cpu")
    d = tempfile.mkdtemp(prefix="mesh_selftest_ck_")
    try:
        save_decoder_checkpoint(d, spec, params, mesh_axes="tp=2",
                                shard_axis="tp")
        shard_files = [n for n in os.listdir(d) if ".s" in n]
        assert len(shard_files) == 2, shard_files
        _, loaded = load_decoder_checkpoint(d, device="cpu")
        want = params["layer0"]["wk"].numpy()
        assert np.array_equal(loaded["layer0"]["wk"].numpy(), want)
        tree1, _ = load_sharded_checkpoint(d, shard=1)
        assert np.array_equal(np.asarray(tree1["layer0"]["wk"]),
                              want[:, want.shape[1] // 2:])
        victim = os.path.join(
            d, [n for n in shard_files if ".s1." in n][0])
        with open(victim, "r+b") as f:
            f.seek(80)
            f.write(b"\xff\xfe\xfd")
        try:
            load_decoder_checkpoint(d, device="cpu")
        except CheckpointCorruptError as e:
            assert e.tensor and ".s1." in str(e), e
        else:
            raise AssertionError("corrupt shard not named")
    finally:
        shutil.rmtree(d, ignore_errors=True)


CASES = [
    ("spec_roundtrip", _case_spec_roundtrip),
    ("rules", _case_rules),
    ("sharded_train_parity", _case_sharded_train_parity),
    ("sharded_decode", _case_sharded_decode),
    ("sharded_checkpoint", _case_sharded_checkpoint),
]


def run_selftest(verbose: bool = True) -> int:
    failures = 0
    for name, fn in CASES:
        try:
            fn()
        except Exception as e:  # pragma: no cover - failure reporting
            failures += 1
            print(f"[mesh selftest] FAIL {name}: {type(e).__name__}: {e}")
        else:
            if verbose:
                print(f"[mesh selftest] ok {name}")
    if failures == 0 and verbose:
        print(f"[mesh selftest] {len(CASES)} cases OK")
    return failures
