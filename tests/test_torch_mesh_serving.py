"""Mesh-sharded decode serving and sharded checkpoint writes in the port
(``DecodeEngine(mesh=)``, ``load_decoder(mesh_axes=)``,
``save_sharded_checkpoint``, ``save_decoder_checkpoint(mesh_axes=,
shard_axis=)``) against the port's own single-device engine and the JAX
package, on the CPU.

The sharded engines run in one spawned gloo world of two CPU ranks
(tp=2; a ``file://`` store under the test's temporary directory, one
thread a rank). Every rank builds the same engine; rank 0 takes the
requests and its scheduler drives rank 1 in lockstep. The JAX tp=2
engine runs in the pytest process on the 8-device virtual mesh. This
file imports only numpy, torch and pytest at the top, so the ranks never
import jax.

Tolerances: tokens (greedy and seeded sampling) EQUAL — the sharded step
sums its row-parallel products in another order, so equality holds where
each compared position's top-2 logit margin exceeds that error, as in
the JAX package's own tp=2 test (``tests/test_mesh.py:224-245``, whose
prompts these are). Embeddings within 1e-5. Checkpoint payloads and
manifests: bytes equal, file for file.
"""
import contextlib
import json
import os
import types

import numpy as np
import pytest
import torch

WORLD = 2
JOIN_TIMEOUT_S = 300
STOP_TIMEOUT_S = 60
SPEC = dict(vocab=32, d_model=32, n_heads=4, n_kv_heads=4, n_layers=2)
KW = dict(slots=[1, 2], num_pages=32, page_size=4, max_seq_len=32)
# a pool small enough that four growing requests preempt, prompts that
# share a prefix (prefix-cache hits), chunked prefill
CHURN_KW = dict(slots=[1, 2, 4], num_pages=14, page_size=4, max_seq_len=32,
                prefill_chunk=4, prefix_cache=True, reservation="demand")
EMBED_TOL = 1e-5


def _prompts():
    """test_mesh.py:224-245's two requests: greedy, then seeded
    sampling."""
    return [([3, 5, 7], dict(max_new_tokens=8)),
            ([9, 1], dict(max_new_tokens=6, temperature=0.7, top_k=8,
                          seed=42))]


def _churn():
    base = [5, 9, 2, 7, 3, 8, 1, 6]
    rng = np.random.RandomState(7)
    out = []
    for i in range(6):
        tail = [int(x) for x in rng.randint(1, 30, rng.randint(1, 4))]
        prompt = (base + tail) if i % 2 else tail
        out.append((prompt, int(rng.randint(12, 18))))
    return out


def _gen_all(eng, prompts):
    return [eng.generate(p, **kw)["tokens"] for p, kw in prompts]


def _run_churn(eng):
    """Submit the churn — the first request alone, so that its prompt
    pages are published before the others share them — retrying a submit
    the full pool refuses (the reservation is taken at submit) until
    earlier requests free pages."""
    import time

    from paddle_tpu_torch.serving.errors import ServerOverloaded

    reqs = []
    for i, (p, n) in enumerate(_churn()):
        if i == 2:
            assert reqs[1].ev.wait(120.0)
        while True:
            try:
                reqs.append(eng.submit(p, max_new_tokens=n))
                break
            except ServerOverloaded:
                time.sleep(0.02)
    for r in reqs:
        assert r.ev.wait(120.0)
        if r.error is not None:
            raise r.error
    return [r.result["tokens"] for r in reqs], \
        [r.result["cached_tokens"] for r in reqs]


@contextlib.contextmanager
def _engine(spec, name, **kw):
    """A sharded (tp=2 unless ``mesh`` says otherwise) engine that is
    always stopped: the leader's stop releases the follower, a failure
    stops without draining."""
    from paddle_tpu_torch.serving.decode import DecodeEngine

    kw.setdefault("mesh", "tp=2")
    e = DecodeEngine(spec, name=name, device="cpu", **kw)
    ok = False
    try:
        yield e
        ok = True
    finally:
        e.stop(drain=ok, timeout=STOP_TIMEOUT_S)


def _rank_jobs(rank, job):
    import torch.distributed as dist

    from paddle_tpu_torch.checkpoint import save_decoder_checkpoint
    from paddle_tpu_torch.flags import set_flags
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.serving import ServingClient, ServingServer
    from paddle_tpu_torch.serving.decode import DecoderSpec

    spec = DecoderSpec(**SPEC)
    draft = dict(SPEC, n_layers=1, seed=5)
    small = DecoderSpec(**dict(SPEC, n_layers=1))
    small_kw = dict(slots=[1], num_pages=16, page_size=4, max_seq_len=16)
    out = {}

    def count(name):
        return metrics.snapshot().get(name, 0)

    # (1) the two requests on tp=2
    with _engine(spec, "mtp", **KW) as e:
        out["local_pool"] = list(e.cache.local_pools()[0].shape)
        out["global_pool"] = list(e.cache.k.shape)
        out["bytes"] = [e.cache.hbm_bytes, e.cache.device_bytes]
        out["follower"] = e.is_follower
        if rank == 0:
            out["tokens"] = _gen_all(e, _prompts())
            out["stats_mesh"] = e.stats()["mesh"]
        else:
            try:
                e.generate([1, 2], max_new_tokens=2)
            except Exception as err:  # noqa: BLE001 - for the test
                out["follower_refusal"] = f"{type(err).__name__}: {err}"

    # (2) a ragged churn with prefix hits and preemption
    steps0 = count("serving.decode.steps")
    pre0 = count("serving.kv.preemptions")
    with _engine(spec, "mchurn", **CHURN_KW) as e:
        if rank == 0:
            out["churn"], out["churn_cached"] = _run_churn(e)
    out["churn_steps_metric"] = count("serving.decode.steps") - steps0
    out["churn_steps_stats"] = e.stats()["steps"]
    out["churn_preemptions"] = count("serving.kv.preemptions") - pre0

    # (3) speculation: a one-layer draft, sharded by the same rules
    with _engine(spec, "mspec", draft_spec=draft, spec_k=2, **KW) as e:
        if rank == 0:
            out["spec_tokens"] = _gen_all(e, _prompts())

    # (4) the embed lane
    with _engine(spec, "membed", embeddings=True, **KW) as e:
        if rank == 0:
            out["embed"] = e.embed([4, 8, 15, 16, 23])["embedding"]

    # (5) FLAGS['serving_mesh_axes'] is the default; '' pins one device
    set_flags({"serving_mesh_axes": "tp=2"})
    try:
        with _engine(small, "mflag", mesh=None, **small_kw) as e, \
                _engine(small, "mflag1", mesh="", warm=False,
                        **small_kw) as e1:
            out["flag_mesh"] = e.stats()["mesh"]
            out["override_mesh"] = e1.stats()["mesh"]
    finally:
        set_flags({"serving_mesh_axes": ""})

    # (6) a checkpoint that records a tp=2 mesh deploys sharded through
    # the server: every rank runs the same deploy, rank 0 answers
    ck = os.path.join(job, "recorded")
    if rank == 0:
        save_decoder_checkpoint(ck, spec, mesh_axes="tp=2")
    dist.barrier()
    srv = ServingServer(device="cpu")
    cli = ServingClient(srv.serve())
    try:
        st = cli.load_decoder("m", checkpoint_dir=ck, **KW)
        out["deploy_mesh"] = st["mesh"]
        if rank == 0:
            out["deploy_tokens"] = cli.generate("m", [3, 5, 7],
                                                max_new_tokens=8)["tokens"]
            out["report_mesh"] = \
                cli.load_report()["models"]["m"].get("mesh")
        out["unload_pages_used"] = \
            cli.unload_model("m")["kv"]["pages_used"]
    finally:
        cli.close()
        srv.shutdown()

    if rank == 0:
        # the same requests on one device
        with _engine(spec, "mref", mesh="", **KW) as e:
            out["ref_tokens"] = _gen_all(e, _prompts())
        with _engine(spec, "mref_churn", mesh="", **CHURN_KW) as e:
            out["ref_churn"], _ = _run_churn(e)
        with _engine(spec, "mref_spec", mesh="", draft_spec=draft,
                     spec_k=2, **KW) as e:
            out["ref_spec_tokens"] = _gen_all(e, _prompts())
        with _engine(spec, "mref_embed", mesh="", embeddings=True,
                     **KW) as e:
            out["ref_embed"] = e.embed([4, 8, 15, 16, 23])["embedding"]
    return out


def _rank_main(rank, store, job):
    import logging

    torch.set_num_threads(1)
    logging.getLogger("torch.distributed").setLevel(logging.ERROR)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    try:
        out = _rank_jobs(rank, job)
        with open(os.path.join(job, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import time

    import torch.multiprocessing as mp

    job = str(tmp_path_factory.mktemp("mesh_serving"))
    ctx = mp.spawn(_rank_main, args=(os.path.join(job, "store"), job),
                   nprocs=WORLD, join=False)
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.01)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            pytest.fail(f"the spawned ranks did not finish in "
                        f"{JOIN_TIMEOUT_S} s")
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(job, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return types.SimpleNamespace(job=job, ranks=ranks)


def _jax_tp2_tokens():
    """The JAX package's tp=2 engine on the same requests."""
    from paddle_tpu.serving.decode import DecodeEngine, DecoderSpec

    e = DecodeEngine(DecoderSpec(**SPEC), name="jtp", mesh="tp=2", **KW)
    try:
        return [e.generate(p, **kw)["tokens"] for p, kw in _prompts()]
    finally:
        e.stop(drain=True)


def test_sharded_tokens_match_single_device_and_jax_tp2(world):
    r0, r1 = world.ranks
    assert r0["tokens"] == r0["ref_tokens"], (r0["tokens"], r0["ref_tokens"])
    assert r0["tokens"] == _jax_tp2_tokens()
    assert r0["stats_mesh"] == {"tp": 2}
    assert not r0["follower"] and r1["follower"]
    assert "rank 0" in r1["follower_refusal"]


def test_pool_holds_half_the_kv_heads_on_each_rank(world):
    for r in world.ranks:
        assert r["global_pool"][3] == SPEC["n_kv_heads"]
        assert r["local_pool"][3] == SPEC["n_kv_heads"] // 2
        assert r["local_pool"][:3] == r["global_pool"][:3]
        hbm, dev = r["bytes"]
        assert dev * 2 == hbm


def test_followers_step_with_the_leader_through_a_churn(world):
    """Prefix hits and preemptions included: the follower's pools see
    every page move (the tokens equal the single-device engine's only if
    rank 1's heads are right), and its serving.decode.steps equals the
    leader's."""
    r0, r1 = world.ranks
    assert r0["churn"] == r0["ref_churn"]
    assert max(r0["churn_cached"]) > 0
    assert r0["churn_preemptions"] > 0
    assert r0["churn_steps_metric"] == r1["churn_steps_metric"] > 0
    assert r0["churn_steps_stats"] == r1["churn_steps_stats"] \
        == r0["churn_steps_metric"]


def test_speculation_and_embed_lane_run_sharded(world):
    r0 = world.ranks[0]
    assert r0["spec_tokens"] == r0["ref_spec_tokens"]
    np.testing.assert_allclose(r0["embed"], r0["ref_embed"], atol=EMBED_TOL,
                               rtol=0)


def test_flag_default_and_empty_override(world):
    for r in world.ranks:
        assert r["flag_mesh"] == {"tp": 2}
        assert r["override_mesh"] is None


def test_recorded_mesh_deploys_sharded_through_the_server(world):
    r0, r1 = world.ranks
    assert r0["deploy_mesh"] == r1["deploy_mesh"] == {"tp": 2}
    assert r0["report_mesh"] == {"tp": 2}
    assert r0["deploy_tokens"] == r0["ref_tokens"][0]
    assert r0["unload_pages_used"] == 0


def test_mesh_refusals_are_value_errors():
    """tests/test_mesh.py:290-301 on the port: kv heads that do not divide
    the shard degree, and rules naming an axis the mesh lacks — both
    refused before any process group is needed."""
    from paddle_tpu_torch.serving.decode import DecodeEngine, DecoderSpec

    with pytest.raises(ValueError, match="kv heads"):
        DecodeEngine(DecoderSpec(**dict(SPEC, d_model=48, n_heads=6,
                                        n_kv_heads=3, n_layers=1)),
                     name="mbad", mesh="tp=2", warm=False, device="cpu")
    with pytest.raises(ValueError, match="does not have"):
        DecodeEngine(DecoderSpec(**dict(SPEC, n_layers=1)), name="mbad2",
                     mesh="dp=2", warm=False, device="cpu")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _leaves(tree[key], f"{prefix}{key}/").items()}
    if isinstance(tree, (tuple, list)):
        return {k: v for i, x in enumerate(tree)
                for k, v in _leaves(x, f"{prefix}{i}/").items()}
    return {prefix: tree}


def _payloads(d):
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    blobs = []
    for name in manifest["payloads"]:
        with open(os.path.join(d, name), "rb") as f:
            blobs.append(f.read())
    manifest.pop("payloads")
    return manifest, blobs


@pytest.mark.parametrize("what", ["tree", "decoder"])
def test_sharded_checkpoint_bytes_equal_jax(tmp_path, what):
    """The same tree (or seed decoder), mesh spec and rules through both
    packages: each shard's payload and the manifest (payload names aside:
    they carry a fresh nonce) are equal, byte for byte."""
    from paddle_tpu import checkpoint as jck
    from paddle_tpu.mesh import decoder_rules as jrules
    from paddle_tpu.serving import decode as jd
    from paddle_tpu_torch import checkpoint as tck
    from paddle_tpu_torch.mesh import decoder_rules as trules

    dj, dt = str(tmp_path / "j"), str(tmp_path / "t")
    if what == "tree":
        rng = np.random.RandomState(3)
        tree = {"layer0": {"wk": rng.randn(8, 16).astype(np.float32),
                           "ln1": (np.arange(8, dtype=np.float32),
                                   np.zeros(8, np.float32))},
                "tok_emb": rng.randn(10, 8).astype(np.float32),
                "odd": rng.randn(6, 3).astype(np.float32)}
        jck.save_sharded_checkpoint(dj, tree, shard_axis="tp",
                                    mesh_spec="tp=4", rules=jrules())
        tck.save_sharded_checkpoint(dt, tree, shard_axis="tp",
                                    mesh_spec="tp=4", rules=trules())
    else:
        spec = dict(SPEC, seed=3)
        jck.save_decoder_checkpoint(dj, jd.DecoderSpec(**spec),
                                    mesh_axes="dp=1,tp=2", shard_axis="tp")
        from paddle_tpu_torch.serving.decode import DecoderSpec

        tck.save_decoder_checkpoint(dt, DecoderSpec(**spec),
                                    mesh_axes="dp=1,tp=2", shard_axis="tp")
    mj, bj = _payloads(dj)
    mt, bt = _payloads(dt)
    assert mt == mj
    assert len(bt) == len(bj) == mt["shards"]
    for k, (a, b) in enumerate(zip(bt, bj)):
        assert a == b, f"shard {k} differs"


def test_corrupt_shard_is_named_and_torn_save_keeps_previous(tmp_path):
    from paddle_tpu_torch import checkpoint as tck
    from paddle_tpu_torch.distributed import faults
    from paddle_tpu_torch.serving.decode import DecoderSpec

    spec = DecoderSpec(**SPEC)
    d = str(tmp_path / "ck")
    tck.save_decoder_checkpoint(d, spec, mesh_axes="tp=2", shard_axis="tp")
    before = sorted(os.listdir(d))
    _, params = tck.load_decoder_checkpoint(d, device="cpu")
    # a torn second save (crash at the commit point) leaves the first
    # loadable, bitwise
    other = DecoderSpec(**dict(SPEC, seed=99))
    with faults.scoped("crash@checkpoint.save:0"):
        with pytest.raises(Exception):
            tck.save_decoder_checkpoint(d, other, mesh_axes="tp=2",
                                        shard_axis="tp")
    _, again = tck.load_decoder_checkpoint(d, device="cpu")
    assert _leaves(again).keys() == _leaves(params).keys()
    for k, v in _leaves(params).items():
        assert torch.equal(v, _leaves(again)[k]), k
    # the next good save sweeps the torn save's orphans
    tck.save_decoder_checkpoint(d, spec, mesh_axes="tp=2", shard_axis="tp")
    assert len(sorted(os.listdir(d))) == len(before)
    # flip one byte of shard 1: the load names the tensor and the shard
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    ent = next(t for t in manifest["tensors"] if t["name"] == "layer0/wk")
    seg = next(s for s in ent["segments"] if s["shard"] == 1)
    path = os.path.join(d, manifest["payloads"][1])
    with open(path, "r+b") as f:
        f.seek(seg["offset"] + 5)
        byte = f.read(1)
        f.seek(seg["offset"] + 5)
        f.write(bytes([byte[0] ^ 0xFF]))
    with pytest.raises(tck.CheckpointCorruptError,
                       match=r"layer0/wk.*shard 1") as e:
        tck.load_decoder_checkpoint(d, device="cpu")
    assert e.value.tensor == "layer0/wk"
