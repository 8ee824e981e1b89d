"""The port's one-shot inference serving (paddle_tpu_torch/serving engine,
server, client, __main__) against the JAX package's, on the CPU — the
cases of tests/test_serving.py that need no StableHLO export:

  - a JAX-saved directory round-trips through ``from_inference_dir`` and
    answers what the JAX executor computed (rtol 1e-5: one small fc +
    softmax in float32);
  - bucket padding and row slicing; declared-shape fetch batching (a
    constant-leading-dim fetch comes back whole);
  - RequestTooLarge, ServerOverloaded, DeadlineExceeded;
  - hot-swap with rollback, drain of in-flight requests, and
    ``stop(drain=True)`` releasing the Program (weakref);
  - ``ServingServer(device="cpu")`` + ``load_model`` + ``infer`` over RPC
    on a JAX-saved fused cifar ResNet answer what the JAX engine answers
    (within 1e-4 of the largest probability);
  - the typed refusals: ``kind="exported"`` and ``--selftest``; the
    ``--serve`` entry point serves a model over RPC.
"""
import gc
import os
import subprocess
import sys
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import layers as jlayers
from paddle_tpu.fluid import unique_name as junique
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.serving import InferenceEngine as JaxEngine
from paddle_tpu.serving.__main__ import make_model_dir
from paddle_tpu_torch.kernels import conv_bn_relu as k5
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.serving import (
    DeadlineExceeded, InferenceEngine, ModelNotFound, ModelRegistry,
    RequestTooLarge, ServerOverloaded, ServingClient, ServingError,
    ServingServer,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5


def _engine(d, **kw):
    kw.setdefault("max_wait_ms", 1.0)
    return InferenceEngine.from_inference_dir(d, device="cpu", **kw)


def test_roundtrip_jax_saved_model(tmp_path):
    d, probe, ref = make_model_dir(str(tmp_path / "m"))
    eng = _engine(d, name="m", buckets=[4])
    try:
        got, version = eng.infer({"x": probe})
        assert version == 1
        np.testing.assert_allclose(got[0], ref, rtol=RTOL)
        # ragged sizes pad to the single bucket and slice back
        got2, _ = eng.infer({"x": probe[:3]})
        np.testing.assert_allclose(got2[0], ref[:3], rtol=RTOL)
        assert eng.stats()["batches"] == 2
    finally:
        eng.stop()


def test_bucket_padding_and_row_slicing(tmp_path):
    d, _probe, _ref = make_model_dir(str(tmp_path / "m"))
    eng = _engine(d, name="bucketed", buckets=[1, 2, 4])
    try:
        rng = np.random.RandomState(0)
        reqs = [rng.rand(b, 8).astype(np.float32)
                for b in (1, 3, 2, 4, 1, 2, 3, 4, 1, 1)]
        with ThreadPoolExecutor(max_workers=6) as pool:
            outs = list(pool.map(lambda a: eng.infer({"x": a}), reqs))
        for a, (out, _v) in zip(reqs, outs):
            alone, _ = eng.infer({"x": a})
            assert out[0].shape == (a.shape[0], 3)
            np.testing.assert_allclose(out[0], alone[0], rtol=RTOL)
        assert eng.stats()["batches"] < 2 * len(reqs)  # requests shared
    finally:
        eng.stop()


def test_constant_dim_fetch_never_missliced(tmp_path):
    """A fetch with a CONSTANT leading dim (the fc weight, (8, 3)) comes
    back WHOLE even when it coincides with the bucket."""
    main, startup, scope = jfluid.Program(), jfluid.Program(), jfluid.Scope()
    with jfluid.scope_guard(scope):
        with jfluid.program_guard(main, startup), junique.guard():
            x = jlayers.data(name="x", shape=[8], dtype="float32")
            pred = jlayers.fc(input=x, size=3, act="softmax")
        w = next(v for v in main.list_vars()
                 if v.persistable and tuple(v.shape) == (8, 3))
        exe = jfluid.Executor()
        exe.run(startup)
        d = str(tmp_path / "m")
        jfluid.save_inference_model(d, ["x"], [pred, w], exe, main)
        want_w = np.asarray(scope.find_var(w.name))
    eng = _engine(d, name="wfetch", buckets=[8])
    try:
        (got_pred, got_w), _v = eng.infer(
            {"x": np.random.RandomState(0).rand(2, 8).astype(np.float32)})
        assert got_pred.shape == (2, 3)
        assert got_w.shape == (8, 3)
        np.testing.assert_allclose(got_w, want_w, rtol=1e-6)
    finally:
        eng.stop()


def test_request_validation_and_too_large(tmp_path):
    d, probe, _ref = make_model_dir(str(tmp_path / "m"))
    eng = _engine(d, name="valid", buckets=[1, 2])
    try:
        with pytest.raises(ValueError, match="requires feed 'x'"):
            eng.infer({"y": probe})
        with pytest.raises(ValueError, match="trailing dims"):
            eng.infer({"x": np.zeros((2, 5), np.float32)})
        with pytest.raises(RequestTooLarge, match="largest bucket 2"):
            eng.infer({"x": np.zeros((3, 8), np.float32)})
        out, _ = eng.infer({"x": probe[:1].astype(np.float64)})
        assert out[0].shape == (1, 3) and out[0].dtype == np.float32
    finally:
        eng.stop()


def test_deadline_miss(tmp_path):
    d, probe, _ref = make_model_dir(str(tmp_path / "m"))
    eng = _engine(d, name="deadline", buckets=[1, 2], max_wait_ms=250.0)
    misses = metrics.counter("serving.deadline_misses")
    before = misses.value()
    try:
        with pytest.raises(DeadlineExceeded):
            eng.infer({"x": probe[:1]}, deadline_ms=20.0)
        assert misses.value() - before >= 1
    finally:
        eng.stop()


def test_overload_rejection_direct(tmp_path):
    d, probe, _ref = make_model_dir(str(tmp_path / "m"))
    eng = _engine(d, name="overload", buckets=[1, 2], max_queue=1,
                  max_wait_ms=300.0)
    overloads = metrics.counter("serving.overloads")
    before = overloads.value()
    try:
        req = eng.submit({"x": probe[:1]})
        with pytest.raises(ServerOverloaded, match="queue is full"):
            eng.submit({"x": probe[:1]})
        assert overloads.value() - before == 1
        assert req.ev.wait(10.0) and req.error is None
    finally:
        eng.stop()


def test_registry_hot_swap_rollback_and_drain(tmp_path):
    d1, probe, ref1 = make_model_dir(str(tmp_path / "v1"), scale=1.0)
    d2, _p, ref2 = make_model_dir(str(tmp_path / "v2"), scale=-1.0)
    reg = ModelRegistry()
    swaps = metrics.counter("serving.hot_swaps")
    before = swaps.value()
    reg.deploy("m", lambda: _engine(d1, name="m", version=1, buckets=[4],
                                    max_wait_ms=400.0))
    # failed build (bad directory) -> rollback: v1 keeps serving
    with pytest.raises(IOError, match="does not exist"):
        reg.deploy("m", lambda: _engine(str(tmp_path / "missing"),
                                        name="m", version=9))
    # park a request on v1's batching timer, then swap: the drain must
    # complete it with v1's weights before the old engine releases
    req = reg.get("m").submit({"x": probe})
    reg.deploy("m", lambda: _engine(d2, name="m", version=2, buckets=[4]))
    assert req.ev.wait(10.0) and req.error is None
    np.testing.assert_allclose(req.result[0], ref1, rtol=RTOL)
    out, v = reg.get("m").infer({"x": probe})
    assert v == 2
    np.testing.assert_allclose(out[0], ref2, rtol=RTOL)
    assert swaps.value() - before == 1
    with pytest.raises(ModelNotFound):
        reg.get("ghost")
    reg.unload_all()


def test_stop_drains_queue_then_releases_program(tmp_path):
    """stop(drain=True) answers everything queued, then drops the
    Program/Scope/Executor: nothing pins a retired version (weakref)."""
    d, probe, ref = make_model_dir(str(tmp_path / "m"))
    eng = _engine(d, name="m", buckets=[4], max_wait_ms=300.0)
    reqs = [eng.submit({"x": probe[i:i + 1]}) for i in range(3)]
    ref_prog = weakref.ref(eng.program)
    eng.stop(drain=True)
    for i, r in enumerate(reqs):
        assert r.ev.is_set() and r.error is None
        np.testing.assert_allclose(r.result[0], ref[i:i + 1], rtol=RTOL)
    assert eng.program is None and eng.stats()["stopping"]
    gc.collect()
    assert ref_prog() is None, "a retired engine still pins its Program"


def _jax_cifar_dir(tmp_path):
    """resnet_cifar10(depth=8, fused=True) built, initialised and saved by
    the JAX package; returns (dir, seeded images)."""
    main, startup = jfluid.Program(), jfluid.Program()
    main.random_seed = startup.random_seed = 5
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        with junique.guard(), jfluid.program_guard(main, startup):
            img = jlayers.data(name="img", shape=[3, 32, 32],
                               dtype="float32")
            prob = jlayers.softmax(jresnet.resnet_cifar10(
                img, depth=8, is_test=True, fused=True))
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        d = str(tmp_path / "cifar")
        jfluid.save_inference_model(d, ["img"], [prob], exe, main)
    images = np.random.RandomState(3).randn(6, 3, 32, 32).astype(np.float32)
    return d, images


def test_server_serves_jax_saved_resnet_like_jax_engine(tmp_path):
    d, images = _jax_cifar_dir(tmp_path)
    jeng = JaxEngine.from_inference_dir(d, name="ref", buckets=[1, 2, 4],
                                        max_wait_ms=1.0)
    try:
        want = [jeng.infer({"img": images[a:b]})[0][0]
                for a, b in ((0, 1), (1, 3), (3, 6))]
    finally:
        jeng.stop()
    srv = ServingServer(device="cpu")
    cli = ServingClient(srv.serve())
    try:
        info = cli.load_model("resnet", d, buckets=[1, 2, 4])
        assert info["version"] == 1 and info["buckets"] == [1, 2, 4]
        k5.counts.reset()
        results = [None] * 3

        def one(i, a, b):
            results[i] = cli.infer("resnet", {"img": images[a:b]})

        threads = [threading.Thread(target=one, args=(i, a, b)) for i, (a, b)
                   in enumerate(((0, 1), (1, 3), (3, 6)))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
        batches = cli.list_models()["resnet"]["batches"]
        # 9 fused convs a forward (resnet_cifar10 depth 8), all through
        # K5's plain version on the CPU
        assert k5.counts.plain_calls[k5.KERNEL] == 9 * batches
        for (out, v), w in zip(results, want):
            assert v == 1 and out[0].shape == w.shape
            assert np.abs(out[0] - w).max() <= 1e-4 * np.abs(w).max()
            np.testing.assert_array_equal(out[0].argmax(-1), w.argmax(-1))
        with pytest.raises(ModelNotFound):
            cli.infer("ghost", {"img": images[:1]})
        final = cli.unload_model("resnet")
        assert final["version"] == 1 and final["requests"] == 3
    finally:
        cli.close()
        srv.shutdown()


def test_exported_and_selftest_refuse_typed(tmp_path):
    d = tmp_path / "exported"
    d.mkdir()
    (d / "__stablehlo__.bin").write_bytes(b"")
    srv = ServingServer(device="cpu")
    cli = ServingClient(srv.serve())
    try:
        for kind in ("auto", "exported"):
            with pytest.raises(ServingError, match="StableHLO"):
                cli.load_model("x", str(d), kind=kind)
        assert cli.list_models() == {}
    finally:
        cli.close()
        srv.shutdown()
    with pytest.raises(ServingError, match="StableHLO"):
        InferenceEngine.from_exported_dir(str(d))
    from paddle_tpu_torch.serving.__main__ import main

    assert main(["--selftest"]) == 2


def test_main_without_serve_is_a_usage_error(capsys):
    """A call with neither --serve nor --selftest is a usage error that
    names --serve, not the selftest's not-ported message."""
    from paddle_tpu_torch.serving.__main__ import main

    with pytest.raises(SystemExit) as exc:
        main(["--load", "m=/nowhere"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "pass --serve" in err and "not yet ported" not in err


def test_engine_needs_one_fetch_batched_entry_per_fetch():
    """Per-row vs whole outputs come only from the declared fetch shapes;
    a list that does not cover every fetch is refused at construction."""
    from paddle_tpu_torch.serving.engine import _FeedSpec

    with pytest.raises(ValueError, match="fetch_batched has 1 entries"):
        InferenceEngine(lambda feeds, bucket: [], [_FeedSpec(
            "x", (4,), np.float32)], ["y", "z"], fetch_batched=[True])


def test_serve_entry_point_answers_over_rpc(tmp_path):
    """`python -m paddle_tpu_torch.serving --serve --load NAME=DIR` on
    the CPU: the process loads the model, prints its endpoint, and
    answers infer over RPC."""
    d, probe, ref = make_model_dir(str(tmp_path / "m"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving", "--serve",
         "--device", "cpu", "--load", f"m={d}"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving on "):
                break
        assert any(line.startswith("loaded m v1") for line in lines), lines
        host, port = lines[-1].split()[2].split(":")
        cli = ServingClient((host, int(port)))
        try:
            out, v = cli.infer("m", {"x": probe})
        finally:
            cli.close()
        assert v == 1
        np.testing.assert_allclose(out[0], ref, rtol=RTOL)
    finally:
        proc.kill()
        proc.wait(30)


def test_engine_without_device_needs_a_card(tmp_path, monkeypatch):
    """from_inference_dir(device=None) means the card: without one it
    raises instead of loading onto the CPU."""
    import torch

    d, _probe, _ref = make_model_dir(str(tmp_path / "m"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine.from_inference_dir(d)
