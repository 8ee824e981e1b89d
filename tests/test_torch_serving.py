"""The port's serving front door (paddle_tpu_torch/serving server + client)
against the JAX package's, on the CPU: load_decoder, buffered and
streamed generate, every KV page back in the pool, the same tokens as the
JAX server for the same spec and prompt, typed refusals for what is not
ported yet — and the port's independence: neither the package nor
chip_smoke.py imports jax or anything of paddle_tpu.
"""
import os
import re
import subprocess
import sys

import pytest

from paddle_tpu.serving import ServingClient as JaxClient
from paddle_tpu.serving import ServingServer as JaxServer
from paddle_tpu_torch.serving import ServingClient, ServingServer
from paddle_tpu_torch.serving.errors import ModelNotFound, ServingError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            seed=11)
LOAD = dict(slots=[1, 2], page_size=4, num_pages=64, max_seq_len=32,
            prefill_chunk=8)
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8]


@pytest.fixture
def port_server():
    srv = ServingServer(device="cpu")
    cli = ServingClient(srv.serve())
    try:
        yield srv, cli
    finally:
        cli.close()
        srv.shutdown()


def test_generate_stream_and_pages_match_jax_server(port_server):
    srv, cli = port_server
    st = cli.load_decoder("gen", SPEC, **LOAD)
    assert st["device"] == "cpu" and st["spec"]["seed"] == 11
    buf = cli.generate("gen", PROMPT, max_new_tokens=8)
    assert buf["version"] == 1 and len(buf["tokens"]) == 8
    assert buf["steps_to_first_token"] == 2          # ceil(12 / 8)
    stream = cli.generate("gen", PROMPT, max_new_tokens=8, stream=True)
    assert list(stream) == buf["tokens"]
    # the repeat is a prefix-cache hit: 11 of 12 prompt tokens cached
    assert stream.result["cached_tokens"] == 11
    assert cli.list_models()["gen"]["kv"]["pages_used"] == 0
    rep = cli.load_report()["models"]["gen"]
    assert rep["live_slots"] == 0 and rep["max_slots"] == 2
    assert cli.health() == {"ok": True, "models": ["gen"]}

    jsrv = JaxServer()
    jcli = JaxClient(jsrv.serve())
    try:
        jcli.load_decoder("gen", SPEC, **LOAD)
        ref = jcli.generate("gen", PROMPT, max_new_tokens=8)
    finally:
        jcli.close()
        jsrv.shutdown()
    assert buf["tokens"] == ref["tokens"]
    assert buf["steps_to_first_token"] == ref["steps_to_first_token"]

    # hot-swap to v2 of the same model: same tokens, old pool drained
    cli.load_decoder("gen", SPEC, **LOAD)
    again = cli.generate("gen", PROMPT, max_new_tokens=8)
    assert again["version"] == 2 and again["tokens"] == buf["tokens"]
    final = cli.unload_model("gen")
    assert final["kv"]["pages_used"] == 0 and final["stopping"]


def test_unported_methods_refuse_typed(port_server):
    """Misconfigured deploys and saves refuse typed (a mesh larger than
    the process group's world, a sharded save with no rules);
    infer/load_model refuse an unknown model and a missing directory the
    way the JAX server does."""
    srv, cli = port_server
    with pytest.raises(ModelNotFound):
        cli.infer("m", {"x": [1.0]})
    with pytest.raises(RuntimeError, match="does not exist"):
        cli.load_model("m", "/nonexistent")
    with pytest.raises(RuntimeError, match="needs 2 processes"):
        cli.load_decoder("m", SPEC, mesh_axes="tp=2", **LOAD)
    from paddle_tpu_torch.checkpoint import save_sharded_checkpoint
    with pytest.raises(TypeError, match="mesh rules required"):
        save_sharded_checkpoint("/nonexistent", {}, shard_axis="tp",
                                mesh_spec="tp=2", rules=None)
    assert cli.list_models() == {}


def test_server_without_device_needs_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingServer()


def test_port_imports_neither_jax_nor_paddle_tpu():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.serving, "
            "paddle_tpu_torch.serving.__main__, paddle_tpu_torch.kernels, "
            "paddle_tpu_torch.fluid, paddle_tpu_torch.fluid.io, "
            "paddle_tpu_torch.models.resnet, paddle_tpu_torch.reader, "
            "paddle_tpu_torch.reader.creator, paddle_tpu_torch.dataset, "
            "paddle_tpu_torch.fluid.readers, "
            "paddle_tpu_torch.fluid.data_feeder, "
            "paddle_tpu_torch.models.stacked_lstm, "
            "paddle_tpu_torch.serving.workloads, "
            "paddle_tpu_torch.checkpoint, "
            "paddle_tpu_torch.checkpoint.__main__, "
            "paddle_tpu_torch.mesh, paddle_tpu_torch.mesh.__main__, "
            "paddle_tpu_torch.parallel, "
            "paddle_tpu_torch.parallel.sequence_parallel, "
            "paddle_tpu_torch.parallel.pipeline, "
            "paddle_tpu_torch.fluid.ops.pipeline_op, "
            "paddle_tpu_torch.fluid.layers.pipeline, "
            "paddle_tpu_torch.serving.lockstep, "
            "paddle_tpu_torch.fluid.parallel_executor, "
            "paddle_tpu_torch.autotune, paddle_tpu_torch.autotune.__main__, "
            "paddle_tpu_torch.fleet, paddle_tpu_torch.fleet.__main__, "
            "paddle_tpu_torch.observability.debug_server, "
            "paddle_tpu_torch.observability.timeline, "
            "paddle_tpu_torch.distributed, paddle_tpu_torch.native, "
            "paddle_tpu_torch.fluid.concurrency, "
            "paddle_tpu_torch.analysis, paddle_tpu_torch.analysis.__main__, "
            "paddle_tpu_torch.analysis.examples, "
            "paddle_tpu_torch.analysis.guards, "
            "paddle_tpu_torch.analysis.invariants, "
            "paddle_tpu_torch.analysis.locks, "
            "paddle_tpu_torch.analysis.sanitize, "
            "paddle_tpu_torch.analysis.selftest, "
            "paddle_tpu_torch.v2, paddle_tpu_torch.v2.trainer_cli, "
            "paddle_tpu_torch.v2.master, paddle_tpu_torch.compat; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'paddle_tpu.')) "
            "or m == 'paddle_tpu'); print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


_IMPORT = re.compile(
    r"^\s*(?:import\s+(?:jax|jaxlib|paddle_tpu)\b(?!_torch)"
    r"|from\s+(?:jax|jaxlib|paddle_tpu)\b(?!_torch))", re.M)
# a NotImplementedError that names the mesh layer as missing: it and its
# serving, checkpoint, sequence-parallel and pipeline parts are ported
_MESH_RAISE = re.compile(
    r"NotImplementedError\((?:[^()]|\([^()]*\))*?"
    r"(mesh layer|mesh and parallel|mesh-sharded|sharded checkpoint"
    r"|sequence parallel|pipeline|next slice)", re.S | re.I)
# a NotImplementedError that names the autotune layer as missing: the
# "auto" ladders resolve through paddle_tpu_torch/autotune
_AUTOTUNE_RAISE = re.compile(
    r"NotImplementedError\((?:[^()]|\([^()]*\))*?autotune", re.S | re.I)


def test_source_scan_finds_no_jax_or_paddle_tpu_import():
    # chip_smoke.py and the card-side A/B scripts at the repo's root
    files = [os.path.join(REPO, n) for n in (
        "chip_smoke.py", "flash_bf16_bwd_vs_old.py", "flash_wide_vs_old.py",
        "k4_splits.py", "k4_vs_old.py", "k5_tiles.py", "k5_bf16_vs_old.py")]
    for root, _, names in os.walk(os.path.join(REPO, "paddle_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    rel = {os.path.relpath(f, REPO) for f in files}
    assert {"paddle_tpu_torch/kernels/conv_bn_relu.py",
            "paddle_tpu_torch/fluid/io.py",
            "paddle_tpu_torch/models/resnet.py",
            "paddle_tpu_torch/serving/engine.py",
            "paddle_tpu_torch/serving/__main__.py",
            "paddle_tpu_torch/serving/workloads/masks.py",
            "paddle_tpu_torch/serving/workloads/base.py",
            "paddle_tpu_torch/serving/workloads/beam.py",
            "paddle_tpu_torch/checkpoint/format.py",
            "paddle_tpu_torch/checkpoint/sharded.py",
            "paddle_tpu_torch/checkpoint/decoder.py",
            "paddle_tpu_torch/checkpoint/__main__.py",
            "paddle_tpu_torch/serving/lockstep.py",
            "paddle_tpu_torch/parallel/sequence_parallel.py",
            "paddle_tpu_torch/parallel/pipeline.py",
            "paddle_tpu_torch/fluid/ops/pipeline_op.py",
            "paddle_tpu_torch/autotune/cache.py",
            "paddle_tpu_torch/autotune/ladder.py",
            "paddle_tpu_torch/autotune/measure.py",
            "paddle_tpu_torch/autotune/__main__.py",
            "paddle_tpu_torch/fleet/auth.py",
            "paddle_tpu_torch/fleet/controller.py",
            "paddle_tpu_torch/fleet/member.py",
            "paddle_tpu_torch/fleet/router.py",
            "paddle_tpu_torch/fleet/rollout.py",
            "paddle_tpu_torch/fleet/policy.py",
            "paddle_tpu_torch/fleet/launcher.py",
            "paddle_tpu_torch/fleet/__main__.py",
            "paddle_tpu_torch/observability/debug_server.py",
            "paddle_tpu_torch/observability/timeline.py",
            "paddle_tpu_torch/distributed/master.py",
            "paddle_tpu_torch/distributed/tcp_lease.py",
            "paddle_tpu_torch/distributed/election.py",
            "paddle_tpu_torch/distributed/membership.py",
            "paddle_tpu_torch/distributed/elastic.py",
            "paddle_tpu_torch/distributed/env.py",
            "paddle_tpu_torch/native/channel.py",
            "paddle_tpu_torch/native/memory.py",
            "paddle_tpu_torch/fluid/concurrency.py",
            "paddle_tpu_torch/analysis/__init__.py",
            "paddle_tpu_torch/analysis/__main__.py",
            "paddle_tpu_torch/analysis/diagnostics.py",
            "paddle_tpu_torch/analysis/examples.py",
            "paddle_tpu_torch/analysis/guards.py",
            "paddle_tpu_torch/analysis/invariants.py",
            "paddle_tpu_torch/analysis/locks.py",
            "paddle_tpu_torch/analysis/sanitize.py",
            "paddle_tpu_torch/analysis/selftest.py",
            "paddle_tpu_torch/analysis/verify.py",
            "paddle_tpu_torch/v2/__init__.py",
            "paddle_tpu_torch/v2/attr.py",
            "paddle_tpu_torch/v2/data_feeder.py",
            "paddle_tpu_torch/v2/evaluator.py",
            "paddle_tpu_torch/v2/event.py",
            "paddle_tpu_torch/v2/image.py",
            "paddle_tpu_torch/v2/inference.py",
            "paddle_tpu_torch/v2/layer.py",
            "paddle_tpu_torch/v2/minibatch.py",
            "paddle_tpu_torch/v2/networks.py",
            "paddle_tpu_torch/v2/op.py",
            "paddle_tpu_torch/v2/optimizer.py",
            "paddle_tpu_torch/v2/parameters.py",
            "paddle_tpu_torch/v2/plot.py",
            "paddle_tpu_torch/v2/topology.py",
            "paddle_tpu_torch/v2/trainer.py",
            "paddle_tpu_torch/v2/trainer_cli.py",
            "paddle_tpu_torch/v2/master/__init__.py",
            "paddle_tpu_torch/v2/master/client.py",
            "paddle_tpu_torch/compat/__init__.py",
            "paddle_tpu_torch/compat/trainer_config_helpers.py"} <= rel
    for path in files:
        with open(path) as f:
            src = f.read()
        assert not _IMPORT.search(src), path
        assert "importlib" not in src or "jax" not in src, path
        assert not _MESH_RAISE.search(src), (path, _MESH_RAISE.search(
            src).group(0)[:200])
        assert not _AUTOTUNE_RAISE.search(src), path
