"""The port's checkpoint package (paddle_tpu_torch/checkpoint) against the
JAX package's, on the CPU: the two read each other's decoder checkpoints
(monolithic, delta and sharded), write the same segment bytes, name the
tensor on corruption, and a decoder deployed from a checkpoint over RPC
serves the JAX server's tokens.

Tolerances: none — parameters, segment bytes and greedy tokens are
compared for equality (both packages draw the parameters from the same
numpy RandomState, and the format is raw bytes with a crc32 each).
"""
import json
import os

import numpy as np
import pytest
import torch

from paddle_tpu import checkpoint as jck
from paddle_tpu.serving import ServingClient as JaxClient
from paddle_tpu.serving import ServingServer as JaxServer
from paddle_tpu.serving import decode as jd
from paddle_tpu_torch import checkpoint as tck
from paddle_tpu_torch.checkpoint.__main__ import main as ck_main
from paddle_tpu_torch.serving import ServingClient, ServingServer
from paddle_tpu_torch.serving import decode as td

SPEC = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
            seed=11)
LOAD = dict(slots=[1], page_size=8, num_pages=12, max_seq_len=24,
            prefill_chunk=8)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix: np.asarray(tree.cpu() if isinstance(tree, torch.Tensor)
                               else tree)}


def _assert_params_equal(got, want):
    gf, wf = _flat(got), _flat(want)
    assert sorted(gf) == sorted(wf)
    for k in wf:
        assert gf[k].dtype == np.float32
        np.testing.assert_array_equal(gf[k], wf[k], err_msg=k)


def _manifest(d):
    with open(os.path.join(d, "manifest.json")) as f:
        return json.load(f)


def _payload(d, m):
    with open(os.path.join(d, m["payload"]), "rb") as f:
        return f.read()


def test_jax_decoder_checkpoint_loads_in_port_bitwise(tmp_path):
    d = str(tmp_path / "jax")
    jck.save_decoder_checkpoint(d, jd.DecoderSpec(**SPEC), step=7)
    spec, params = tck.load_decoder_checkpoint(d, device="cpu")
    assert spec.to_dict() == jd.DecoderSpec(**SPEC).to_dict()
    assert isinstance(params["lnf"], tuple)
    _assert_params_equal(params,
                         jd.build_decoder_params(jd.DecoderSpec(**SPEC)))
    assert ck_main(["verify", d]) == 0
    assert ck_main(["inspect", d]) == 0


@pytest.mark.parametrize("form", ["full", "delta"])
def test_port_checkpoint_loads_in_jax_and_bytes_equal(tmp_path, form):
    """The same parameters saved by each package: equal segment bytes,
    manifests equal apart from the nonce-named payload; each package
    loads the other's bitwise. ``delta`` saves a changed tensor over a
    full base (the rest become base references)."""
    spec_t, spec_j = td.DecoderSpec(**SPEC), jd.DecoderSpec(**SPEC)
    params = td.build_decoder_params(spec_t, device="cpu")
    dirs = {}
    for pkg, ck, spec in (("torch", tck, spec_t), ("jax", jck, spec_j)):
        base = str(tmp_path / pkg / "base")
        ck.save_decoder_checkpoint(base, spec, params=(
            params if pkg == "torch" else _flat_tree_np(params)))
        d = base
        if form == "delta":
            changed = dict(params, tok_emb=params["tok_emb"] * 2.0)
            d = str(tmp_path / pkg / "delta")
            ck.save_decoder_checkpoint(
                d, spec, params=(changed if pkg == "torch"
                                 else _flat_tree_np(changed)),
                base_manifest=base)
        dirs[pkg] = d
    mt, mj = _manifest(dirs["torch"]), _manifest(dirs["jax"])
    assert mt["payload"] != mj["payload"]
    assert _payload(dirs["torch"], mt) == _payload(dirs["jax"], mj)
    mt.pop("payload"), mj.pop("payload")
    assert mt == mj
    if form == "delta":
        assert sum(bool(t.get("base")) for t in mt["tensors"]) == \
            len(mt["tensors"]) - 1
    # cross loads
    jspec, jparams = jck.load_decoder_checkpoint(dirs["torch"])
    tspec, tparams = tck.load_decoder_checkpoint(dirs["jax"], device="cpu")
    assert jspec.to_dict() == tspec.to_dict() == spec_t.to_dict()
    _assert_params_equal(tparams, jparams)
    if form == "full":
        _assert_params_equal(tparams, params)


def _flat_tree_np(tree):
    """A port parameter tree as numpy arrays (what the JAX saver takes)."""
    if isinstance(tree, dict):
        return {k: _flat_tree_np(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_flat_tree_np(v) for v in tree)
    return tree.numpy()


def test_corruption_names_the_tensor_and_float64_is_refused(tmp_path):
    d = str(tmp_path / "ck")
    tck.save_decoder_checkpoint(d, td.DecoderSpec(**SPEC))
    m = _manifest(d)
    ent = next(t for t in m["tensors"] if t["name"] == "layer1/wv")
    path = os.path.join(d, m["payload"])
    with open(path, "r+b") as f:
        f.seek(ent["offset"] + 5)
        b = f.read(1)
        f.seek(ent["offset"] + 5)
        f.write(bytes([b[0] ^ 0x01]))
    for ck in (tck, jck):
        with pytest.raises(ck.CheckpointCorruptError) as e:
            ck.load_decoder_checkpoint(d, **(
                {"device": "cpu"} if ck is tck else {}))
        assert e.value.tensor == "layer1/wv" and "layer1/wv" in str(e.value)
    assert ck_main(["verify", d]) == 1
    with open(path, "r+b") as f:
        f.truncate(ent["offset"] + 8)
    with pytest.raises(tck.CheckpointCorruptError, match="truncated") as e:
        tck.load_checkpoint_arrays(d)
    assert e.value.tensor == "layer1/wv"
    # float64 weights are refused by name, never downcast
    d64 = str(tmp_path / "f64")
    params = td.build_decoder_params(td.DecoderSpec(**SPEC), device="cpu")
    params["layer0"]["w1"] = params["layer0"]["w1"].double()
    tck.save_decoder_checkpoint(d64, td.DecoderSpec(**SPEC), params=params)
    with pytest.raises(tck.CheckpointError, match="'layer0/w1'.*float64"):
        tck.load_decoder_checkpoint(d64, device="cpu")
    # a contract mismatch names the tensor before any device transfer
    tck.save_checkpoint_tree(d64, {**params, "rogue": np.zeros(2)},
                             meta=_manifest(d64)["meta"])
    with pytest.raises(tck.CheckpointError, match="rogue"):
        tck.load_decoder_checkpoint(d64, device="cpu")
    # the sharded write side: one payload a shard, the mesh recorded,
    # the tree bitwise; a shard axis with no mesh is refused
    dm = str(tmp_path / "m")
    tck.save_decoder_checkpoint(dm, td.DecoderSpec(**SPEC),
                                mesh_axes="tp=2", shard_axis="tp")
    assert len(_manifest(dm)["payloads"]) == 2
    _, back = tck.load_decoder_checkpoint(dm, device="cpu")
    _assert_params_equal(back, td.build_decoder_params(
        td.DecoderSpec(**SPEC), device="cpu"))
    with pytest.raises(tck.CheckpointError, match="needs mesh_axes"):
        tck.save_decoder_checkpoint(dm, td.DecoderSpec(**SPEC),
                                    shard_axis="tp")


def test_jax_sharded_checkpoint_loads_and_deploys_in_port(tmp_path):
    """A decoder the JAX package saved sharded over a tp=2 mesh (one
    payload per shard, a recorded mesh) loads in the port — whole and
    shard by shard — and deploys on one device (``mesh_axes=''`` over
    the recorded mesh) with the tokens of the seed-built decoder."""
    jspec = jd.DecoderSpec(**SPEC)
    d = str(tmp_path / "sharded")
    jck.save_decoder_checkpoint(d, jspec, jd.build_decoder_params(jspec),
                                mesh_axes="tp=2", shard_axis="tp")
    assert "payloads" in _manifest(d)
    spec, params = tck.load_decoder_checkpoint(d, device="cpu")
    _assert_params_equal(params, jd.build_decoder_params(jspec))
    assert tck.decoder_checkpoint_mesh(d)["spec"] == \
        jck.decoder_checkpoint_mesh(d)["spec"]
    for shard in (0, 1):
        got, _ = tck.load_sharded_arrays(d, shard=shard)
        want, _ = jck.load_sharded_arrays(d, shard=shard)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert ck_main(["verify", d]) == 0
    srv = ServingServer(device="cpu")
    cli = ServingClient(srv.serve())
    try:
        cli.load_decoder("m", checkpoint_dir=d, mesh_axes="", **LOAD)
        cli.load_decoder("seed", SPEC, **LOAD)
        out = cli.generate("m", [3, 5, 7], max_new_tokens=6)
        assert out["tokens"] == cli.generate(
            "seed", [3, 5, 7], max_new_tokens=6)["tokens"]
    finally:
        cli.close()
        srv.shutdown()


def test_load_decoder_from_checkpoint_over_rpc_matches_jax_server(
        tmp_path):
    d = str(tmp_path / "ck")
    tck.save_decoder_checkpoint(d, td.DecoderSpec(**SPEC))
    prompt = [3, 1, 4, 1, 5, 9, 2, 6, 5]
    srv = ServingServer(device="cpu")
    cli = ServingClient(srv.serve())
    try:
        st = cli.load_decoder("m", checkpoint_dir=d,
                              draft_checkpoint_dir=d, spec_k=2, **LOAD)
        assert st["spec"] == td.DecoderSpec(**SPEC).to_dict()
        assert st["spec_k"] == 2 and st["draft"]["seed"] == 11
        out = cli.generate("m", prompt, max_new_tokens=8)
        assert out["accept_rate"] == 1.0
        # a spec that contradicts the checkpoint is a wrong-model deploy
        with pytest.raises(ValueError, match="contradicts checkpoint"):
            cli.load_decoder("m2", dict(SPEC, seed=12), checkpoint_dir=d,
                             **LOAD)
        with pytest.raises(ValueError, match="spec dict or a "
                                             "checkpoint_dir"):
            cli.load_decoder("m3", **LOAD)
        m = _manifest(d)
        ent = next(t for t in m["tensors"] if t["name"] == "tok_emb")
        with open(os.path.join(d, m["payload"]), "r+b") as f:
            f.seek(ent["offset"])
            b = f.read(1)
            f.seek(ent["offset"])
            f.write(bytes([b[0] ^ 0x80]))
        with pytest.raises(tck.CheckpointCorruptError, match="tok_emb"):
            cli.load_decoder("m4", checkpoint_dir=d, **LOAD)
        with open(os.path.join(d, m["payload"]), "r+b") as f:
            f.seek(ent["offset"])
            f.write(b)
    finally:
        cli.close()
        srv.shutdown()
    jsrv = JaxServer()
    jcli = JaxClient(jsrv.serve())
    try:
        jcli.load_decoder("m", checkpoint_dir=d, **LOAD)
        ref = jcli.generate("m", prompt, max_new_tokens=8)
    finally:
        jcli.close()
        jsrv.shutdown()
    assert out["tokens"] == ref["tokens"]


def test_selftest_passes():
    assert ck_main(["--selftest"]) == 0
