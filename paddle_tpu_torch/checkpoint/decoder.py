"""Decoder checkpoints: persist/restore the ``DecoderSpec`` /
``decoder_step`` parameter-tree contract (the counterpart of
``paddle_tpu/checkpoint/decoder.py``; the two packages read each other's
checkpoints).

``save_decoder_checkpoint`` writes the spec into the manifest's meta
and the parameter tree into the payload; ``load_decoder_checkpoint``
restores both and VALIDATES the tensor set against the spec before
anything touches a device — a missing, extra, or wrong-shape tensor is
a typed error naming the tensor, never a shape error three layers into
``decoder_step``. Round-trips are bitwise: a loaded decoder serves
exactly the tokens the saving engine served."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from .errors import CheckpointError
from .format import _flatten, load_checkpoint_tree, save_checkpoint_tree

__all__ = ["save_decoder_checkpoint", "load_decoder_checkpoint",
           "expected_decoder_tensors", "decoder_checkpoint_mesh"]


def expected_decoder_tensors(spec) -> Dict[str, Tuple[int, ...]]:
    """Flat ``{name: shape}`` the decoder param-tree contract implies
    for ``spec`` — computed analytically (no parameter draws), so
    validation is cheap even for models whose seed-build would not be.
    The names mirror ``build_decoder_params``'s tree under the
    ``format._flatten`` scheme (tuples index as ``/0``, ``/1``)."""
    dm, dh = spec.d_model, spec.head_dim
    out: Dict[str, Tuple[int, ...]] = {
        "tok_emb": (spec.vocab, dm),
        "lnf/0": (dm,),
        "lnf/1": (dm,),
    }
    for l in range(spec.n_layers):
        p = f"layer{l}"
        out[f"{p}/ln1/0"] = (dm,)
        out[f"{p}/ln1/1"] = (dm,)
        out[f"{p}/wq"] = (dm, spec.n_heads * dh)
        out[f"{p}/wk"] = (dm, spec.n_kv_heads * dh)
        out[f"{p}/wv"] = (dm, spec.n_kv_heads * dh)
        out[f"{p}/wo"] = (spec.n_heads * dh, dm)
        out[f"{p}/ln2/0"] = (dm,)
        out[f"{p}/ln2/1"] = (dm,)
        out[f"{p}/w1"] = (dm, 4 * dm)
        out[f"{p}/w2"] = (4 * dm, dm)
    return out


def save_decoder_checkpoint(dirname: str, spec,
                            params: Optional[Dict[str, Any]] = None,
                            step: Optional[int] = None,
                            base_manifest: Optional[str] = None,
                            mesh_axes: Optional[Any] = None,
                            mesh_rules: Optional[Any] = None,
                            shard_axis: Optional[str] = None) -> str:
    """Persist a decoder (spec + parameter tree) as a manifest
    checkpoint. ``params=None`` saves the spec's deterministic
    seed-built tree (built on the CPU); an engine passes its own tree of
    tensors (read back from any device). ``step`` (optional) rides the
    meta. ``base_manifest`` names a prior decoder checkpoint DIRECTORY:
    only tensors whose crc32 differs from the base are written — the
    rest become base references the loader follows.

    ``mesh_axes`` RECORDS the serving mesh in the manifest meta —
    ``load_decoder(checkpoint_dir=)`` then deploys the engine sharded as
    exported; ``mesh_rules`` overrides the default
    ``mesh.decoder_rules``. ``shard_axis`` additionally writes the
    SHARDED payload layout (one file per shard of that mesh axis, merged
    manifest); it requires ``mesh_axes`` and is incompatible with
    ``base_manifest`` (delta chains are a monolithic-layout feature).
    A sharded engine's params (DTensors) are gathered whole first, a
    collective every rank of the mesh must join."""
    if params is None:
        from ..serving.decode import build_decoder_params

        params = build_decoder_params(spec, device="cpu")
    meta: Dict[str, Any] = {"kind": "decoder", "spec": spec.to_dict()}
    if step is not None:
        meta["step"] = int(step)
    if shard_axis is not None and mesh_axes is None:
        raise CheckpointError(
            "shard_axis needs mesh_axes — the shard count is that mesh "
            "axis's size")
    if mesh_axes is not None:
        from ..mesh import MeshSpec, ShardingRules, decoder_rules

        ms = MeshSpec.coerce(mesh_axes)
        rules = ShardingRules.coerce(mesh_rules, default=decoder_rules)
        if shard_axis is not None:
            if base_manifest is not None:
                raise CheckpointError(
                    "sharded decoder checkpoints do not support "
                    "base_manifest deltas — save monolithic or full")
            from .sharded import save_sharded_checkpoint

            # the JAX package hands the splitter its tree after a
            # jax.tree_util map, which orders every dict's keys: the same
            # order here keeps the bytes equal
            return save_sharded_checkpoint(
                dirname, _sorted_tree(params), shard_axis=str(shard_axis),
                mesh_spec=ms, rules=rules, meta=meta)
        meta["mesh"] = {"spec": ms.to_dict(), "rules": rules.to_dict()}
    return save_checkpoint_tree(dirname, params, meta=meta,
                                base=base_manifest)


def _sorted_tree(tree):
    """``tree`` with every dict's keys in sorted order (tuples and lists
    kept as they are)."""
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_sorted_tree(v) for v in tree)
    return tree


def decoder_checkpoint_mesh(dirname: str) -> Optional[Dict[str, Any]]:
    """The mesh a decoder checkpoint RECORDED at export (``{"spec":
    MeshSpec dict, "rules": ShardingRules dict}``), or None for
    single-chip artifacts. Reads only the manifest — no payload I/O."""
    from .format import read_manifest

    manifest = read_manifest(dirname)
    meta = manifest.get("meta") or {}
    return meta.get("mesh")


def load_decoder_checkpoint(dirname: str, verify: bool = True,
                            device=None):
    """Restore ``(DecoderSpec, params)`` from a decoder checkpoint
    (either package's, monolithic or sharded). The params come back as
    float32 torch tensors on ``device`` (None = the card; it raises
    without one), ready for ``DecodeEngine(..., params=)``; the tensor
    set is validated against the spec FIRST (names, shapes, float32),
    so a wrong-model or hand-edited checkpoint fails with the offending
    tensor named."""
    import torch

    from ..device import resolve_device
    from ..serving.decode import DecoderSpec

    dev = resolve_device(device)
    tree, manifest = load_checkpoint_tree(dirname, verify=verify)
    meta = manifest.get("meta") or {}
    if meta.get("kind") != "decoder":
        raise CheckpointError(
            f"'{dirname}' is a {meta.get('kind') or 'generic'} "
            "checkpoint, not a decoder checkpoint (no DecoderSpec in "
            "its meta)")
    spec = DecoderSpec.from_dict(dict(meta["spec"]))

    # validate the FLAT view against the analytic contract before any
    # device transfer
    flat, _skel = _flatten(tree)
    want = expected_decoder_tensors(spec)
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise CheckpointError(
            f"decoder checkpoint '{dirname}' does not match its spec's "
            f"parameter contract: missing {missing or 'none'}, "
            f"unexpected {extra or 'none'}")
    for name, shape in want.items():
        got = tuple(flat[name].shape)
        if got != shape:
            raise CheckpointError(
                f"tensor '{name}' in '{dirname}' has shape {got}, "
                f"spec requires {shape}")
        dt = np.dtype(flat[name].dtype)
        if dt != np.float32:
            # refuse, don't downcast: a float64 (or quantized) tree
            # squeezed into float32 would serve other tokens than the
            # saved model's — the bitwise round trip dies without a
            # named error
            raise CheckpointError(
                f"tensor '{name}' in '{dirname}' is {dt}, the decoder "
                f"contract serves float32 — convert at save time, "
                "never implicitly at deploy")

    def to_device(node):
        if isinstance(node, dict):
            return {k: to_device(v) for k, v in node.items()}
        if isinstance(node, tuple):
            return tuple(to_device(v) for v in node)
        if isinstance(node, list):
            return [to_device(v) for v in node]
        # the loaded arrays are read-only views over the mmap'd payload:
        # copy out before handing them to torch
        return torch.from_numpy(np.array(node, copy=True)).to(dev)

    return spec, to_device(tree)
