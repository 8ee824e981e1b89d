"""Sharded checkpoints, the read side: one payload file PER MESH SHARD
with a merged manifest, as ``paddle_tpu/checkpoint/sharded.py`` writes
them (``segments-<nonce>.s<K>.bin`` per shard along a mesh axis, one
``manifest.json`` indexing everything):

  - a tensor whose rule shards dim ``d`` over the shard axis lives as S
    equal slices along ``d``, slice k in shard file k, each with its own
    crc32 — a corrupt shard names the tensor AND the shard file;
  - a tensor the rules replicate is written ONCE into shard file 0 and
    marked replicated — loads hand it to every shard;
  - LOADS either REASSEMBLE (``shard=None`` — slices verified then
    stitched; the full-tree view ``load_decoder_checkpoint`` consumes,
    so a decoder saved sharded on a mesh deploys on one card) or load
    PER SHARD (``shard=k`` — only shard k's file plus the replicated
    tensors are read and verified).

``format.load_checkpoint_arrays`` delegates here when a manifest
declares ``payloads`` (plural), so every consumer — decoder deploys,
``checkpoint inspect``/``verify`` — reads sharded checkpoints
transparently. Writing one (``save_sharded_checkpoint``) needs the mesh
layer, which is not ported yet.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..observability import metrics as _metrics, tracing as _tracing
from . import format as _fmt
from .errors import CheckpointCorruptError, CheckpointError

__all__ = ["save_sharded_checkpoint", "load_sharded_checkpoint",
           "load_sharded_arrays", "is_sharded_manifest"]

_m_loads = _metrics.counter("checkpoint.loads")
_m_bytes_read = _metrics.counter("checkpoint.bytes_read")
_m_corrupt = _metrics.counter("checkpoint.corrupt")


def is_sharded_manifest(manifest: Dict[str, Any]) -> bool:
    return "payloads" in manifest


def save_sharded_checkpoint(dirname: str, tree, *, shard_axis: str,
                            mesh_spec, rules,
                            meta: Optional[Dict[str, Any]] = None) -> str:
    """The sharded WRITE side splits each tensor by the mesh's sharding
    rules (``MeshSpec`` / ``ShardingRules``), which come with the mesh
    layer — not ported to paddle_tpu_torch yet."""
    raise NotImplementedError(
        "save_sharded_checkpoint needs the mesh layer (MeshSpec, "
        "ShardingRules), which paddle_tpu_torch does not port yet — it "
        "comes with the mesh and parallel slice; save monolithic "
        "(save_checkpoint_tree / save_decoder_checkpoint)")


class _MissingPayload(CheckpointError):
    """Internal: a referenced shard file is gone — possibly a stale
    manifest racing a concurrent cross-process commit's GC (the
    monolithic loader's re-read-once recovery applies here too)."""


def _read_segment(maps, dirname, manifest, t, seg, verify: bool
                  ) -> np.ndarray:
    """One verified slice out of its shard's map (zero-copy view) —
    bounds/crc/shape checks via the shared ``format.verified_segment``
    rule."""
    name = str(t["name"])
    k = int(seg["shard"])
    if k not in maps:
        path = os.path.join(dirname, manifest["payloads"][k])
        if not os.path.exists(path):
            raise _MissingPayload(
                f"manifest references missing shard payload '{path}' — "
                "the checkpoint directory was partially deleted")
        maps[k] = _fmt.open_payload_map(path) + (path,)
    mm, size, path = maps[k]
    shape = [int(s) for s in t["shape"]]
    dim = t.get("dim")
    if dim is not None:
        shape[int(dim)] //= int(manifest["shards"])
    return _fmt.verified_segment(
        mm, size, path, name, int(seg["offset"]), int(seg["nbytes"]),
        str(t["dtype"]), shape, int(seg["crc32"]), verify,
        where=f" in shard {k}")


def load_sharded_arrays(dirname: str, shard: Optional[int] = None,
                        verify: bool = True, _manifest=None,
                        _retried: bool = False
                        ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Flat ``{name: array}`` view of a sharded checkpoint.

    ``shard=None`` REASSEMBLES global tensors (slices verified, then
    concatenated along the recorded dim — reassembly copies; replicated
    tensors stay zero-copy views). ``shard=k`` loads shard k's LOCAL
    slices (plus replicated tensors) touching only shard files 0 and k
    — the per-host path. ``_manifest`` lets ``load_checkpoint_arrays``
    hand over the manifest it already read instead of re-parsing it."""
    manifest = _manifest if _manifest is not None \
        else _fmt.read_manifest(dirname)
    if not is_sharded_manifest(manifest):
        raise CheckpointError(
            f"'{dirname}' is not a sharded checkpoint — use "
            "load_checkpoint_arrays")
    nshards = int(manifest["shards"])
    if shard is not None and not (0 <= int(shard) < nshards):
        raise CheckpointError(
            f"shard {shard} out of range: '{dirname}' has {nshards} "
            "shards")
    try:
        return _load_sharded_body(dirname, manifest, nshards, shard,
                                  verify)
    except _MissingPayload:
        if _retried:
            raise
        # a CONCURRENT cross-process save may have committed between
        # our manifest read and the payload open — its GC unlinks the
        # files our (now stale) manifest references. Re-read once: a
        # fresh manifest naming DIFFERENT payloads means the directory
        # is healthy and simply moved on (same recovery as the
        # monolithic loader); the same payloads still missing means
        # they really were deleted out from under the manifest.
        fresh = _fmt.read_manifest(dirname)
        if not is_sharded_manifest(fresh):
            # the overwriting save switched the directory to the
            # MONOLITHIC layout: a whole-tree read simply follows it;
            # a shard-k read cannot be satisfied there — that layout
            # change is worth a typed error, not a silent full load
            if shard is None:
                return _fmt.load_checkpoint_arrays(dirname,
                                                   verify=verify)
            raise CheckpointError(
                f"'{dirname}' was overwritten with a MONOLITHIC "
                f"checkpoint while loading shard {shard} — per-shard "
                "loads need the sharded layout") from None
        if fresh["payloads"] == manifest["payloads"]:
            raise
        return load_sharded_arrays(dirname, shard=shard, verify=verify,
                                   _manifest=fresh, _retried=True)


def _load_sharded_body(dirname, manifest, nshards, shard, verify):
    maps: Dict[int, Any] = {}
    out: Dict[str, np.ndarray] = {}
    read = 0
    with _tracing.span("checkpoint.load", dir=dirname,
                       tensors=len(manifest["tensors"]),
                       shards=nshards):
        for t in manifest["tensors"]:
            name = str(t["name"])
            segs = t["segments"]
            if t.get("dim") is None:
                arr = _read_segment(maps, dirname, manifest, t, segs[0],
                                    verify)
                read += int(segs[0]["nbytes"])
            elif shard is not None:
                seg = next((s for s in segs
                            if int(s["shard"]) == int(shard)), None)
                if seg is None:
                    _m_corrupt.inc()
                    raise CheckpointCorruptError(
                        f"tensor '{name}' has no slice for shard "
                        f"{shard} in '{dirname}'", tensor=name)
                arr = _read_segment(maps, dirname, manifest, t, seg,
                                    verify)
                read += int(seg["nbytes"])
            else:
                slices = []
                for seg in sorted(segs, key=lambda s: int(s["shard"])):
                    slices.append(_read_segment(maps, dirname, manifest,
                                                t, seg, verify))
                    read += int(seg["nbytes"])
                if len(slices) != nshards:
                    _m_corrupt.inc()
                    raise CheckpointCorruptError(
                        f"tensor '{name}' has {len(slices)} slices, "
                        f"manifest declares {nshards} shards",
                        tensor=name)
                arr = np.concatenate(slices, axis=int(t["dim"]))
            out[name] = arr
    _m_loads.inc()
    _m_bytes_read.inc(read)
    return out, manifest


def load_sharded_checkpoint(dirname: str, shard: Optional[int] = None,
                            verify: bool = True
                            ) -> Tuple[Any, Dict[str, Any]]:
    """Tree view (containers restored). ``shard=None`` -> the global
    tree; ``shard=k`` -> shard k's local tree, sharded tensors sliced
    along their recorded dim."""
    arrays, manifest = load_sharded_arrays(dirname, shard=shard,
                                           verify=verify)
    return _fmt.restore_tree(arrays, manifest), manifest
