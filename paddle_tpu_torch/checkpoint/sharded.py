"""Sharded checkpoints: one payload file PER MESH SHARD with a merged
manifest, byte for byte the layout ``paddle_tpu/checkpoint/sharded.py``
writes (``segments-<nonce>.s<K>.bin`` per shard along a mesh axis, one
``manifest.json`` indexing everything):

  - a tensor whose rule shards dim ``d`` over the shard axis lives as S
    equal slices along ``d``, slice k in shard file k, each with its own
    crc32 — a corrupt shard names the tensor AND the shard file;
  - a tensor the rules replicate (or whose dim does not divide) is
    written ONCE into shard file 0 and marked replicated — loads hand it
    to every shard;
  - COMMIT is the torn-write discipline of ``format.py``: all payloads
    written and fsynced under fresh nonces, the tmp manifest fsynced,
    the ``checkpoint.save`` fault site, one atomic ``os.replace`` — a
    crash anywhere leaves the previous checkpoint loadable, orphans
    swept by the next successful commit;
  - LOADS either REASSEMBLE (``shard=None`` — slices verified then
    stitched; the full-tree view ``load_decoder_checkpoint`` consumes,
    so a decoder saved sharded on a mesh deploys on one card) or load
    PER SHARD (``shard=k`` — only shard k's file plus the replicated
    tensors are read and verified).

``format.load_checkpoint_arrays`` delegates here when a manifest
declares ``payloads`` (plural), so every consumer — decoder deploys,
``checkpoint inspect``/``verify`` — reads sharded checkpoints
transparently.
"""
from __future__ import annotations

import json
import os
import threading
import uuid
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..distributed import faults as _faults
from ..observability import metrics as _metrics, tracing as _tracing
from ..observability.log import get_logger
from . import format as _fmt
from .errors import CheckpointCorruptError, CheckpointError

__all__ = ["save_sharded_checkpoint", "load_sharded_checkpoint",
           "load_sharded_arrays", "is_sharded_manifest"]

_log = get_logger("checkpoint")

_m_saves = _metrics.counter("checkpoint.saves")
_m_loads = _metrics.counter("checkpoint.loads")
_m_bytes_written = _metrics.counter("checkpoint.bytes_written")
_m_bytes_read = _metrics.counter("checkpoint.bytes_read")
_m_corrupt = _metrics.counter("checkpoint.corrupt")


def is_sharded_manifest(manifest: Dict[str, Any]) -> bool:
    return "payloads" in manifest


def _shard_dim(spec_entry, shard_axis: str):
    """Index of the first spec dim carrying ``shard_axis`` (None when
    the tensor replicates over it)."""
    for d, e in enumerate(spec_entry):
        if e is None:
            continue
        axes = e if isinstance(e, (tuple, list)) else (e,)
        if shard_axis in (str(a) for a in axes):
            return d
    return None


def save_sharded_checkpoint(dirname: str, tree, *, shard_axis: str,
                            mesh_spec, rules,
                            meta: Optional[Dict[str, Any]] = None) -> str:
    """Write ``tree`` as a sharded checkpoint: S = the mesh's
    ``shard_axis`` size payload files + one merged manifest. The mesh
    spec and rules ride the manifest meta (``meta['mesh']``) so a loader
    deploys the EXACT layout the exporter served. Leaves may be numpy
    arrays or torch tensors (a DTensor is gathered whole first: every
    rank of its mesh calls this, and each writes the same bytes — give
    each rank its own ``dirname``, or write from one rank after
    gathering)."""
    from ..mesh import MeshSpec, ShardingRules

    mesh_spec = MeshSpec.coerce(mesh_spec)
    rules = ShardingRules.coerce(rules)
    nshards = mesh_spec.axis_size(shard_axis)  # KeyError -> caller bug
    flat, skel = _fmt._flatten(tree)
    meta = dict(meta or {})
    meta["mesh"] = {"spec": mesh_spec.to_dict(),
                    "rules": rules.to_dict(),
                    "shard_axis": str(shard_axis)}

    os.makedirs(dirname, exist_ok=True)
    nonce = uuid.uuid4().hex[:12]
    payload_names = [f"segments-{nonce}.s{k}.bin" for k in range(nshards)]
    tensors: List[Dict[str, Any]] = []
    written = 0
    # lint: allow-blocking — commits serialize by design (format.py's
    # _commit_mu); file I/O dominates, contention is rare
    with _fmt._commit_mu, _tracing.span(
            "checkpoint.save", dir=dirname, tensors=len(flat),
            shards=nshards):
        files = [open(os.path.join(dirname, n), "wb")
                 for n in payload_names]
        offs = [0] * nshards
        try:
            for name, arr in flat.items():
                arr = np.ascontiguousarray(arr)
                spec = rules.spec_for(name, arr.ndim)
                dim = _shard_dim(tuple(spec), shard_axis)
                if dim is not None and (dim >= arr.ndim
                                        or arr.shape[dim] % nshards):
                    dim = None  # indivisible -> replicated
                entry: Dict[str, Any] = {
                    "name": name,
                    "dtype": str(arr.dtype),
                    "shape": list(arr.shape),
                }
                segs = []
                if dim is None:
                    pieces = [(0, arr)]
                else:
                    entry["dim"] = int(dim)
                    pieces = list(enumerate(np.split(arr, nshards,
                                                     axis=dim)))
                for k, piece in pieces:
                    raw = np.ascontiguousarray(piece).tobytes()
                    pad = (-offs[k]) % _fmt._ALIGN
                    if pad:
                        files[k].write(b"\0" * pad)
                        offs[k] += pad
                    files[k].write(raw)
                    segs.append({"shard": k, "offset": offs[k],
                                 "nbytes": len(raw),
                                 "crc32": zlib.crc32(raw) & 0xFFFFFFFF})
                    offs[k] += len(raw)
                    written += len(raw)
                entry["segments"] = segs
                tensors.append(entry)
            for f in files:
                f.flush()
                os.fsync(f.fileno())
        finally:
            for f in files:
                f.close()
        manifest = {
            "format": _fmt.FORMAT_VERSION,
            "payloads": payload_names,
            "shards": nshards,
            "shard_axis": str(shard_axis),
            "meta": meta,
            "tensors": tensors,
            "tree": skel,
        }
        tmp = os.path.join(
            dirname,
            f"{_fmt.MANIFEST_NAME}.tmp.{os.getpid()}."
            f"{threading.get_ident()}")
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        _faults.fire("checkpoint.save")
        os.replace(tmp, os.path.join(dirname, _fmt.MANIFEST_NAME))
        keep = set(payload_names)
        for n in os.listdir(dirname):
            stale = ((n.startswith("segments-") and n.endswith(".bin")
                      and n not in keep)
                     or n.startswith(f"{_fmt.MANIFEST_NAME}.tmp."))
            if stale:
                try:
                    os.remove(os.path.join(dirname, n))
                except OSError:  # pragma: no cover - racing GC is fine
                    pass
    _m_saves.inc()
    _m_bytes_written.inc(written)
    _log.info("sharded checkpoint committed: %s (%d tensors, %d shards, "
              "%d bytes)", dirname, len(tensors), nshards, written)
    return os.path.join(dirname, _fmt.MANIFEST_NAME)


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
