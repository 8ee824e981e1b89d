"""Versioned checkpoint format: one JSON manifest + one raw-segment
payload file — the counterpart of ``paddle_tpu/checkpoint/format.py``,
byte for byte: a checkpoint either package writes, the other loads.

The reference framework's whole persistence story is "programs and
parameters are artifacts" (`fluid/io.py` save/load discipline); this
module is the parameter half done properly for serving-scale tensors:

  - the PAYLOAD (``segments-<nonce>.bin``) is every tensor's raw bytes
    back to back, 64-byte aligned, written once and never modified;
  - the MANIFEST (``manifest.json``) indexes it: per tensor the dtype,
    shape, byte offset, byte length, and a crc32 — plus the nested
    container skeleton (dict/tuple/list) the flat names were flattened
    from, and a caller ``meta`` dict (a decoder checkpoint stores its
    ``DecoderSpec`` there);
  - COMMIT is the manifest rename: payloads carry a fresh nonce per
    save and the manifest is written tmp + fsync + atomic
    ``os.replace`` (the torn-write discipline). A crash anywhere before the rename — the
    ``checkpoint.save`` fault site sits right there — leaves the
    previous manifest pointing at the previous payload, both intact;
    orphaned payloads from crashed saves are garbage-collected by the
    next successful commit;
  - LOADS are chunked-verified, zero-copy: the payload is mmap'd
    read-only, each segment's crc32 is folded in bounded chunks (no
    whole-file read), and the returned arrays are non-writeable views
    straight over the map. A truncated or bit-flipped segment
    fails with a typed error NAMING the tensor, not a shape error
    three layers into the model.
"""
from __future__ import annotations

import json
import mmap
import os
import threading
import uuid
import zlib
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..distributed import faults as _faults
from ..observability import metrics as _metrics, tracing as _tracing
from ..observability.log import get_logger
from .errors import CheckpointCorruptError, CheckpointError

__all__ = ["CheckpointError", "CheckpointCorruptError", "CheckpointWriter",
           "save_checkpoint_tree", "load_checkpoint_tree",
           "load_checkpoint_arrays", "read_manifest", "MANIFEST_NAME",
           "FORMAT_VERSION"]

_log = get_logger("checkpoint")

MANIFEST_NAME = "manifest.json"
FORMAT_VERSION = 1
# segment alignment inside the payload: mmap-view friendly for every
# numeric dtype, and matches the allocator granularity most filesystems
# round to anyway
_ALIGN = 64
# crc folding chunk: verification touches the map in bounded pieces so
# a multi-GiB tensor never needs a contiguous read buffer
_CRC_CHUNK = 1 << 20

_m_saves = _metrics.counter("checkpoint.saves")
_m_loads = _metrics.counter("checkpoint.loads")
_m_bytes_written = _metrics.counter("checkpoint.bytes_written")
_m_bytes_read = _metrics.counter("checkpoint.bytes_read")
# verification failures (crc mismatch / truncation) — the counter a
# fleet operator alerts on: a nonzero value means storage corrupted a
# deployed artifact
_m_corrupt = _metrics.counter("checkpoint.corrupt")
# incremental/delta checkpoints: tensors a delta save
# REFERENCED from its base (identical crc32) instead of rewriting —
# the rollout loop's save cost becomes proportional to what changed
_m_delta_skipped = _metrics.counter("checkpoint.delta_skipped")

# serializes whole commits (payload write -> manifest rename -> orphan
# GC) within this process:
# without it, committer A's GC could delete committer B's fully-written
# but not-yet-referenced nonce payload (or its tmp manifest), leaving
# B's manifest pointing at nothing. CROSS-process writers to one
# directory are the caller's exclusion problem — same contract as every
# one-writer artifact in this repo.
_commit_mu = threading.Lock()


# --- tree flatten / unflatten -------------------------------------------

def _flatten(tree, prefix: str = "", out: Optional[OrderedDict] = None):
    """Flatten a nested dict/tuple/list parameter tree into
    ``{"a/b/0": ndarray}`` plus a JSON-able skeleton that remembers the
    container types (tuples restore as tuples — the decoder contract's
    ``(gamma, beta)`` layer-norm pairs)."""
    if out is None:
        out = OrderedDict()
    if isinstance(tree, dict):
        skel = {}
        for k in tree:
            k = str(k)
            if "/" in k:
                raise CheckpointError(
                    f"tree key {k!r} contains '/', the flatten separator")
            _, skel[k] = _flatten(tree[k], f"{prefix}{k}/", out)
        return out, {"d": skel}
    if isinstance(tree, (tuple, list)):
        skels = []
        for i, v in enumerate(tree):
            _, s = _flatten(v, f"{prefix}{i}/", out)
            skels.append(s)
        return out, {("t" if isinstance(tree, tuple) else "l"): skels}
    # leaf: anything numpy can view as an n-d array of a plain dtype;
    # a torch tensor (on any device) is read back to the host first, a
    # DTensor whole (a collective: every rank of its mesh flattens it)
    if hasattr(tree, "full_tensor"):
        tree = tree.full_tensor()
    if hasattr(tree, "detach"):
        tree = tree.detach().cpu().numpy()
    arr = np.asarray(tree)
    if arr.dtype == object:
        raise CheckpointError(
            f"tensor '{prefix[:-1]}' has object dtype — checkpoints "
            "hold raw numeric segments only")
    name = prefix[:-1]
    out[name] = arr
    return out, name


def _unflatten(skel, arrays: Dict[str, Any]):
    if isinstance(skel, str):
        return arrays[skel]
    if "d" in skel:
        return {k: _unflatten(v, arrays) for k, v in skel["d"].items()}
    if "t" in skel:
        return tuple(_unflatten(v, arrays) for v in skel["t"])
    if "l" in skel:
        return [_unflatten(v, arrays) for v in skel["l"]]
    raise CheckpointError(f"malformed manifest tree node {skel!r}")


# --- writer -------------------------------------------------------------

class CheckpointWriter:
    """Staged, atomically-committed checkpoint writer.

    ``add()`` stages tensors (thread-safe — a sharded exporter may
    stage from several producer threads); ``commit()`` writes the
    payload + manifest with the torn-write discipline and returns the
    manifest path. A writer commits SUCCESSFULLY at most once — a
    commit that failed (ENOSPC, injected crash) leaves the staged
    tensors intact and may simply be retried.

    ``base`` (incremental checkpoints) points at an existing
    checkpoint DIRECTORY: tensors whose crc32 (and dtype/shape) equal
    the base's are not rewritten — their manifest entries carry
    ``"base": true`` and loads follow the recorded base chain. The
    crc32 index the format already keeps is exactly the change
    detector. A delta must live in its own directory (committing into
    the base's would garbage-collect the payload it references).
    """

    def __init__(self, dirname: str, meta: Optional[Dict[str, Any]] = None,
                 base: Optional[str] = None):
        self._dirname = str(dirname)
        self._meta = dict(meta or {})
        self._base = None if base is None else str(base)
        if self._base is not None:
            if os.path.realpath(self._base) == \
                    os.path.realpath(self._dirname):
                raise CheckpointError(
                    "a delta checkpoint cannot use its own directory "
                    "as its base — the commit's orphan sweep would "
                    "delete the payload it references")
            # fail early, typed: a bad base is a caller error at SAVE
            # time, not a mystery at some future load
            read_manifest(self._base)
        self._mu = threading.Lock()
        self._staged: "OrderedDict[str, np.ndarray]" = \
            OrderedDict()  # guarded-by: _mu
        self._tree_skel: Any = None  # guarded-by: _mu
        self._committed = False  # guarded-by: _mu
        self._committing = False  # guarded-by: _mu

    def add(self, name: str, array) -> None:
        """Stage one tensor under a flat name."""
        if hasattr(array, "detach"):
            array = array.detach().cpu().numpy()
        arr = np.ascontiguousarray(np.asarray(array))
        if arr.dtype == object:
            raise CheckpointError(
                f"tensor '{name}' has object dtype — checkpoints hold "
                "raw numeric segments only")
        with self._mu:
            if self._committed:
                raise CheckpointError("writer already committed")
            self._staged[str(name)] = arr

    def add_tree(self, tree) -> None:
        """Stage a whole nested parameter tree (dict/tuple/list of
        arrays); the container skeleton is recorded in the manifest so
        ``load_checkpoint_tree`` restores the exact structure."""
        flat, skel = _flatten(tree)
        with self._mu:
            if self._committed:
                raise CheckpointError("writer already committed")
            for k, v in flat.items():
                self._staged[k] = np.ascontiguousarray(v)
            self._tree_skel = skel

    def commit(self) -> str:
        """Write payload + manifest atomically; returns the manifest
        path. The ``checkpoint.save`` fault site fires between the
        fsynced tmp manifest and the committing rename — a crash there
        (chaos-tested) leaves the PREVIOUS checkpoint fully intact."""
        with self._mu:
            if self._committed:
                raise CheckpointError("writer already committed")
            if self._committing:
                raise CheckpointError("commit already in progress")
            self._committing = True
            staged = list(self._staged.items())
            skel = self._tree_skel
        try:
            if not staged:
                raise CheckpointError("nothing staged — empty checkpoint")
            dirname, meta = self._dirname, self._meta
            os.makedirs(dirname, exist_ok=True)
            # lint: allow-blocking — commits serialize by design (see
            # _commit_mu above); file I/O dominates, contention is rare
            with _commit_mu:
                path = self._commit_locked(dirname, meta, staged, skel)
        except BaseException:
            # a FAILED commit (ENOSPC, crash-site fault, ...) must not
            # poison the writer: nothing reached the manifest rename,
            # the staged tensors are intact, and a retry after the
            # operator clears the condition is the whole point of the
            # torn-write discipline.
            # Not a lost-update: only the thread that WON the first
            # section (set _committing) can reach these writes, so the
            # released-lock window has no competing writer by
            # construction.
            # lint: allow-unguarded(_committing)
            with self._mu:
                self._committing = False
            raise
        # same single-winner argument as the failure arm above
        # lint: allow-unguarded(_committed, _committing)
        with self._mu:
            self._committed = True
            self._committing = False
        return path

    def _base_index(self) -> Dict[str, Dict[str, Any]]:
        """name -> resolved (dtype/shape/crc32) entries of the base
        manifest. Base-ref entries in a delta base carry the resolved
        crc too, so delta-of-delta chains index without I/O."""
        manifest = read_manifest(self._base)
        return {str(t["name"]): t for t in manifest["tensors"]}

    def _commit_locked(self, dirname, meta, staged, skel) -> str:
        nonce = uuid.uuid4().hex[:12]
        payload_name = f"segments-{nonce}.bin"
        payload_path = os.path.join(dirname, payload_name)
        tensors: List[Dict[str, Any]] = []
        written = 0
        skipped = 0
        base_idx = self._base_index() if self._base is not None else {}
        with _tracing.span("checkpoint.save", dir=dirname,
                           tensors=len(staged)):
            # the payload's name is nonce-fresh and nothing references
            # it until the manifest rename lands, so it can be written
            # in place: a crash mid-write leaves an orphan the next
            # successful commit sweeps
            with open(payload_path, "wb") as f:
                off = 0
                for name, arr in staged:
                    raw = arr.tobytes()
                    crc = zlib.crc32(raw) & 0xFFFFFFFF
                    base_t = base_idx.get(name)
                    if base_t is not None and \
                            int(base_t["crc32"]) == crc and \
                            str(base_t["dtype"]) == str(arr.dtype) and \
                            list(base_t["shape"]) == list(arr.shape):
                        # unchanged since the base: reference, don't
                        # rewrite (the entry keeps the resolved crc/
                        # dtype/shape so chained deltas and loads can
                        # verify without touching the base first)
                        tensors.append({
                            "name": name,
                            "dtype": str(arr.dtype),
                            "shape": list(arr.shape),
                            "nbytes": len(raw),
                            "crc32": crc,
                            "base": True,
                        })
                        skipped += 1
                        continue
                    pad = (-off) % _ALIGN
                    if pad:
                        f.write(b"\0" * pad)
                        off += pad
                    f.write(raw)
                    tensors.append({
                        "name": name,
                        "dtype": str(arr.dtype),
                        "shape": list(arr.shape),
                        "offset": off,
                        "nbytes": len(raw),
                        "crc32": crc,
                    })
                    off += len(raw)
                    written += len(raw)
                f.flush()
                os.fsync(f.fileno())
            manifest = {
                "format": FORMAT_VERSION,
                "payload": payload_name,
                "meta": meta,
                "tensors": tensors,
            }
            if self._base is not None:
                # relative when possible: a checkpoint tree that moves
                # as a unit keeps working
                base_abs = os.path.abspath(self._base)
                try:
                    rel = os.path.relpath(base_abs,
                                          os.path.abspath(dirname))
                except ValueError:  # pragma: no cover - drive split
                    rel = base_abs
                manifest["base"] = rel
            if skel is not None:
                manifest["tree"] = skel
            # unique tmp per writer: a crashed commit's abandoned tmp
            # never collides with a retry's
            tmp = os.path.join(
                dirname,
                f"{MANIFEST_NAME}.tmp.{os.getpid()}.{threading.get_ident()}")
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            _faults.fire("checkpoint.save")
            os.replace(tmp, os.path.join(dirname, MANIFEST_NAME))
            self._gc(dirname, payload_name)
        _m_saves.inc()
        _m_bytes_written.inc(written)
        if skipped:
            _m_delta_skipped.inc(skipped)
        _log.info("checkpoint committed: %s (%d tensors, %d bytes"
                  "%s)", dirname, len(tensors), written,
                  f", {skipped} unchanged via base" if skipped else "")
        return os.path.join(dirname, MANIFEST_NAME)

    @staticmethod
    def _gc(dirname: str, keep_payload: str) -> None:
        """Sweep payloads/tmp manifests that crashed saves abandoned —
        only after OUR manifest committed, so a concurrent reader of
        the previous checkpoint never loses its payload mid-load within
        the same save that replaces it (readers mmap before the GC of
        the NEXT save can touch their file)."""
        for n in os.listdir(dirname):
            stale = ((n.startswith("segments-") and n.endswith(".bin")
                      and n != keep_payload)
                     or n.startswith(f"{MANIFEST_NAME}.tmp."))
            if stale:
                try:
                    os.remove(os.path.join(dirname, n))
                except OSError:  # pragma: no cover - racing GC is fine
                    pass


def save_checkpoint_tree(dirname: str, tree,
                         meta: Optional[Dict[str, Any]] = None,
                         base: Optional[str] = None) -> str:
    """One-shot: flatten + stage + commit a nested parameter tree.
    ``base`` makes it a delta save (only changed tensors written)."""
    w = CheckpointWriter(dirname, meta=meta, base=base)
    w.add_tree(tree)
    return w.commit()


# --- reader -------------------------------------------------------------

def open_payload_map(path: str):
    """mmap a payload file read-only; returns ``(map, size)``. The map
    holds its own file reference. Missing file is the caller's
    stale-manifest concern — this helper assumes existence."""
    size = os.path.getsize(path)
    f = open(path, "rb")
    try:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) \
            if size else b""
    finally:
        f.close()
    return mm, size


def verified_segment(mm, size: int, path: str, name: str, off: int,
                     nbytes: int, dtype_str: str, shape, crc32: int,
                     verify: bool, where: str = "") -> np.ndarray:
    """ONE payload segment as a zero-copy read-only view: bounds check,
    chunked crc32 fold, nbytes-vs-declared-shape check — every failure
    is ``CheckpointCorruptError`` NAMING the tensor (``where`` adds
    shard context). The one segment-verification rule both the
    monolithic and the sharded loader use, so a fix lands once."""
    if off < 0 or off + nbytes > size:
        _m_corrupt.inc()
        raise CheckpointCorruptError(
            f"tensor '{name}' is truncated{where}: segment "
            f"[{off}, {off + nbytes}) exceeds payload size "
            f"{size} ('{path}')", tensor=name)
    if verify:
        crc = 0
        for c0 in range(off, off + nbytes, _CRC_CHUNK):
            c1 = min(c0 + _CRC_CHUNK, off + nbytes)
            crc = zlib.crc32(mm[c0:c1], crc)
        if (crc & 0xFFFFFFFF) != int(crc32):
            _m_corrupt.inc()
            raise CheckpointCorruptError(
                f"tensor '{name}' failed its checksum{where} "
                f"(crc {crc & 0xFFFFFFFF:#010x} != manifest "
                f"{int(crc32):#010x}) — '{path}' is corrupt",
                tensor=name)
    dtype = np.dtype(str(dtype_str))
    count = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if count * dtype.itemsize != nbytes:
        _m_corrupt.inc()
        raise CheckpointCorruptError(
            f"tensor '{name}' declares shape {list(shape)} "
            f"({count} x {dtype}) but {nbytes} payload bytes{where}",
            tensor=name)
    return np.frombuffer(mm, dtype=dtype, count=count,
                         offset=off).reshape(shape)


def restore_tree(arrays: Dict[str, np.ndarray], manifest: Dict[str, Any]):
    """Rebuild the nested container tree a manifest's ``tree`` skeleton
    describes over a flat array map (shared by the monolithic and
    sharded tree loaders)."""
    skel = manifest.get("tree")
    if skel is None:
        return dict(arrays)
    try:
        return _unflatten(skel, arrays)
    except KeyError as e:
        raise CheckpointError(
            f"manifest tree references tensor {e.args[0]!r} that the "
            "tensor index does not declare") from e


def read_manifest(dirname: str) -> Dict[str, Any]:
    """Parse + structurally validate the manifest. Typed errors name
    the offending path; corrupt JSON is a CheckpointError, not a
    JSONDecodeError from three layers down."""
    if not os.path.isdir(dirname):
        raise CheckpointError(
            f"checkpoint directory '{dirname}' does not exist")
    path = os.path.join(dirname, MANIFEST_NAME)
    if not os.path.exists(path):
        raise CheckpointError(
            f"no manifest at '{path}' — is '{dirname}' a checkpoint "
            "directory? (save_checkpoint_tree / save_decoder_checkpoint "
            "write one)")
    try:
        with open(path, "r", encoding="utf-8") as f:
            manifest = json.load(f)
    except (ValueError, OSError) as e:
        raise CheckpointError(f"manifest '{path}' unreadable: {e}") from e
    if not isinstance(manifest, dict) or "tensors" not in manifest \
            or ("payload" not in manifest and "payloads" not in manifest):
        raise CheckpointError(f"manifest '{path}' is not a checkpoint "
                              "manifest (missing payload/tensors)")
    fmt = manifest.get("format")
    if fmt != FORMAT_VERSION:
        raise CheckpointError(
            f"manifest '{path}' has format version {fmt!r}; this "
            f"reader understands {FORMAT_VERSION}")
    return manifest


def load_checkpoint_arrays(dirname: str, verify: bool = True,
                           _depth: int = 0
                           ) -> Tuple[Dict[str, np.ndarray],
                                      Dict[str, Any]]:
    """Load the flat ``{name: array}`` map. Arrays are NON-WRITEABLE
    zero-copy views over the mmap'd payload (the map stays alive
    exactly as long as the arrays). ``verify=True`` folds each
    segment's crc32 in bounded chunks first; a mismatch or a truncated
    payload raises ``CheckpointCorruptError`` naming the tensor.
    Delta checkpoints (entries marked ``"base": true``) resolve
    through the recorded base chain; a base tensor whose bytes no
    longer match the delta's recorded crc32 is named corruption, not a
    silent weight swap."""
    if _depth > 64:
        raise CheckpointError(
            f"checkpoint base chain at '{dirname}' exceeds 64 links — "
            "circular base references?")
    manifest = read_manifest(dirname)
    if "payloads" in manifest:
        # sharded layout: one payload per mesh shard, merged
        # manifest — delegate so every flat-view consumer (decoder
        # deploys, inspect/verify) reads both layouts transparently
        # (handing over the manifest we already parsed)
        from .sharded import load_sharded_arrays

        return load_sharded_arrays(dirname, verify=verify,
                                   _manifest=manifest)
    payload_path = os.path.join(dirname, manifest["payload"])
    if not os.path.exists(payload_path):
        # a CONCURRENT cross-process save may have committed between
        # our manifest read and here — its GC unlinks the payload our
        # (now stale) manifest references. Re-read once: a fresh
        # manifest naming a DIFFERENT payload means the directory is
        # healthy and simply moved on; the same payload still missing
        # means it really was deleted out from under the manifest.
        fresh = read_manifest(dirname)
        if "payloads" in fresh:
            # the overwriting save switched the directory to the
            # SHARDED layout — delegate, same recovery contract
            from .sharded import load_sharded_arrays

            return load_sharded_arrays(dirname, verify=verify,
                                       _manifest=fresh)
        if fresh["payload"] != manifest["payload"]:
            manifest = fresh
            payload_path = os.path.join(dirname, manifest["payload"])
    if not os.path.exists(payload_path):
        raise CheckpointError(
            f"manifest references missing payload '{payload_path}' — "
            "the checkpoint directory was partially deleted")
    with _tracing.span("checkpoint.load", dir=dirname,
                       tensors=len(manifest["tensors"])):
        mm, size = open_payload_map(payload_path)
        out: Dict[str, np.ndarray] = {}
        read = 0
        base_refs: List[Dict[str, Any]] = []
        for t in manifest["tensors"]:
            name = str(t["name"])
            if t.get("base"):
                base_refs.append(t)
                continue
            nbytes = int(t["nbytes"])
            # read-only view over the map: zero-copy
            out[name] = verified_segment(
                mm, size, payload_path, name, int(t["offset"]), nbytes,
                str(t["dtype"]), t["shape"], int(t["crc32"]), verify)
            read += nbytes
        if base_refs:
            base_rec = manifest.get("base")
            if not base_rec:
                raise CheckpointError(
                    f"manifest at '{dirname}' marks "
                    f"{len(base_refs)} tensor(s) as base-resident but "
                    "records no base checkpoint")
            base_dir = base_rec if os.path.isabs(base_rec) else \
                os.path.normpath(os.path.join(dirname, base_rec))
            base_arrays, base_manifest = load_checkpoint_arrays(
                base_dir, verify=verify, _depth=_depth + 1)
            base_idx = {str(bt["name"]): bt
                        for bt in base_manifest["tensors"]}
            for t in base_refs:
                name = str(t["name"])
                arr = base_arrays.get(name)
                bt = base_idx.get(name)
                if arr is None or bt is None:
                    _m_corrupt.inc()
                    raise CheckpointCorruptError(
                        f"tensor '{name}' is recorded as unchanged "
                        f"since base '{base_dir}', which no longer "
                        "holds it", tensor=name)
                # the delta pinned the exact crc/dtype/shape it
                # skipped: compare against the BASE MANIFEST's entry —
                # the recursive load above already byte-verified the
                # base's tensors against that manifest when
                # verify=True, so an O(1) metadata comparison catches
                # a drifted/replaced base without re-hashing (and
                # without copying) the mmap'd bytes a second time
                same = (str(bt["dtype"]) == str(t["dtype"])
                        and list(bt["shape"]) == list(t["shape"])
                        and int(bt["crc32"]) == int(t["crc32"]))
                if not same:
                    _m_corrupt.inc()
                    raise CheckpointCorruptError(
                        f"tensor '{name}' in base '{base_dir}' no "
                        f"longer matches the delta's recorded "
                        f"dtype/shape/crc — the base checkpoint "
                        "drifted under its delta", tensor=name)
                out[name] = arr
    _m_loads.inc()
    _m_bytes_read.inc(read)
    return out, manifest


def load_checkpoint_tree(dirname: str, verify: bool = True
                         ) -> Tuple[Any, Dict[str, Any]]:
    """Load and restore the nested tree structure (dicts/tuples/lists
    as saved). Returns ``(tree, manifest)``."""
    arrays, manifest = load_checkpoint_arrays(dirname, verify=verify)
    return restore_tree(arrays, manifest), manifest
