"""Model persistence (reference python/paddle/fluid/io.py: save_vars:66,
save_params:132, load_*:158-234, save_inference_model:298,
load_inference_model:383) — the counterpart of ``paddle_tpu/fluid/io.py``
with the same artifacts, each readable by either package:

  - an inference model: a ``__model__`` file holding the serialized
    (pruned) ProgramDesc in the JAX package's bytes, ``__meta__.json``
    with the feed and fetch names, and the parameters in one
    ``__params__.npz`` (the save_combine path) or one ``.npy`` per var
    (the save_vars path);
  - ``save_persistables`` without a ``filename``: a checkpoint manifest
    (``checkpoint/format.py``: crc32-indexed raw segments, atomic
    commit), its meta ``{"kind": "persistables", "step": step}``;
  - ``save_checkpoint``: ``ckpt_<step>.npz`` with a ``META`` file that
    names it and holds its crc32, committed by an atomic rename and
    rotated to ``max_to_keep`` payloads.

Persistence is a program of ``save``/``load`` ops run by an Executor, as
in the reference. A scope a ParallelExecutor trained holds DTensors: the
saves write the full tensors (the bytes a single-device scope holding the
same values writes); every rank gathers, rank 0 writes and every rank
waits on a barrier. Saving needs no device: ``executor=None`` runs the save
ops on the host directly (``executor._run_io_host_ops``), never through a
fresh ``Executor()`` (which would mean the card). Loading puts each
tensor on the given executor's device (``load_checkpoint``: on
``device``, the card unless told otherwise), once.

Not ported (each raises ``NotImplementedError``):
``export_compiled_model``/``load_exported_model`` (a StableHLO artifact
is JAX's).
"""
from __future__ import annotations

import json
import os
import zlib
from typing import List, Optional

import numpy as np
import torch

from . import core
from .executor import (Scope, _run_io_host_ops, global_scope, is_writer,
                       whole, writers_done)
from .framework import Parameter, Program, Variable, default_main_program

__all__ = [
    "save_vars", "save_params", "save_persistables",
    "load_vars", "load_params", "load_persistables",
    "save_inference_model", "load_inference_model", "get_inference_program",
    "save_checkpoint", "load_checkpoint", "latest_checkpoint_step",
    "export_compiled_model", "load_exported_model",
]

MODEL_FILENAME = "__model__"
PARAMS_FILENAME = "__params__.npz"


def _norm_npz(filename: str) -> str:
    # np.savez appends '.npz' when missing; normalize so load matches save
    return filename if filename.endswith(".npz") else filename + ".npz"


def _collect(program: Program, predicate) -> List[Variable]:
    return [v for v in program.list_vars() if predicate(v)]


def is_persistable(var: Variable) -> bool:
    return var.persistable


def is_parameter(var: Variable) -> bool:
    return isinstance(var, Parameter)


def _build_save_program(var_names, dirname, filename=None) -> Program:
    """Emit a program of save / save_combine ops (reference io.py:66,145:
    persistence IS a program — it can be serialized and shipped to another
    process, which is why save_op exists as an op and not a helper)."""
    prog = Program()
    block = prog.global_block()
    if filename is not None:
        for n in var_names:
            block.create_var(name=n, shape=None, persistable=True)
        block.append_op(
            "save_combine", inputs={"X": list(var_names)}, outputs={},
            attrs={"file_path": os.path.join(dirname, _norm_npz(filename))},
        )
    else:
        for n in var_names:
            block.create_var(name=n, shape=None, persistable=True)
            block.append_op(
                "save", inputs={"X": [n]}, outputs={},
                attrs={"file_path": os.path.join(
                    dirname, n.replace("/", "__"))},
            )
    return prog


def _build_load_program(var_names, dirname, filename=None) -> Program:
    """Emit the inverse load / load_combine program (reference
    load_combine_op.cc; load_persistables)."""
    prog = Program()
    block = prog.global_block()
    if filename is not None:
        for n in var_names:
            block.create_var(name=n, shape=None, persistable=True)
        block.append_op(
            "load_combine", inputs={}, outputs={"Out": list(var_names)},
            attrs={"file_path": os.path.join(dirname, _norm_npz(filename))},
        )
    else:
        for n in var_names:
            block.create_var(name=n, shape=None, persistable=True)
            block.append_op(
                "load", inputs={}, outputs={"Out": [n]},
                attrs={"file_path": os.path.join(
                    dirname, n.replace("/", "__") + ".npy")},
            )
    return prog


def _names(vars_) -> List[str]:
    return [v.name if isinstance(v, Variable) else str(v) for v in vars_]


def save_vars(executor, dirname, main_program=None, vars=None, predicate=None,
              filename=None, scope: Optional[Scope] = None):
    """Write ``vars`` (default: ``predicate``, or every persistable var of
    ``main_program``) from ``scope`` under ``dirname``. ``executor=None``
    runs the save ops on the host: saving needs no device."""
    main_program = main_program or default_main_program()
    scope = scope or global_scope()
    if vars is None:
        vars = _collect(main_program, predicate or is_persistable)
    os.makedirs(dirname, exist_ok=True)
    prog = _build_save_program(_names(vars), dirname, filename)
    if executor is None:
        _run_io_host_ops([op.desc for op in prog.global_block().ops], scope)
    else:
        executor.run(prog, scope=scope)


def save_params(executor, dirname, main_program=None, filename=None):
    save_vars(executor, dirname, main_program, predicate=is_parameter,
              filename=filename)


def _host_array(val) -> np.ndarray:
    """A scope value as a host numpy array (a tensor on any device is
    read back; a DTensor whole, which every rank of its mesh runs)."""
    val = whole(val)
    if isinstance(val, torch.Tensor):
        return val.detach().cpu().numpy()
    return np.asarray(val)


def save_persistables(executor, dirname, main_program=None, filename=None,
                      scope: Optional[Scope] = None, step: int = 0):
    """Persist every persistable var. With ``filename`` the save_combine
    (``.npz``) path runs; WITHOUT one, the vars are written as a
    checkpoint manifest (``checkpoint/format.py``: per-tensor raw
    segments indexed by dtype/shape/offset/crc32, committed
    tmp + fsync + atomic rename), byte-compatible with the JAX package's
    (var names with '/' stored as '__'). ``load_persistables`` reads
    either form."""
    if filename is not None:
        save_vars(executor, dirname, main_program, scope=scope,
                  predicate=is_persistable, filename=filename)
        return
    from ..checkpoint.format import save_checkpoint_tree

    main_program = main_program or default_main_program()
    scope = scope or global_scope()
    arrays = {}
    for v in _collect(main_program, is_persistable):
        val = scope.find_var(v.name)
        if val is None:
            raise RuntimeError(
                f"persistable var '{v.name}' not initialized in scope — "
                "run the startup program before saving")
        arrays[v.name.replace("/", "__")] = _host_array(val)
    if is_writer():
        save_checkpoint_tree(dirname, arrays,
                             meta={"kind": "persistables", "step": int(step)})
    writers_done()


def load_vars(executor, dirname, main_program=None, vars=None, predicate=None,
              filename=None, scope: Optional[Scope] = None):
    """Read ``vars`` (default: ``predicate``, or every persistable var of
    ``main_program``) into ``scope``, each on the executor's device.
    Loading needs the executor: its device is where the tensors go."""
    if executor is None:
        raise ValueError(
            "load_vars needs the Executor whose device the loaded tensors "
            "go to (paddle_tpu_torch never picks a device for you)")
    main_program = main_program or default_main_program()
    scope = scope or global_scope()
    if vars is None:
        vars = _collect(main_program, predicate or is_persistable)
    prog = _build_load_program(_names(vars), dirname, filename)
    executor.run(prog, scope=scope)


def load_params(executor, dirname, main_program=None, filename=None):
    load_vars(executor, dirname, main_program, predicate=is_parameter,
              filename=filename)


def _to_device(arr, device) -> torch.Tensor:
    # the loaders hand out read-only views (mmap, npz): copy once
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def load_persistables(executor, dirname, main_program=None, filename=None,
                      scope: Optional[Scope] = None):
    """Inverse of save_persistables: reads the manifest form when the
    directory holds one (checksum-verified), else the per-var / ``.npz``
    op path; the tensors go to ``executor``'s device."""
    from ..checkpoint.format import MANIFEST_NAME, load_checkpoint_arrays

    if filename is None and \
            os.path.exists(os.path.join(dirname, MANIFEST_NAME)):
        if executor is None:
            raise ValueError(
                "load_persistables needs the Executor whose device the "
                "loaded tensors go to")
        main_program = main_program or default_main_program()
        scope = scope or global_scope()
        arrays, _manifest = load_checkpoint_arrays(dirname, verify=True)
        persistables = _collect(main_program, is_persistable)
        missing = sorted(v.name for v in persistables
                         if v.name.replace("/", "__") not in arrays)
        if missing:
            raise IOError(
                f"checkpoint manifest in '{dirname}' lacks persistable "
                f"var(s) {missing} that the program requires")
        for v in persistables:
            scope.set_var(v.name, _to_device(
                arrays[v.name.replace("/", "__")], executor.device))
        return
    load_vars(executor, dirname, main_program, scope=scope,
              predicate=is_persistable, filename=filename)


def _prune_for_inference(program: Program, feeded_var_names, target_vars):
    """Backward-slice the global block to ops needed for the targets
    (reference Program.prune + inference_optimize)."""
    pruned = program.clone(for_test=True)
    block = pruned.global_block()
    needed = set(_names(target_vars))
    keep = []
    for op in reversed(block.ops):
        if set(op.desc.output_names()) & needed:
            keep.append(op)
            needed.update(n for n in op.desc.input_names() if n)
    keep.reverse()
    block.ops = keep
    used = set()
    for op in keep:
        used.update(op.desc.input_names())
        used.update(op.desc.output_names())
    used.update(feeded_var_names)
    block.vars = {n: v for n, v in block.vars.items() if n in used}
    return pruned


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None):
    """reference io.py:298 — prune to feed/fetch targets, serialize program
    to `__model__`, save params from the calling thread's global scope
    (``scope_guard``) on the host."""
    main_program = main_program or default_main_program()
    os.makedirs(dirname, exist_ok=True)
    pruned = _prune_for_inference(main_program, feeded_var_names, target_vars)
    meta = {
        "feed_names": list(feeded_var_names),
        "fetch_names": _names(target_vars),
    }
    if is_writer():
        with open(os.path.join(dirname, model_filename or MODEL_FILENAME),
                  "wb") as f:
            f.write(pruned.to_bytes())
        with open(os.path.join(dirname, "__meta__.json"), "w") as f:
            json.dump(meta, f)
    params = [v for v in pruned.list_vars() if isinstance(v, Parameter) or v.persistable]
    save_vars(None, dirname, main_program, vars=params,
              filename=params_filename or PARAMS_FILENAME)
    return meta["fetch_names"]


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None,
                         scope: Optional[Scope] = None):
    """reference io.py:383 — returns (program, feed_names, fetch_vars).

    Every missing artifact fails HERE with the offending path named — not
    as a bare FileNotFoundError / KeyError from deep inside the load op.
    `scope` targets the load (default: the calling thread's global scope)
    so engines can populate private scopes without a scope_guard; the
    parameters land on ``executor``'s device."""
    if not os.path.isdir(dirname):
        raise IOError(
            f"inference model directory '{dirname}' does not exist — "
            "pass the directory given to save_inference_model")
    model_path = os.path.join(dirname, model_filename or MODEL_FILENAME)
    if not os.path.exists(model_path):
        raise IOError(
            f"no serialized program at '{model_path}' — is '{dirname}' a "
            "save_inference_model directory? (export_compiled_model "
            "artifacts are JAX StableHLO, not loadable here)")
    meta_path = os.path.join(dirname, "__meta__.json")
    if not os.path.exists(meta_path):
        raise IOError(
            f"missing feed/fetch metadata '{meta_path}' — the model "
            "directory is incomplete (was save_inference_model "
            "interrupted?)")
    with open(model_path, "rb") as f:
        program = Program.parse_from_bytes(f.read())
    with open(meta_path) as f:
        meta = json.load(f)
    persistables = [v for v in program.list_vars() if v.persistable]
    if persistables:
        params_path = os.path.join(
            dirname, _norm_npz(params_filename or PARAMS_FILENAME))
        if not os.path.exists(params_path):
            raise IOError(
                f"missing parameter payload '{params_path}' for model "
                f"directory '{dirname}'")
        with np.load(params_path) as payload:
            missing = sorted(v.name for v in persistables
                             if v.name not in payload.files)
        if missing:
            raise IOError(
                f"parameter payload '{params_path}' lacks persistable "
                f"var(s) {missing} that the program requires — the "
                "artifact was saved from a different program version")
        load_vars(executor, dirname, program, vars=persistables,
                  filename=params_filename or PARAMS_FILENAME, scope=scope)
    fetch_vars = [program.global_block().var(n) for n in meta["fetch_names"]]
    return program, meta["feed_names"], fetch_vars


def get_inference_program(target_vars, main_program=None):
    main_program = main_program or default_main_program()
    if not isinstance(target_vars, (list, tuple)):
        target_vars = [target_vars]
    return _prune_for_inference(main_program, [], target_vars)


def _not_ported(what: str, why: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"{what} is not yet ported to paddle_tpu_torch ({why})")

    fn.__name__ = what
    return fn


export_compiled_model = _not_ported(
    "export_compiled_model", "its artifact is JAX StableHLO")
load_exported_model = _not_ported(
    "load_exported_model", "its artifact is JAX StableHLO")


# --- checkpoint/resume with integrity check (Go pserver capability,
#     go/pserver/service.go:119-227) ------------------------------------
def save_checkpoint(dirname, main_program=None, step: int = 0,
                    scope: Optional[Scope] = None, max_to_keep: int = 3):
    """Write every persistable var of ``main_program`` found in ``scope``
    (parameters, optimizer accumulators, the LR schedule's step counter)
    to ``ckpt_<step>.npz``, then commit ``META`` (step, payload, crc32)
    by an atomic rename; keep the newest ``max_to_keep`` payloads, never
    dropping the one ``META`` names. The JAX package's format: either
    package resumes from the other's."""
    main_program = main_program or default_main_program()
    scope = scope or global_scope()
    os.makedirs(dirname, exist_ok=True)
    payload_path = os.path.join(dirname, f"ckpt_{step}.npz")
    arrays = {}
    for v in _collect(main_program, is_persistable):
        val = scope.find_var(v.name)
        if val is not None:
            arrays[v.name] = _host_array(val)
    if not is_writer():
        writers_done()
        return payload_path
    np.savez(payload_path, **arrays)
    with open(payload_path, "rb") as f:
        crc = zlib.crc32(f.read())
    meta = {"step": step, "payload": os.path.basename(payload_path),
            "crc32": crc}
    tmp = os.path.join(dirname, "META.tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(dirname, "META"))
    if max_to_keep > 0:
        def _step_of(f):
            try:
                return int(f[5:-4])
            except ValueError:
                return None

        current = os.path.basename(payload_path)
        ckpts = sorted(
            (f for f in os.listdir(dirname)
             if f.startswith("ckpt_") and f.endswith(".npz")
             and _step_of(f) is not None and f != current),
            key=_step_of,
        )
        for old in ckpts[:-(max_to_keep - 1) or len(ckpts)]:
            os.remove(os.path.join(dirname, old))
    writers_done()
    return payload_path


def latest_checkpoint_step(dirname) -> Optional[int]:
    """Step of the checkpoint the directory holds, or None when it holds
    no (intact) one. Recognizes both forms: ``META`` (save_checkpoint)
    and a checkpoint manifest whose meta carries a step
    (save_persistables, save_decoder_checkpoint(step=))."""
    try:
        with open(os.path.join(dirname, "META")) as f:
            return int(json.load(f)["step"])
    except (OSError, ValueError, KeyError):
        pass
    try:
        from ..checkpoint.format import read_manifest

        step = (read_manifest(dirname).get("meta") or {}).get("step")
        return None if step is None else int(step)
    except (IOError, ValueError):
        return None


def load_checkpoint(dirname, main_program=None,
                    scope: Optional[Scope] = None, device=None):
    """Verify the payload ``META`` names against its crc32 and set every
    var it holds in ``scope``, on ``device`` (None: the card, or a
    raise). Returns the checkpoint's step."""
    scope = scope or global_scope()
    dev = core.as_device(device)
    with open(os.path.join(dirname, "META")) as f:
        meta = json.load(f)
    payload_path = os.path.join(dirname, meta["payload"])
    with open(payload_path, "rb") as f:
        data = f.read()
    if zlib.crc32(data) != meta["crc32"]:
        raise IOError(f"checkpoint {payload_path} is corrupt (crc mismatch)")
    with np.load(payload_path) as payload:
        for name in payload.files:
            scope.set_var(name, _to_device(payload[name], dev))
    return meta["step"]
