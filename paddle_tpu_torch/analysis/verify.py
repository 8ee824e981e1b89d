"""Program verifier — IR well-formedness checks between graph
construction and execution, the port's copy of
``paddle_tpu/analysis/verify.py`` with the same codes, messages and
verdicts.

A malformed Program (a dangling input, a transpiler rewrite that aliases
a live buffer, a desc whose declared shape drifted from what the emitter
computes) otherwise surfaces only as an error deep inside an emitter —
or a silently wrong result — at step time. `verify_program` walks a
`fluid.Program` block-by-block and reports structured diagnostics
instead:

    V001 (error)   use-before-def: a non-persistable var is read before
                   the op that first produces it
    V002 (error)   unknown var: an op names a variable that exists in no
                   reachable block scope
    V003 (error)   shape mismatch: declared output shape contradicts the
                   op emitter's run on meta tensors (or the emitter
                   rejects fully-known input shapes outright)
    V004 (error)   dtype mismatch: declared output dtype contradicts the
                   emitter's run on meta tensors
    V005 (warning) grad pairing: an `x@GRAD` var with no forward `x`
    V006 (warning) dead var/op: computed but never consumed (fetch
                   targets are runtime-injected, so this stays a warning)
    V007 (warning) write-after-write: a var is overwritten with no
                   intervening read (the first write is dead)
    V008 (error)   control-flow nesting: bad parent chain or a sub-block
                   attr referencing a nonexistent/ill-parented block
    V009 (error)   unknown op type: no emitter registered and not a host
                   op the executor handles outside the device program
    V010 (error)   unsafe buffer reuse: a memory-optimization merge
                   aliases a variable whose live range has not ended
                   (reported by `check_reuse_events`, the transpiler gate)

Severities are chosen so the executor hook (`FLAGS["verify_programs"]`)
only refuses programs that cannot run correctly; style/deadness findings
stay warnings for the CLI.

V003/V004 re-run the op's PyTorch emitter on ``meta`` tensors under
``EmitCtx(device="meta")`` — the mechanism the port's build-time shape
inference uses (``framework.Operator._infer_shapes``) and the
counterpart of the JAX package's ``jax.eval_shape``. No device is
touched. The port keeps int64 where the JAX package computes int32; a
declared dtype is the port's own inference, so that standing difference
fires nothing.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Set

from .diagnostics import (
    ERROR, WARNING, AnalysisError, Diagnostic, errors as _errors,
)

PASS_NAME = "verify"

GRAD_SUFFIX = "@GRAD"


def _d(code, sev, msg, where="", hint=""):
    return Diagnostic(code=code, severity=sev, message=msg, where=where,
                      hint=hint, pass_name=PASS_NAME)


def _host_op_types() -> Set[str]:
    """Ops the executor runs outside its op loop (feed/fetch plumbing,
    readers, pserver transport, save/load) plus the delete_var liveness
    marker exec_op_descs interprets directly."""
    from ..fluid.executor import _HOST_OP_TYPES, _IO_OP_TYPES

    return set(_HOST_OP_TYPES) | set(_IO_OP_TYPES) | {"delete_var"}


def _op_where(block, i, od) -> str:
    return f"block {block.idx} / op {i} ({od.type})"


def _is_known_type(od, ops_registry, host_ops) -> bool:
    if od.type in ops_registry or od.type in host_ops:
        return True
    if od.type.endswith("_grad"):
        from ..fluid.registry import FWD_META_ATTR

        meta = od.attrs.get(FWD_META_ATTR)
        base = meta.get("type") if isinstance(meta, dict) else od.type[:-5]
        return base in ops_registry
    return False


def _iter_names(io: Dict[str, List[str]]):
    for slot, names in io.items():
        for n in names:
            if n:
                yield slot, n


def _check_block_structure(program) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    n = len(program.blocks)
    for b in program.blocks:
        if b.idx == 0:
            if b.parent_idx >= 0:
                diags.append(_d("V008", ERROR,
                                f"global block has parent {b.parent_idx}",
                                where="block 0"))
            continue
        if not (0 <= b.parent_idx < b.idx):
            diags.append(_d(
                "V008", ERROR,
                f"block {b.idx} has parent {b.parent_idx} (must be a "
                "lower-numbered block: the parent chain may not cycle)",
                where=f"block {b.idx}"))
    for b in program.blocks:
        for i, op in enumerate(b.ops):
            od = op.desc
            for k, v in od.attrs.items():
                if not k.endswith("_block"):
                    continue
                idx = v.idx if hasattr(v, "idx") else v
                if not isinstance(idx, int) or not (0 <= idx < n):
                    diags.append(_d(
                        "V008", ERROR,
                        f"attr '{k}'={idx!r} names no block of this "
                        f"program ({n} blocks)",
                        where=_op_where(b, i, od),
                        hint="sub-block attrs must hold a valid block "
                             "index"))
                elif idx != 0 and program.blocks[idx].parent_idx != b.idx:
                    diags.append(_d(
                        "V008", WARNING,
                        f"attr '{k}' names block {idx}, whose parent is "
                        f"block {program.blocks[idx].parent_idx}, not the "
                        f"op's block {b.idx}",
                        where=_op_where(b, i, od)))
    return diags


def _meta_read(e: Exception) -> bool:
    """An emitter that reads a meta tensor's values (``.item()``, a host
    copy): a data-dependent shape, the counterpart of a JAX
    concretization error — nothing can be inferred."""
    return "meta" in str(e)


def _shape_check_op(block, i, od, info) -> List[Diagnostic]:
    """Re-run the emitter on meta tensors of fully-known input shapes
    and compare with the declared output descs (the independent
    re-check of what Operator._infer_shapes wrote at build time — a
    transpiler or manual desc edit can have drifted since)."""
    import torch

    from ..fluid import core
    from ..fluid.registry import EmitCtx, normalize_outs

    if any(k.endswith("_block") for k in od.attrs):
        # a control-flow op resolves its sub-blocks through an
        # executor's Program: build-time inference skips it too
        return []
    diags: List[Diagnostic] = []
    ins = {}
    for slot, names in od.inputs.items():
        lst = []
        for n in names:
            if not n:
                lst.append(None)
                continue
            var = block._var_recursive(n)
            if var is None or var.shape is None:
                return []  # cannot infer
            if any(d is None or d < 0 for d in var.shape):
                return []  # unknown batch dims: run time decides
            try:
                dtype = core.as_torch_dtype(var.dtype)
            except (KeyError, TypeError):
                return []
            lst.append(torch.empty(tuple(var.shape), device="meta",
                                   dtype=dtype))
        ins[slot] = lst
    try:
        with torch.no_grad():
            outs = normalize_outs(
                info.forward(EmitCtx(device="meta"), ins, od.attrs))
    except NotImplementedError:
        return []  # no meta kernel, or a data-dependent output shape
    except (TypeError, ValueError, RuntimeError, IndexError) as e:
        if _meta_read(e):
            return []
        return [_d("V003", ERROR,
                   f"emitter rejects fully-known input shapes: {e}",
                   where=_op_where(block, i, od),
                   hint="the op's inputs were edited after build-time "
                        "inference ran")]
    except Exception:
        # any other class is an emitter limit that build-time inference
        # already reported for these shapes (a warning, or an error
        # under FLAGS['strict_shape_inference']): nothing to compare
        return []
    for slot, names in od.outputs.items():
        shapes = outs.get(slot, [])
        for j, n in enumerate(names):
            if not n or j >= len(shapes) or \
                    not isinstance(shapes[j], torch.Tensor):
                continue
            var = block._var_recursive(n)
            if var is None or var.shape is None:
                continue
            declared = tuple(var.shape)
            inferred = tuple(shapes[j].shape)
            if -1 not in declared and declared != inferred:
                diags.append(_d(
                    "V003", ERROR,
                    f"output '{n}' declares shape {declared} but the "
                    f"emitter computes {inferred}",
                    where=_op_where(block, i, od),
                    hint="re-run shape inference or fix the rewrite "
                         "that edited this desc"))
            want = core.convert_dtype(shapes[j].dtype)
            if var.dtype != want:
                diags.append(_d(
                    "V004", ERROR,
                    f"output '{n}' declares dtype {var.dtype} but the "
                    f"emitter computes {want}",
                    where=_op_where(block, i, od)))
    return diags


def verify_program(program, check_shapes: bool = True,
                   fetch_targets: Sequence[str] = ()) -> List[Diagnostic]:
    """Run every verifier check over `program`; returns diagnostics
    (possibly empty). `check_shapes=False` skips the (meta-run priced)
    V003/V004 re-inference — the mode the executor's per-compile
    hook uses. `fetch_targets` suppresses V006 for names the caller
    knows are fetched at runtime."""
    from ..fluid.framework import Parameter
    from ..fluid.registry import OPS

    host_ops = _host_op_types()
    diags: List[Diagnostic] = list(_check_block_structure(program))
    fetch_targets = set(fetch_targets)

    for b in program.blocks:
        # --- per-op existence / type / shape checks ---------------------
        for i, op in enumerate(b.ops):
            od = op.desc
            if not _is_known_type(od, OPS, host_ops):
                diags.append(_d(
                    "V009", ERROR,
                    f"no emitter registered for op type '{od.type}'",
                    where=_op_where(b, i, od),
                    hint="register_op() it, or add it to the executor's "
                         "host-op set if it must run outside the device "
                         "program"))
                continue
            for slot, n in _iter_names(od.inputs):
                if b._var_recursive(n) is None:
                    diags.append(_d(
                        "V002", ERROR,
                        f"input {slot}={n!r} exists in no reachable "
                        "block scope",
                        where=_op_where(b, i, od),
                        hint="create the var in this block (or an "
                             "ancestor) before referencing it"))
            for slot, n in _iter_names(od.outputs):
                if b._var_recursive(n) is None:
                    diags.append(_d(
                        "V002", ERROR,
                        f"output {slot}={n!r} exists in no reachable "
                        "block scope",
                        where=_op_where(b, i, od)))
            if check_shapes and od.type in OPS:
                info = OPS[od.type]
                if info.infer_shape is None and od.type not in host_ops:
                    diags.extend(_shape_check_op(b, i, od, info))

        # --- def/use ordering (global block only: sub-blocks re-execute,
        # so read-before-write there is a legitimate loop carry) --------
        first_def: Dict[str, int] = {}
        last_def: Dict[str, int] = {}
        for i, op in enumerate(b.ops):
            for _, n in _iter_names(op.desc.outputs):
                first_def.setdefault(n, i)
                last_def[n] = i
        if b.parent_idx < 0:
            for i, op in enumerate(b.ops):
                od = op.desc
                for slot, n in _iter_names(od.inputs):
                    var = b._var_recursive(n)
                    if var is None or var.persistable or \
                            isinstance(var, Parameter):
                        continue
                    fd = first_def.get(n)
                    if fd is not None and fd > i:
                        diags.append(_d(
                            "V001", ERROR,
                            f"input {slot}={n!r} is read at op {i} but "
                            f"first produced at op {fd}",
                            where=_op_where(b, i, od),
                            hint="reorder the ops, or feed/persist the "
                                 "var if the read is meant to see state"))

        # --- grad pairing ----------------------------------------------
        for name, var in b.vars.items():
            if not name.endswith(GRAD_SUFFIX):
                continue
            base = name[: -len(GRAD_SUFFIX)]
            if base and b._var_recursive(base) is None:
                diags.append(_d(
                    "V005", WARNING,
                    f"grad var '{name}' has no forward var '{base}' in "
                    "any reachable scope",
                    where=f"block {b.idx}",
                    hint="dangling grad slot — was the forward var "
                         "renamed or pruned without its gradient?"))

        # --- liveness: dead vars/ops and write-after-write --------------
        last_read: Dict[str, int] = {}  # name -> last read index in b
        for i, op in enumerate(b.ops):
            for _, n in _iter_names(op.desc.inputs):
                last_read[n] = i
        other_block_reads = _sub_block_reads(program, b)
        for i, op in enumerate(b.ops):
            od = op.desc
            if od.type in host_ops:
                continue
            out_names = [n for _, n in _iter_names(od.outputs)]
            in_names = {n for _, n in _iter_names(od.inputs)}
            dead_outs = []
            for n in out_names:
                var = b._var_recursive(n)
                if var is None or var.persistable or \
                        isinstance(var, Parameter):
                    continue
                if n in fetch_targets or n in in_names:
                    continue
                # dead: this is the final def and nothing — in this block
                # or any other — reads it afterwards
                if (last_def.get(n) == i and last_read.get(n, -1) <= i
                        and n not in other_block_reads):
                    dead_outs.append(n)
            if dead_outs and len(dead_outs) == len(out_names):
                diags.append(_d(
                    "V006", WARNING,
                    f"op computes only dead outputs {dead_outs} (never "
                    "read, not persistable)",
                    where=_op_where(b, i, od),
                    hint="dead code — or a fetch-only value; fetch "
                         "targets are runtime-injected so this is "
                         "advisory"))
            elif dead_outs:
                diags.append(_d(
                    "V006", WARNING,
                    f"outputs {dead_outs} are never read",
                    where=_op_where(b, i, od)))
        # WAW hazards
        writes: Dict[str, int] = {}
        for i, op in enumerate(b.ops):
            od = op.desc
            in_names = {n for _, n in _iter_names(od.inputs)}
            for n in in_names:
                writes.pop(n, None)  # read intervenes
            for _, n in _iter_names(od.outputs):
                var = b._var_recursive(n)
                if var is None:
                    continue
                prev = writes.get(n)
                if prev is not None and n not in in_names:
                    diags.append(_d(
                        "V007", WARNING,
                        f"'{n}' written at op {prev} is overwritten at "
                        f"op {i} with no intervening read",
                        where=_op_where(b, i, od),
                        hint="the first write is dead — drop it, or a "
                             "reader was pruned by mistake"))
                writes[n] = i
    return diags


def _sub_block_reads(program, block) -> Set[str]:
    out: Set[str] = set()
    for b in program.blocks:
        if b.idx == block.idx:
            continue
        for op in b.ops:
            out.update(n for _, n in _iter_names(op.desc.inputs))
    return out


def assert_valid(program, check_shapes: bool = False,
                 fetch_targets: Sequence[str] = (),
                 header: str = "program failed verification"):
    """Raise AnalysisError if `program` has error-level diagnostics —
    the executor's FLAGS["verify_programs"] pre-run hook."""
    diags = verify_program(program, check_shapes=check_shapes,
                           fetch_targets=fetch_targets)
    errs = _errors(diags)
    if errs:
        raise AnalysisError(header, errs)
    return diags


# --- memory-optimization reuse proof -----------------------------------

def check_reuse_events(cfg, events) -> List[Diagnostic]:
    """Prove a memory_optimize rewrite never aliases a still-live
    variable. `cfg` is the ControlFlowGraph built on the PRE-rewrite
    block; `events` is the transpiler's merge log: (op_index, out,
    cand) meaning "at op_index, var `out` was merged into (storage of)
    `cand`". Safe iff the storage's live range ended strictly before
    op_index; merges extend the storage's range by the merged var's
    original range."""
    last_use = dict(cfg.last_use_index())
    storage_last: Dict[str, int] = {}
    diags: List[Diagnostic] = []
    for (i, out, cand) in events:
        end = storage_last.get(cand, last_use.get(cand, -1))
        if end >= i:
            diags.append(_d(
                "V010", ERROR,
                f"reuse of '{cand}' for '{out}' at op {i} aliases a "
                f"live variable (storage still used at op {end})",
                where=f"op {i}",
                hint="the liveness analysis and the reuse pool "
                     "disagree — this rewrite would corrupt values"))
        storage_last[cand] = max(end, storage_last.get(out,
                                                       last_use.get(out, -1)))
    return diags


def verify_rewrite(program, before_diags, cfg, events,
                   what: str = "memory_optimize"):
    """Transpiler gate: fail if the rewrite introduced NEW error-level
    structural diagnostics, or if the reuse log fails the aliasing
    proof. `before_diags` is verify_program() output from before the
    rewrite (pre-existing issues are not the rewrite's fault)."""
    reuse = _errors(check_reuse_events(cfg, events))
    before = {d.key() for d in _errors(before_diags)}
    after = [d for d in _errors(verify_program(program, check_shapes=False))
             if d.key() not in before]
    bad = reuse + after
    if bad:
        raise AnalysisError(
            f"{what} produced an invalid rewrite (program left "
            "unusable — rebuild it)", bad)
