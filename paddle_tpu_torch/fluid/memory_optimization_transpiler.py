"""Static memory optimization (reference
python/paddle/fluid/memory_optimization_transpiler.py: ControlFlowGraph:40,
liveness via _dataflow_analyze_, var reuse by shape/dtype cache pool,
memory_optimize:332, release_memory:340) — the counterpart of
``paddle_tpu/fluid/memory_optimization_transpiler.py``: the same rewrite,
so a rewritten program's bytes equal the JAX package's.

Under XLA the JAX package's rewrite changes only the program; the port's
eager executor runs it as written, so on the card it frees memory too:
  - ControlFlowGraph + liveness analysis (used for diagnostics and tests),
  - memory_optimize(program): the reference's name-rewriting reuse pass —
    dead non-persistable vars with identical static shape/dtype are
    merged; the op loop's env holds one tensor a name, so a merged
    output replaces (and frees) the dead value it reuses the name of,
  - release_memory(program): inserts delete_var ops after last use; the
    op loop drops the value there (registry.exec_op_descs),
  - estimate_peak_bytes(program): live-set peak from the same liveness.
Only vars of fully static shape take part (a -1 batch dim keeps a var
out), as in the JAX package.

The rewrite is gated as the JAX package gates it, by the port's
``analysis.verify``: the reuse log must alias no live variable (V010),
and the rewrite may add no error-level diagnostic ``verify_program``
did not report before it. A refusal raises RewriteError and rolls the
program back.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set

import numpy as np

from .framework import Parameter, Program

_SUB_BLOCK_OPS = {"while", "conditional_block", "recurrent", "parallel_do"}
_SKIP_OPS = {"feed", "fetch"}


class ControlFlowGraph:
    """Per-block def/use + backward liveness (reference :40)."""

    def __init__(self, block):
        self.block = block
        self.ops = [op.desc for op in block.ops]
        self.uses: List[Set[str]] = []
        self.defs: List[Set[str]] = []
        for od in self.ops:
            self.uses.append({n for n in od.input_names() if n})
            self.defs.append({n for n in od.output_names() if n})
        self.live_in: List[Set[str]] = [set() for _ in self.ops]
        self.live_out: List[Set[str]] = [set() for _ in self.ops]
        self._analyze()

    def _analyze(self):
        changed = True
        while changed:
            changed = False
            for i in range(len(self.ops) - 1, -1, -1):
                out = set()
                if i + 1 < len(self.ops):
                    out = set(self.live_in[i + 1])
                new_in = self.uses[i] | (out - self.defs[i])
                if out != self.live_out[i] or new_in != self.live_in[i]:
                    self.live_out[i], self.live_in[i] = out, new_in
                    changed = True

    def last_use_index(self) -> Dict[str, int]:
        last: Dict[str, int] = {}
        for i, od in enumerate(self.ops):
            for n in self.uses[i] | self.defs[i]:
                last[n] = i
        return last


def _reusable(block, name: str, skip: Set[str]) -> bool:
    if name in skip:
        return False
    var = block.vars.get(name)
    if var is None or isinstance(var, Parameter) or var.persistable:
        return False
    shape = getattr(var, "shape", None)
    if not shape or any(d is None or d < 0 for d in shape):
        return False
    return True


def _size_key(block, name):
    var = block.vars[name]
    return (tuple(var.shape), str(var.dtype))


class RewriteError(RuntimeError):
    """memory_optimize's gate refused the rewrite; ``diagnostics`` holds
    the (code, where, message) triples."""

    def __init__(self, diags):
        self.diagnostics = list(diags)
        super().__init__(
            "memory_optimize produced an invalid rewrite (rolled back)\n"
            + "\n".join(f"  ERROR {c} [{w}]: {m}"
                         for c, w, m in self.diagnostics))


def _check_reuse_events(cfg, events) -> List[tuple]:
    """The V010 errors of ``analysis.verify.check_reuse_events`` (a
    merge is safe iff its storage's live range, extended by every
    earlier merge into it, ended strictly before the merging op)."""
    from ..analysis.verify import check_reuse_events

    return [d.key() for d in check_reuse_events(cfg, events)]


def _verify_rewrite(program, before_diags, cfg, events):
    """``analysis.verify.verify_rewrite``'s verdict as a RewriteError:
    the reuse proof, and the error-level diagnostics the rewrite added
    to ``before_diags``."""
    from ..analysis.diagnostics import AnalysisError
    from ..analysis.verify import verify_rewrite

    bad = _check_reuse_events(cfg, events)
    try:
        # no events: the reuse proof is _check_reuse_events's, above
        verify_rewrite(program, before_diags, cfg, (),
                       what="memory_optimize")
    except AnalysisError as e:
        bad += [d.key() for d in e.diagnostics]
    if bad:
        raise RewriteError(bad)


def memory_optimize(input_program: Program, skip_opt_set=None,
                    print_log: bool = False, level: int = 0,
                    verify: bool = True) -> int:
    """In-place var-reuse rewrite of the global block; returns the number of
    merged vars. Programs with sub-block control flow keep those vars
    untouched (the reference pairs sub-blocks explicitly,
    _process_sub_block_pair:254 — here they're conservatively skipped).

    Gated (see the module docstring): the pass logs every merge it
    performs and, unless `verify=False`, proves against the PRE-rewrite
    liveness that no merge aliases a still-live variable (V010) and that
    the rewrite introduced no new structural errors. A gate refusal
    raises RewriteError AND rolls the in-place rewrite back, so the
    caller keeps an intact (unoptimized) program instead of a
    half-rewritten one — and instead of the aliasing surfacing as a
    wrong number ten steps later."""
    import copy

    block = input_program.global_block()
    if verify:
        from ..analysis.verify import verify_program

        before_diags = verify_program(input_program, check_shapes=False)
        # snapshot what the rewrite mutates (op IO descs + the var map)
        # so a gate refusal can hand the caller back an INTACT program
        # instead of the half-rewritten one the error is about
        saved_io = [(copy.deepcopy(op.desc.inputs),
                     copy.deepcopy(op.desc.outputs)) for op in block.ops]
        saved_vars = dict(block.vars)
    skip: Set[str] = set(skip_opt_set or ())
    for op in block.ops:
        if op.desc.type in _SUB_BLOCK_OPS:
            # anything touched by control flow stays
            skip.update(n for n in op.desc.input_names() if n)
            skip.update(n for n in op.desc.output_names() if n)
    # feed/state leaves — names read before (or without) any def — are
    # not storage: they are the executor's feed/scope inputs, and a temp
    # merged into one would overwrite a fed placeholder (verifier V001)
    first_def: Dict[str, int] = {}
    first_read: Dict[str, int] = {}
    for i, op in enumerate(block.ops):
        for n in op.desc.input_names():
            if n:
                first_read.setdefault(n, i)
        for n in op.desc.output_names():
            if n:
                first_def.setdefault(n, i)
    skip.update(n for n, r in first_read.items()
                if first_def.get(n, len(block.ops)) > r)
    cfg = ControlFlowGraph(block)

    pool: List[str] = []  # dead var names available for reuse
    rename: Dict[str, str] = {}
    events: List[tuple] = []  # (op index, merged var, reused storage)
    # storage last-use tracking, the same interval math the verifier's
    # check_reuse_events proves against: a candidate whose name is
    # re-DEFINED later (disjoint live ranges — e.g. an in-place update
    # chain reusing one name) must not serve as storage while that later
    # range is still ahead, and every merge extends the storage's range
    # by the merged var's
    last_use = cfg.last_use_index()
    storage_last: Dict[str, int] = {}
    merged = 0
    for i, od in enumerate(cfg.ops):
        if od.type in _SKIP_OPS:
            continue
        # rewrite already-merged inputs/outputs
        od.rename_inputs(rename)
        od.rename_outputs(rename)
        # fresh defs may take over a dead var of identical shape/dtype
        for out in list(od.output_names()):
            if not out or out in rename or not _reusable(block, out, skip):
                continue
            key = _size_key(block, out)
            for cand in pool:
                if _size_key(block, cand) == key and cand != out:
                    end = storage_last.get(cand, last_use.get(cand, -1))
                    if end >= i:
                        continue  # storage live again later: unsafe
                    rename[out] = cand
                    od.rename_outputs({out: cand})
                    block.vars.pop(out, None)
                    pool.remove(cand)
                    events.append((i, out, cand))
                    storage_last[cand] = max(
                        end, storage_last.get(out, last_use.get(out, -1)))
                    merged += 1
                    if print_log:
                        print(f"[memory_optimize] {out} -> {cand}")
                    break
        # vars whose live range ends at this op join the pool
        dead = (cfg.uses[i] | cfg.defs[i]) - cfg.live_out[i]
        for n in dead:
            n = rename.get(n, n)
            if _reusable(block, n, skip) and n not in pool:
                pool.append(n)
    input_program._bump_version()
    if verify:
        try:
            _verify_rewrite(input_program, before_diags, cfg, events)
        except RewriteError:
            # roll the in-place rewrite back: the caller keeps a usable
            # (unoptimized) program alongside the raised diagnostics
            for op, (ins, outs) in zip(block.ops, saved_io):
                op.desc.inputs = ins
                op.desc.outputs = outs
            block.vars = saved_vars
            input_program._bump_version()
            raise
    return merged


def release_memory(input_program: Program, skip_opt_set=None) -> int:
    """Insert delete_var ops after each var's last use (reference :340);
    the port's op loop frees each value there. Returns ops inserted."""
    block = input_program.global_block()
    skip = set(skip_opt_set or ())
    cfg = ControlFlowGraph(block)
    last = cfg.last_use_index()
    inserts = []  # (index, name)
    for name, idx in last.items():
        if _reusable(block, name, skip) and name not in cfg.live_out[idx]:
            inserts.append((idx, name))
    from .framework import Operator

    for idx, name in sorted(inserts, reverse=True):
        op = Operator(block, "delete_var", inputs={"X": [name]})
        block.ops.insert(idx + 1, op)
    input_program._bump_version()
    return len(inserts)


def estimate_peak_bytes(input_program: Program) -> int:
    """Peak of sum(live var bytes) over the op schedule — the quantity the
    reference pass minimizes."""
    block = input_program.global_block()
    cfg = ControlFlowGraph(block)

    def nbytes(name) -> int:
        var = block.vars.get(name)
        shape = getattr(var, "shape", None) if var is not None else None
        if not shape or any(d is None or d < 0 for d in shape):
            return 0
        return int(np.prod(shape)) * np.dtype(
            str(getattr(var, "dtype", "float32"))).itemsize

    peak = 0
    for i in range(len(cfg.ops)):
        live = cfg.live_in[i] | cfg.defs[i]
        peak = max(peak, sum(nbytes(n) for n in live))
    return peak
