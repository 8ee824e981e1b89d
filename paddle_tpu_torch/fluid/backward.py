"""append_backward — reverse-mode autodiff at the Program-IR level.

Capability-parity with the reference `python/paddle/fluid/backward.py:425`:
walks the block in reverse, appends one `<type>_grad` op per forward op on
the loss path, accumulates repeated-output gradients with `sum` ops
(reference _addup_repetitive_outputs_:117), prunes branches that cannot reach
a trainable input (_remove_no_grad_branch_:167), and returns (param, grad)
pairs for the optimizer.

A copy of ``paddle_tpu/fluid/backward.py``. Unlike the reference there is
no per-op C++ GradOpDescMaker: the generated grad op carries the forward
op's metadata and the executor differentiates the forward emitter with
torch.autograd (see registry.run_grad and executor.py: each forward op runs
once, its autograd record is kept for its grad op), with per-op custom grad
emitters as the override point.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

from . import core, unique_name
from .framework import Parameter, Program, Variable, grad_var_name
from .registry import FWD_META_ATTR, OPS

# op types that never participate in differentiation (the JAX package's
# list). Control flow IS differentiable: `while` (bounded or not),
# `recurrent`, `dynamic_recurrent`, `ifelse` and `conditional_block` take
# the generic grad — autograd through the loop their forward recorded
# (ops/control_flow.py) — never a silently missing gradient term.
_NON_DIFF_OPS = {
    "feed", "fetch", "fill_constant", "gaussian_random", "uniform_random",
    "sgd", "momentum", "adam", "adamax", "adagrad", "adadelta", "rmsprop",
    "decayed_adagrad", "ftrl", "increment", "assign_value",
}

_FLOAT_DTYPES = {"float16", "bfloat16", "float32", "float64"}

# non-diff ops whose output is input + constant IN PLACE: leaving the
# output's gradient contributions un-popped lets them flow through to the
# previous producer of the same name, which is exactly d(x+c)/dx = 1
_FLOW_THROUGH_OPS = {"increment"}


def _is_float_var(block, name: str) -> bool:
    var = block._var_recursive(name)
    return var is not None and var.dtype in _FLOAT_DTYPES


def _forward_need_grad_vars(block, ops, no_grad_set: Set[str]) -> Set[str]:
    """Vars transitively computed from trainable params / non-stop-gradient
    float leaves (forward sweep)."""
    need: Set[str] = set()
    for name, var in block.vars.items():
        if name in no_grad_set or var.stop_gradient:
            continue
        if isinstance(var, Parameter) and var.trainable:
            need.add(name)
        elif not var.persistable and var.op is None and _is_float_var(block, name):
            # leaf data vars: differentiable unless stop_gradient (data vars
            # default stop_gradient=True via layers.data)
            need.add(name)
    for op in ops:
        if op.desc.type in _NON_DIFF_OPS:
            continue
        if any(n in need for n in op.desc.input_names()):
            for n in op.desc.output_names():
                if n and n not in no_grad_set and _is_float_var(block, n):
                    var = block._var_recursive(n)
                    if var is None or not var.stop_gradient:
                        need.add(n)
    return need


def _create_grad_var(block, fwd_name: str, uniquify: bool = False) -> Variable:
    fwd = block._var_recursive(fwd_name)
    name = grad_var_name(fwd_name)
    if uniquify or block.has_var(name):
        name = unique_name.generate(name)
    return block.create_var(
        name=name,
        shape=fwd.shape if fwd is not None else None,
        dtype=fwd.dtype if fwd is not None else "float32",
        persistable=False,
        stop_gradient=True,
    )


def _materialize_grad(block, var_name: str, contribs: List[str]) -> Optional[str]:
    """Resolve the accumulated gradient for `var_name` from its contribution
    list, inserting a `sum` op when there are several (reference
    _addup_repetitive_outputs_)."""
    if not contribs:
        return None
    if len(contribs) == 1:
        return contribs[0]
    out = _create_grad_var(block, var_name, uniquify=True)
    block.append_op(
        type="sum", inputs={"X": list(contribs)}, outputs={"Out": [out.name]},
    )
    return out.name


def append_backward(
    loss: Variable,
    parameter_list: Optional[Sequence[str]] = None,
    no_grad_set: Optional[Set[str]] = None,
    callbacks=None,
) -> List[Tuple[Variable, Variable]]:
    block = loss.block
    program: Program = block.program
    no_grad = set(no_grad_set or ())

    # --- snapshot values that in-place writes destroy -------------------
    # An op that overwrites a name (While's loop carry, assign / increment
    # chains) leaves only the POST-write value under that name at runtime,
    # but grad ops replay their forward from the values their op actually
    # consumed (the reference keeps per-step scopes for this, while_op.cc
    # StepScopes). So before every op that overwrites a name some earlier
    # (or the same) op has read, insert an `assign` snapshot and point
    # those readers' grad-op forward-input references at it. Readers are
    # tracked per value VERSION: a reader between two writes binds to the
    # snapshot taken at the next write; readers after the last write use
    # the live name.
    snap_by_op: Dict[int, Dict[str, str]] = {}
    readers_since_write: Dict[str, List[int]] = {}
    idx = 0
    while idx < len(block.ops):
        od = block.ops[idx].desc
        if od.type.endswith("_grad"):
            idx += 1
            continue
        if od.type not in _NON_DIFF_OPS:
            # only differentiable ops replay their forward in the grad pass
            for n in od.input_names():
                if n:
                    readers_since_write.setdefault(n, []).append(id(od))
        out_names = [n for n in od.output_names() if n]
        overwrites = sorted(n for n in set(out_names)
                            if readers_since_write.get(n))
        for n in overwrites:
            src = block._var_recursive(n)
            sv = block.create_var(
                name=unique_name.generate(n + "@PRE"),
                shape=src.shape if src is not None else None,
                dtype=src.dtype if src is not None else "float32",
                stop_gradient=True,
            )
            block.insert_op(
                idx, type="assign", inputs={"X": [n]},
                outputs={"Out": [sv.name]},
            )
            idx += 1
            for rid in readers_since_write.pop(n):
                snap_by_op.setdefault(rid, {})[n] = sv.name
        # this op produced fresh versions of its outputs
        for n in out_names:
            readers_since_write.pop(n, None)
        idx += 1

    fwd_ops = list(block.ops)
    need_grad = _forward_need_grad_vars(block, fwd_ops, no_grad)

    # seed d(loss)/d(loss) = 1
    loss_grad = _create_grad_var(block, loss.name)
    block.append_op(
        type="fill_constant",
        outputs={"Out": [loss_grad.name]},
        attrs={
            "shape": list(loss.shape or [1]),
            "value": 1.0,
            "dtype": loss.dtype,
        },
    )

    contributions: Dict[str, List[str]] = {loss.name: [loss_grad.name]}

    def _consume_output_grads(od):
        """An op is the producer of its outputs: once visited, any gradient
        contributions to those names are spent — clear them so they can't
        leak to an EARLIER writer of the same (overwritten) name."""
        for names in od.outputs.values():
            for n in names:
                if n:
                    contributions.pop(n, None)

    for op in reversed(fwd_ops):
        od = op.desc
        if od.type.endswith("_grad"):
            continue
        if od.type in _NON_DIFF_OPS:
            # terminal writes (fill/random/optimizer updates) end the
            # gradient of the name they produced; increment-style in-place
            # adds deliberately pass it through (identity jacobian)
            if od.type not in _FLOW_THROUGH_OPS:
                _consume_output_grads(od)
            continue
        info = OPS.get(od.type)
        if info is None:
            continue
        out_has_grad = any(
            contributions.get(n) for n in od.output_names()
        )
        diff_inputs = [
            n for n in od.input_names() if n in need_grad and n not in no_grad
        ]
        if not out_has_grad or not diff_inputs:
            # even when no gradient can pass through, this op still
            # produced its outputs — their contributions die here
            _consume_output_grads(od)
            continue
        # materialize output grads
        grad_in: Dict[str, List[str]] = {}
        any_out_grad = False
        for slot, names in od.outputs.items():
            grads = []
            for n in names:
                g = _materialize_grad(block, n, contributions.get(n, [])) if n else None
                grads.append(g or "")
                any_out_grad = any_out_grad or bool(g)
            grad_in["GRAD@" + slot] = grads
        if not any_out_grad:
            _consume_output_grads(od)
            continue

        # grad op outputs: a fresh grad var per differentiable input
        grad_out: Dict[str, List[str]] = {}
        new_contribs: List[Tuple[str, str]] = []
        for slot, names in od.inputs.items():
            if slot in (info.no_grad or ()):
                grad_out["GRAD@" + slot] = [""] * len(names)
                continue
            outs = []
            for n in names:
                if n and n in need_grad and n not in no_grad and _is_float_var(block, n):
                    gv = _create_grad_var(block, n, uniquify=True)
                    outs.append(gv.name)
                    new_contribs.append((n, gv.name))
                else:
                    outs.append("")
            grad_out["GRAD@" + slot] = outs
        if not any(n for lst in grad_out.values() for n in lst):
            _consume_output_grads(od)
            continue

        # forward-input references go through the pre-op snapshots for
        # in-place ops; grad contributions still flow to the ORIGINAL names
        snaps = snap_by_op.get(id(od), {})
        grad_ins: Dict[str, List[str]] = {
            s: [snaps.get(n, n) for n in ns] for s, ns in od.inputs.items()
        }
        for slot, names in od.outputs.items():
            grad_ins["Out@" + slot] = list(names)
        grad_ins.update(grad_in)

        block.append_op(
            type=od.type + "_grad",
            inputs=grad_ins,
            outputs=grad_out,
            attrs={
                FWD_META_ATTR: {
                    "type": od.type,
                    "attrs": dict(od.attrs),
                    "in_slots": list(od.inputs.keys()),
                    "out_slots": list(od.outputs.keys()),
                }
            },
        )
        _consume_output_grads(od)
        if od.type == "lookup_table" and od.attrs.get("is_sparse"):
            # grad W is a SelectedRows: mark the var desc for IR-level
            # parity with the reference's VarTypeInference
            # (lookup_table_op.cc) — serialization/inspection surface only;
            # runtime dispatch is by value type (isinstance(SelectedRows))
            for n in grad_out.get("GRAD@W", []):
                if n:
                    block.var(n).desc.type = core.VarType.SELECTED_ROWS.value
        for n, g in new_contribs:
            contributions.setdefault(n, []).append(g)

    # finalize parameter gradients
    if parameter_list is not None:
        params = [block._var_recursive(p) if isinstance(p, str) else p
                  for p in parameter_list]
    else:
        params = [p for p in block.all_parameters() if p.trainable]

    params_grads: List[Tuple[Variable, Variable]] = []
    for p in params:
        if p.name in no_grad:
            continue
        g_name = _materialize_grad(block, p.name, contributions.get(p.name, []))
        if g_name is None:
            continue
        canonical = grad_var_name(p.name)
        if g_name != canonical:
            if not block.has_var(canonical):
                gv = block.create_var(
                    name=canonical, shape=p.shape, dtype=p.dtype,
                    stop_gradient=True,
                )
            # propagate var type (a sparse lookup grad stays SELECTED_ROWS
            # through the canonicalizing assign)
            block.var(canonical).desc.type = block.var(g_name).desc.type
            block.append_op(
                type="assign", inputs={"X": [g_name]}, outputs={"Out": [canonical]},
            )
            g_name = canonical
        params_grads.append((p, block.var(g_name)))
    return params_grads


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """Reference fluid.gradients / calc_gradient — grads of targets wrt inputs."""
    if isinstance(targets, Variable):
        targets = [targets]
    if isinstance(inputs, Variable):
        inputs = [inputs]
    assert len(targets) == 1, "calc_gradient currently supports a single target"
    pg = append_backward(
        targets[0],
        parameter_list=[i.name for i in inputs],
        no_grad_set=no_grad_set,
    )
    by_name = {p.name: g for p, g in pg}
    return [by_name.get(i.name) for i in inputs]
