"""Control-flow op emitters — the counterpart of
``paddle_tpu/fluid/ops/control_flow.py`` for eager PyTorch: ``while``,
``conditional_block``, ``recurrent`` (StaticRNN), ``ifelse``,
``dynamic_recurrent`` (DynamicRNN) and the tensor-array ops.

Reference: operators/while_op.cc:35 (re-runs the sub-block per step
with StepScopes), conditional_block_op.cc, recurrent_op.cc,
tensor_array_read_write_op.cc. The JAX package traces each sub-block
into one XLA computation (``lax.while_loop``, ``lax.scan``,
``lax.cond``); here the sub-block's emitters run eagerly, op by op, on
the scope's device, through ``registry.run_sub_block``.

Gradients: every op here takes the generic path. The executor runs a
control-flow op that a grad op differentiates under
``forward_with_grad``; ``run_sub_block`` keeps that grad mode, so
autograd records every iteration and the grad op pulls the cotangent
back through the recorded loop once. That holds the O(T) intermediates
the reference's step scopes hold (while_op.cc:55) and replays nothing,
where the JAX package needs a recompute-and-replay grad for an
unbounded ``while`` (XLA cannot reverse a ``while_loop``).

All outer vars a sub-block reads are listed in the op's inputs (the
layers compute this), so each emitter is a function of ``ins``.
Loop-carried shapes stay fixed: DynamicRNN masks finished sequences
instead of shrinking the batch (the JAX package's semantics).
"""
from __future__ import annotations

import torch

from ...observability import metrics as _metrics
from ..registry import register_op, run_sub_block
from .common import one

# one device-to-host read of a loop or branch condition: an unbounded
# while reads its condition once an iteration (and once at the exit), a
# conditional_block once a run
_m_host_syncs = _metrics.counter("fluid.control_flow.host_syncs")
_m_while_iters = _metrics.counter("fluid.while.iterations")

# Tally of while-loop body evaluations behind
# FLAGS['count_while_step_evals'] (the JAX package's observable). Here a
# loop of T iterations counts T (a bounded loop its max_steps): the
# gradient pulls back through the recorded iterations and evaluates the
# body no further time, where the JAX package's unbounded while-grad
# replays it (~3T more).
_STEP_EVALS = {"n": 0}


def step_evals_reset():
    _STEP_EVALS["n"] = 0


def step_evals():
    return _STEP_EVALS["n"]


def _count_step_eval():
    from ...flags import FLAGS

    if FLAGS["count_while_step_evals"]:
        _STEP_EVALS["n"] += 1


def _host_bool(t) -> bool:
    """A [1] or scalar condition read on the host (one sync on a card)."""
    _m_host_syncs.inc()
    return bool(t.reshape(()).item())


def _sub_op_descs(ctx, attrs, key="sub_block"):
    if ctx.program is None:
        raise RuntimeError("control-flow op needs ctx.program (an Executor "
                           "run)")
    return [op.desc for op in ctx.program.blocks[int(attrs[key])].ops]


def _written(op_descs):
    seen, out = set(), []
    for d in op_descs:
        for n in d.output_names():
            if n and n not in seen:
                seen.add(n)
                out.append(n)
    return out


def _run_body(ctx, ops, base_env, carry, names):
    local = dict(base_env)
    local.update(carry)
    run_sub_block(ctx, ops, local)
    return {n: local[n] for n in names}


@register_op("while", no_grad=("Condition",),
             ref="paddle/fluid/operators/while_op.cc:35")
def while_op(ctx, ins, attrs):
    """Loop the sub-block while the condition holds. The carry is every
    var the block writes that has a value before the loop, and the
    condition.

    - ``max_steps`` = K: exactly K iterations, each carry frozen by
      ``torch.where`` once the condition is false (the JAX package's
      scan); no host sync. A loop still live after K steps is cut there.
    - no ``max_steps``: the condition is read on the host before every
      iteration (one device sync each, counted in
      ``fluid.control_flow.host_syncs``)."""
    ops = _sub_op_descs(ctx, attrs)
    cond_name = str(attrs["cond_var_name"])
    out_names = list(attrs["out_var_names"])
    env = dict(zip(list(attrs["x_var_names"]), ins.get("X", [])))
    env[cond_name] = one(ins, "Condition")
    carry_names = [n for n in _written(ops) if n in env]
    if cond_name not in carry_names:
        carry_names.append(cond_name)
    base_env = {k: v for k, v in env.items() if k not in carry_names}
    carry = {n: env[n] for n in carry_names}
    max_steps = int(attrs.get("max_steps", 0) or 0)
    if max_steps:
        for _ in range(max_steps):
            live = carry[cond_name].reshape(()).bool()
            _count_step_eval()
            new = _run_body(ctx, ops, base_env, carry, carry_names)
            carry = {n: torch.where(live, new[n], carry[n])
                     for n in carry_names}
        _m_while_iters.inc(max_steps)
    else:
        while _host_bool(carry[cond_name]):
            _count_step_eval()
            _m_while_iters.inc()
            carry = _run_body(ctx, ops, base_env, carry, carry_names)
    return {"Out": [carry.get(n) for n in out_names]}


@register_op("conditional_block", no_grad=("Condition",),
             ref="paddle/fluid/operators/conditional_block_op.cc")
def conditional_block(ctx, ins, attrs):
    """Run the sub-block when the scalar condition holds (read on the
    host: one sync); else the written vars keep their values. The
    gradient is the taken branch's, as ``lax.cond``'s."""
    ops = _sub_op_descs(ctx, attrs)
    out_names = list(attrs["out_var_names"])
    env = dict(zip(list(attrs["x_var_names"]), ins.get("X", [])))
    carry_names = [n for n in _written(ops) if n in env]
    carry = {n: env[n] for n in carry_names}
    if _host_bool(one(ins, "Condition")):
        carry = _run_body(ctx, ops, env, carry, carry_names)
    return {"Out": [carry.get(n) for n in out_names]}


@register_op("recurrent", ref="paddle/fluid/operators/recurrent_op.cc")
def recurrent(ctx, ins, attrs):
    """StaticRNN: the step block over axis 1 of the step inputs, memories
    linked from each step to the next, outputs stacked on axis 1."""
    ops = _sub_op_descs(ctx, attrs)
    step_in_vars = list(attrs["step_input_vars"])
    mem_links = [tuple(link) for link in attrs["memory_links"]]
    step_out_vars = list(attrs["step_output_vars"])
    step_inputs = ins.get("StepInputs", [])
    if not step_inputs:
        raise ValueError("recurrent op requires StepInputs (trip count)")
    base_env = dict(zip(list(attrs["param_var_names"]),
                        ins.get("Params", [])))
    mems = {pre: init for (pre, _), init in zip(mem_links,
                                                 ins.get("MemInit", []))}
    collected = {n: [] for n in step_out_vars}
    for t in range(step_inputs[0].shape[1]):
        local = dict(base_env)
        local.update(mems)
        for full, sub in zip(step_inputs, step_in_vars):
            local[sub] = full[:, t]
        run_sub_block(ctx, ops, local)
        mems = {pre: local[upd] for (pre, upd) in mem_links}
        for n in step_out_vars:
            collected[n].append(local[n])
    return {"Out": [torch.stack(collected[n], dim=1)
                    for n in step_out_vars]}


def _rows(mask, like):
    """A [N] mask shaped to broadcast over ``like``'s trailing dims."""
    return mask.reshape((mask.shape[0],) + (1,) * (like.ndim - 1))


@register_op("ifelse", no_grad=("Cond",),
             ref="python/paddle/fluid/layers/control_flow.py:1252 (IfElse)")
def ifelse(ctx, ins, attrs):
    """Per-example two-way branch: BOTH branches run on the whole batch
    and the rows merge with ``torch.where(cond)`` (the JAX package's
    lowering; the reference splits the rows with split_lod_tensor). The
    select gives each row the gradient of its own branch only."""
    cond = one(ins, "Cond")
    env = dict(zip(list(attrs["x_var_names"]), ins.get("X", [])))
    cond_name = attrs.get("cond_var_name")
    if cond_name:
        # a branch may read the condition as data
        env[cond_name] = cond

    def branch(block_attr, out_names):
        local = dict(env)
        run_sub_block(ctx, _sub_op_descs(ctx, attrs, block_attr), local)
        return [local[n] for n in out_names]

    t_vals = branch("true_block", list(attrs["true_out_names"]))
    f_vals = branch("false_block", list(attrs["false_out_names"]))
    mask = cond.reshape(-1).bool()
    return {"Out": [torch.where(_rows(mask, t), t, f)
                    for t, f in zip(t_vals, f_vals)]}


@register_op("dynamic_recurrent", no_grad=("Lengths",),
             ref="python/paddle/fluid/layers/control_flow.py:1354 "
                 "(DynamicRNN)")
def dynamic_recurrent(ctx, ins, attrs):
    """DynamicRNN over padded sequences: the step block over the whole
    static [N, T] extent; at step t a sequence with t >= its length keeps
    its memories (``torch.where``) and outputs zeros. The batch never
    shrinks (the reference's shrink_rnn_memory), so sequence_last_step
    reads each sequence's frozen final state. No host sync: the mask is
    computed on the device."""
    ops = _sub_op_descs(ctx, attrs)
    step_in_vars = list(attrs["step_input_vars"])
    mem_links = [tuple(link) for link in attrs["memory_links"]]
    step_out_vars = list(attrs["step_output_vars"])
    step_inputs = ins.get("StepInputs", [])
    if not step_inputs:
        raise ValueError("dynamic_recurrent requires StepInputs")
    N, T = step_inputs[0].shape[0], step_inputs[0].shape[1]
    lengths = (ins.get("Lengths") or [None])[0]
    if lengths is None:
        lengths = torch.full((N,), T, dtype=torch.int32,
                             device=step_inputs[0].device)
    lengths = lengths.reshape(-1)

    base_env = dict(zip(list(attrs["param_var_names"]),
                        ins.get("Params", [])))
    base_env.update(zip(list(attrs["static_input_vars"]),
                        ins.get("StaticInputs", [])))
    mems = {pre: init for (pre, _), init in zip(mem_links,
                                                 ins.get("MemInit", []))}
    collected = {n: [] for n in step_out_vars}
    for t in range(T):
        local = dict(base_env)
        local.update(mems)
        for name, x in zip(step_in_vars, step_inputs):
            local[name] = x[:, t]
        run_sub_block(ctx, ops, local)
        active = lengths > t  # [N]
        mems = {pre: torch.where(_rows(active, local[upd]), local[upd],
                                 mems[pre])
                for (pre, upd) in mem_links}
        for n in step_out_vars:
            v = local[n]
            collected[n].append(torch.where(_rows(active, v), v,
                                            torch.zeros_like(v)))
    return {"Out": [torch.stack(collected[n], dim=1)
                    for n in step_out_vars]}


# --- tensor arrays (reference tensor_array_read_write_op.cc) -----------
# An array is a preallocated dense [T, ...] buffer, as in the JAX package.
# A write is out of place (``index_copy``), so autograd records it; the
# index stays a device tensor (no host read) and is clamped into the
# array, as ``lax.dynamic_update_slice`` clamps.


def _index(i, size):
    return i.reshape(1).long().clamp(0, size - 1)


@register_op("write_to_array", no_grad=("I",),
             ref="paddle/fluid/operators/tensor_array_read_write_op.cc")
def write_to_array(ctx, ins, attrs):
    arr, x, i = one(ins, "Array"), one(ins, "X"), one(ins, "I")
    return {"Out": arr.index_copy(0, _index(i, arr.shape[0]),
                                  x.to(arr.dtype)[None])}


@register_op("read_from_array", no_grad=("I",),
             ref="paddle/fluid/operators/tensor_array_read_write_op.cc")
def read_from_array(ctx, ins, attrs):
    arr, i = one(ins, "X"), one(ins, "I")
    return {"Out": arr.index_select(0, _index(i, arr.shape[0])).squeeze(0)}


@register_op("array_length", no_grad=("X",),
             ref="paddle/fluid/operators/lod_array_length_op.cc")
def array_length(ctx, ins, attrs):
    return {"Out": torch.tensor([one(ins, "X").shape[0]], dtype=torch.int64,
                                device=ctx.device)}


# the reference registers this op under "lod_array_length"
register_op("lod_array_length", no_grad=("X",),
            ref="paddle/fluid/operators/lod_array_length_op.cc")(
    lambda ctx, ins, attrs: array_length(ctx, ins, attrs))


@register_op("slice",
             ref="paddle/fluid/operators (era: crop/sequence_slice family)")
def slice_op(ctx, ins, attrs):
    x = one(ins, "Input")
    idx = [slice(None)] * x.ndim
    for ax, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        ax, s, e = int(ax), int(s), int(e)
        dim = x.shape[ax]
        s = s + dim if s < 0 else min(s, dim)
        e = e + dim if e < 0 else min(e, dim)
        idx[ax] = slice(s, e)
    return {"Out": x[tuple(idx)]}


@register_op("recompute",
             ref="the JAX package's recompute op (jax.checkpoint); the "
                 "2018 reference's memory lever is "
                 "memory_optimization_transpiler reuse instead")
def recompute_op(ctx, ins, attrs):
    """Run the sub-block as one activation-rematerialization region.

    Under autograd (the ``forward_with_grad`` of a recompute op that a
    grad op differentiates) the block runs inside
    ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``: every
    tensor its ops save for backward (the kernels' ``save_for_backward``
    included) is dropped, and the grad op's ``torch.autograd.grad`` runs
    the block's forward a second time to rebuild them, so the record
    keeps only the region's inputs and outputs. The replay draws the same
    dropout masks: ``EmitCtx.rng`` seeds a fresh generator from the step
    seed and the op's seed attrs on every call, so the global RNG state
    that ``preserve_rng_state`` would save and restore is never read
    (it is off). Without autograd the block simply runs."""
    ops = _sub_op_descs(ctx, attrs)
    x_names = list(attrs["x_var_names"])
    out_names = list(attrs["out_var_names"])
    xs = list(ins.get("X", []))

    def region(*vals):
        env = dict(zip(x_names, vals))
        run_sub_block(ctx, ops, env)
        return tuple(env[n] for n in out_names)

    if not torch.is_grad_enabled():
        return {"Out": list(region(*xs))}
    from torch.utils.checkpoint import checkpoint

    return {"Out": list(checkpoint(region, *xs, use_reentrant=False,
                                   preserve_rng_state=False))}


@register_op("get_places", no_grad=(),
             ref="paddle/fluid/operators/get_places_op.cc")
def get_places(ctx, ins, attrs):
    """Device indices for a ParallelDo region: int32 ``[0..n)``. A place
    is a mesh position, so with ``device_count`` 0 the count is the
    active ParallelExecutor mesh's size, else the count of the run's
    device kind (the cards; 1 on the CPU). The JAX op returns
    ``jax.device_count()``, 8 on the CPU tests' virtual mesh: a decided
    difference (the port's CPU is one device)."""
    from ...parallel.api import current_mesh

    n = int(attrs.get("device_count", 0) or 0)
    if n == 0:
        mesh = current_mesh()
        if mesh is not None:
            n = int(mesh.size())
        elif ctx.device.type == "cuda":
            n = torch.cuda.device_count()
        else:
            n = 1
    return {"Out": torch.arange(n, dtype=torch.int32, device=ctx.device)}


@register_op("parallel_do", no_grad=("Places",),
             ref="paddle/fluid/operators/parallel_do_op.cc:115")
def parallel_do(ctx, ins, attrs):
    """Data-parallel region (reference: SplitTensorAndMoveTensorToScopes +
    per-place threads + NCCL grad all-reduce, parallel_do_op.cc:39,115).

    The sub-block runs ONCE over the whole batch; under a
    ParallelExecutor mesh its batch-sharded DTensors make that the
    reference's split-run-allreduce, with DTensor inserting the
    collectives. The region is a function of (Inputs, X), so the generic
    grad op differentiates it; the Places input only sizes the mesh and
    carries no gradient."""
    ops = _sub_op_descs(ctx, attrs)
    env = dict(zip(list(attrs["x_var_names"]), ins.get("X", [])))
    env.update(zip(list(attrs["input_var_names"]), ins.get("Inputs", [])))
    run_sub_block(ctx, ops, env)
    return {"Out": [env[n] for n in list(attrs["out_var_names"])]}
