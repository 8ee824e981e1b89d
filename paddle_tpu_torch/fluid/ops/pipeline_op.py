"""``pipeline`` region op — a GPipe schedule over the mesh's ``pp`` axis,
emitted from Program-IR stages (``layers/pipeline.py`` builds the region)
— the counterpart of ``paddle_tpu/fluid/ops/pipeline_op.py``.

  * The region sub-block is split at ``pipeline_cut`` markers into S
    stages of op descs; stage s runs as a function activation ->
    activation, reading its parameters from the op's Params.
  * Under a ParallelExecutor mesh with a ``pp`` axis of size S, rank s of
    the axis runs stage s on the schedule of ``parallel/pipeline.py``
    (``gpipe_shard``, ``n_micro + S - 1`` ticks, P2P shifts, the last
    stage's outputs summed to every rank) inside a ``local_map`` that
    replicates the region's operands over every mesh axis. The schedule
    is one ``autograd.Function``, so the executor's generic gradient
    takes the reverse pipeline.
  * Without a ``pp`` mesh axis, or with ``pp == 1``, the stages run in
    sequence: the same function, no pipelining.

Contract (checked before any schedule, on every rank, so a break is an
error on all of them and never a hang): the region input, every cut
activation and the output share one shape and dtype. Stage parameters are
replicated to every rank; only the owning stage reads them.
"""
from __future__ import annotations

import torch

from ..registry import register_op, run_sub_block
from .common import one


@register_op("pipeline_cut",
             ref="stage marker; consumed by the pipeline emitter")
def pipeline_cut(ctx, ins, attrs):
    return {}


def _split_stages(sub_block, in_var_name, out_var_name):
    """-> [(op_descs, stage_in_name, stage_out_name)] split at the cut
    markers."""
    stages = []
    cur_ops, cur_in = [], in_var_name
    for op in sub_block.ops:
        od = op.desc
        if od.type == "pipeline_cut":
            cut_var = od.input_names()[0]
            stages.append((cur_ops, cur_in, cut_var))
            cur_ops, cur_in = [], cut_var
        else:
            cur_ops.append(od)
    stages.append((cur_ops, cur_in, out_var_name))
    return stages


@register_op("pipeline", no_grad=(),
             ref="TPU-native; reference's closest surface is per-layer "
                 "device placement in trainer_config_helpers")
def pipeline(ctx, ins, attrs):
    from ...parallel.api import current_mesh

    x = one(ins, "X")
    param_names = list(attrs.get("param_var_names", []))
    param_vals = list(ins.get("Params", []))
    sub = ctx.program.blocks[int(attrs["sub_block"])]
    stages = _split_stages(sub, attrs["in_var_name"], attrs["out_var_name"])
    S = len(stages)
    if S != int(attrs["n_stages"]):
        raise ValueError(f"pipeline region records {attrs['n_stages']} "
                         f"stages but its sub-block holds {S}")

    def run_stage(s, act, vals):
        ops, in_name, out_name = stages[s]
        env = dict(zip(param_names, vals))
        env[in_name] = act
        run_sub_block(ctx, ops, env)
        if out_name not in env:
            raise ValueError(
                f"pipeline stage {s} does not produce its cut/output var "
                f"'{out_name}' — each stage must compute the activation it "
                "hands to the next stage")
        return env[out_name]

    mesh = current_mesh()
    pp = (dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))
          .get("pp") if mesh is not None else None)
    if pp is None or pp == 1:
        act = x
        for s in range(S):
            act = run_stage(s, act, param_vals)
        return {"Out": act}
    if pp != S:
        raise ValueError(
            f"pipeline region has {S} stages but mesh 'pp' axis is {pp} — "
            "cut the region into exactly pp stages")
    n_micro = int(attrs.get("n_microbatches") or 0) or S
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(
            f"pipeline input batch {B} not divisible by n_microbatches "
            f"{n_micro}")
    return {"Out": _scheduled(mesh, x, param_vals, run_stage, S, n_micro)}


def _check_stages(run_stage, S, x_mb, vals):
    """Every stage must map the microbatch activation to its own shape and
    dtype: checked on the first microbatch, every stage in turn, on every
    rank — a shape break is an error here, not a mismatched send."""
    want = (tuple(x_mb.shape[1:]), x_mb.dtype)
    act = x_mb[0]
    with torch.no_grad():
        for s in range(S):
            out = run_stage(s, act, vals)
            got = (tuple(out.shape), out.dtype)
            if got != want:
                raise ValueError(
                    f"pipeline stage {s} maps {tuple(act.shape)}/"
                    f"{act.dtype} -> {got[0]}/{got[1]}; the GPipe schedule "
                    f"needs every stage to preserve {want[0]}/{want[1]} "
                    "(region input, cuts, and output must agree)")
            act = out


def _scheduled(mesh, x, param_vals, run_stage, S, n_micro):
    """The region on the ``pp`` ranks: X and the params replicated over
    every mesh axis; their gradients partial over ``pp`` (only stage 0
    reads X, only stage s its parameters) and replicated elsewhere."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    from ...parallel.pipeline import gpipe_shard

    group = mesh.get_group("pp")
    names = tuple(mesh.mesh_dim_names)
    rep = [Replicate()] * mesh.ndim
    grad_pl = [Partial() if a == "pp" else Replicate() for a in names]
    B = x.shape[0]
    me = mesh.get_local_rank("pp")

    def body(xs, *vals):
        x_mb = xs.reshape((n_micro, B // n_micro) + tuple(xs.shape[1:]))
        _check_stages(run_stage, S, x_mb, vals)
        out = gpipe_shard(lambda ps, a: run_stage(me, a, ps), x_mb,
                          list(vals), group)
        return out.reshape((B,) + tuple(out.shape[2:]))

    vals = [v if isinstance(v, DTensor) else
            DTensor.from_local(v, mesh, rep, run_check=False)
            for v in param_vals]
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, rep, run_check=False)
    mapped = local_map(body, out_placements=list(rep),
                       in_placements=(rep,) * (1 + len(vals)),
                       in_grad_placements=(grad_pl,) * (1 + len(vals)),
                       device_mesh=mesh, redistribute_inputs=True)
    return mapped(x, *vals)
