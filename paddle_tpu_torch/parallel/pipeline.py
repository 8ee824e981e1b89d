"""Pipeline parallelism: GPipe-style microbatch pipelining over a mesh axis
— the counterpart of ``paddle_tpu/parallel/pipeline.py``.

Stage parameters live sharded over the ``pp`` mesh axis (leading stage
dim, ``Shard(0)``); each rank of the axis is one stage. Activations flow
stage to stage by a shift (P2P sends to the next rank; stage 0 receives
zeros), microbatches stream through ``n_micro + S - 1`` ticks, and the
last stage's outputs are summed to every rank — the JAX ``psum`` — so the
result is replicated over ``pp``. The backward is the reverse schedule:
the shift's transpose sends gradients to the previous rank (the last
stage receives zeros), each stage recomputing its microbatches from the
saved inputs.

Layout contract, as in the JAX package: every stage has the same
signature ``stage_fn(stage_params, x) -> y`` (x, y one shape
``[mb, ...]``) and ``params`` is a tree of tensors stacked on a leading
stage axis of size n_stages.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

__all__ = ["pipeline_apply_shard", "pipeline_apply", "stack_stage_params",
           "shard_stage_params", "gpipe_shard"]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _unflatten_like(tree, leaves):
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree)


class _Shift:
    """The stage ring of one ``pp`` group: this rank's stage index and the
    global ranks of its neighbours (``group=None``: one stage)."""

    def __init__(self, group):
        import torch.distributed as dist

        self.group = group
        if group is None:
            self.n, self.idx = 1, 0
            return
        self.n = dist.get_world_size(group)
        self.idx = dist.get_rank(group)
        self._rank = lambda i: dist.get_global_rank(group, i)

    def exchange(self, send, to, like, frm):
        """Send ``send`` to stage ``to`` (None: nothing) and receive a
        tensor shaped as ``like`` from stage ``frm`` (None: zeros), in one
        batched P2P exchange."""
        import torch.distributed as dist

        recv = torch.zeros_like(like)
        ops = []
        if to is not None:
            ops.append(dist.P2POp(dist.isend, send.contiguous(),
                                  self._rank(to), self.group))
        if frm is not None:
            ops.append(dist.P2POp(dist.irecv, recv, self._rank(frm),
                                  self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return recv


class _GPipe(torch.autograd.Function):
    """The schedule of one stage, forward and backward, with every send
    and receive explicit (so the ranks' P2P order never rests on
    autograd's node order).

    Forward, tick t = 0 .. T - 1: stage s computes microbatch m = t - s
    when it exists (stage 0 from the input, the others from what stage
    s - 1 sent at tick t - 1), saves its input, and sends its output to
    stage s + 1; the last stage keeps its outputs, which are summed to
    every rank (the JAX ``psum``). Backward, tick t = T - 1 .. 0: stage
    s recomputes microbatch m from the saved input (GPipe's
    rematerialization), takes the output gradient from the cotangent
    (last stage) or from stage s + 1, accumulates its parameters'
    gradients and sends the input gradient to stage s - 1 (a shift left;
    stage 0 keeps it as the input's gradient). The cotangent of the
    summed, replicated output reaches every rank whole: the transpose of
    the sum is a broadcast."""

    @staticmethod
    def forward(ctx, run, shift, x_mb, *params):
        n, idx = shift.n, shift.idx
        n_micro = x_mb.shape[0]
        ins = [None] * n_micro
        outs = [None] * n_micro
        recv = None
        for t in range(n_micro + n - 1):
            m = t - idx
            live = 0 <= m < n_micro
            out = None
            if live:
                cur = x_mb[m] if idx == 0 else recv
                ins[m] = cur
                out = run(params, cur)
                if idx == n - 1:
                    outs[m] = out
            if n > 1:
                # stage s + 1 works on microbatch m at tick t + 1 exactly
                # when stage s worked on it at tick t
                to = idx + 1 if live and idx < n - 1 else None
                frm = idx - 1 if idx > 0 and 0 <= t + 1 - idx < n_micro \
                    else None
                recv = shift.exchange(out, to, x_mb[0], frm)
        outputs = torch.stack(outs) if idx == n - 1 else \
            torch.zeros_like(x_mb)
        if n > 1:
            import torch.distributed as dist

            dist.all_reduce(outputs, group=shift.group)
        ctx.run, ctx.shift, ctx.ins = run, shift, ins
        ctx.save_for_backward(x_mb, *params)
        return outputs

    @staticmethod
    def backward(ctx, g):
        run, shift, ins = ctx.run, ctx.shift, ctx.ins
        x_mb, *params = ctx.saved_tensors
        n, idx = shift.n, shift.idx
        n_micro = x_mb.shape[0]
        gx = torch.zeros_like(x_mb)
        gp = [torch.zeros_like(p) for p in params]
        recv = None
        for t in range(n_micro + n - 2, -1, -1):
            m = t - idx
            live = 0 <= m < n_micro
            gin = None
            if live:
                gout = g[m] if idx == n - 1 else recv
                with torch.enable_grad():
                    xin = ins[m].detach().requires_grad_(True)
                    ps = [p.detach().requires_grad_(True) for p in params]
                    y = run(ps, xin)
                    grads = torch.autograd.grad(y, [xin] + ps, gout,
                                                allow_unused=True)
                for acc, gr in zip(gp, grads[1:]):
                    if gr is not None:
                        acc.add_(gr)
                if idx == 0:
                    gx[m] = grads[0]
                else:
                    gin = grads[0]
            if n > 1:
                # stage s - 1 takes microbatch m at backward tick t - 1
                to = idx - 1 if live and idx > 0 else None
                frm = idx + 1 if idx < n - 1 and 0 <= t - 1 - idx < n_micro \
                    else None
                recv = shift.exchange(gin, to, g[0], frm)
        return (None, None, gx) + tuple(gp)


def gpipe_shard(run: Callable, x_mb, params, group):
    """The GPipe schedule of this rank's stage over the ranks of
    ``group``: ``run(params, x) -> y`` is the stage (a list of tensors
    and one microbatch), ``x_mb`` [n_micro, mb, ...] the microbatches (the
    same on every rank). Returns the last stage's [n_micro, mb, ...]
    outputs on every rank; differentiable in ``x_mb`` and ``params``."""
    return _GPipe.apply(run, _Shift(group), x_mb, *params)


def pipeline_apply_shard(stage_fn: Callable, stage_params, x_mb, group):
    """Per-rank GPipe schedule over the ranks of ``group`` (this rank is
    stage ``rank(group)``).

    stage_params: this rank's stage parameters (leading stage axis of
    size 1, squeezed here). x_mb: [n_micro, mb, ...] microbatches, the
    same on every rank (only stage 0 reads them). Returns [n_micro, mb,
    ...] outputs, summed to every rank from the last stage.

    Schedule: T = n_micro + S - 1 ticks; at tick t stage s computes
    microbatch t - s when it exists. An idle tick computes nothing and
    sends nothing (its JAX twin computes on garbage and masks it: the
    same result). Differentiable in ``x_mb`` (its gradient lands on
    stage 0) and in the stage's parameters."""
    leaves = _leaves(stage_params)

    def run(ps, x):
        return stage_fn(_tree_map(lambda p: p.squeeze(0),
                                  _unflatten_like(stage_params, ps)), x)

    return gpipe_shard(run, x_mb, leaves, group)


def pipeline_apply(stage_fn: Callable, params, x, mesh, axis_name: str = "pp",
                   n_microbatches: Optional[int] = None):
    """Global entry point. params: a tree of DTensors with leaves stacked
    on a leading stage axis sharded over ``axis_name`` (``Shard(0)``, as
    ``shard_stage_params`` places them); x: [batch, ...], a plain tensor
    or a DTensor replicated over the axis. Splits the batch into
    microbatches, pipelines them, returns [batch, ...] replicated over
    the axis. Differentiable in params and x."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    names = tuple(mesh.mesh_dim_names)
    n_stages = int(mesh.shape[names.index(axis_name)])
    n_micro = n_microbatches or n_stages
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by {n_micro} "
                         "microbatches")
    group = mesh.get_group(axis_name)
    rep = [Replicate()] * mesh.ndim
    stage_pl = [Shard(0) if a == axis_name else Replicate() for a in names]
    x_grad_pl = [Partial() if a == axis_name else Replicate()
                 for a in names]
    leaves = _leaves(params)

    def body(xs, *ps):
        x_mb = xs.reshape((n_micro, b // n_micro) + tuple(xs.shape[1:]))
        out = pipeline_apply_shard(stage_fn, _unflatten_like(params, ps),
                                   x_mb, group)
        return out.reshape((b,) + tuple(out.shape[2:]))

    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, rep, run_check=False)
    mapped = local_map(body, out_placements=list(rep),
                       in_placements=(rep,) + (stage_pl,) * len(leaves),
                       in_grad_placements=(x_grad_pl,)
                       + (stage_pl,) * len(leaves),
                       device_mesh=mesh, redistribute_inputs=True)
    return mapped(x, *leaves)


def stack_stage_params(per_stage_params):
    """[params_stage0, params_stage1, ...] (matching trees) -> one tree
    with a leading stage axis, ready to shard over pp."""
    first = per_stage_params[0]
    stacked = [torch.stack(xs, 0) for xs in
               zip(*(_leaves(p) for p in per_stage_params))]
    return _unflatten_like(first, stacked)


def shard_stage_params(params, mesh, axis_name: str = "pp"):
    """Place stacked stage params with the leading axis sharded over
    ``axis_name`` (``Shard(0)``; replicated over every other axis). Each
    rank cuts its stage from its own copy: every rank holds the same
    tree."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    pl = [Shard(0) if a == axis_name else Replicate()
          for a in mesh.mesh_dim_names]
    return _tree_map(
        lambda p: distribute_tensor(p.to(mesh.device_type), mesh, pl,
                                    src_data_rank=None), params)
