"""Operator registry, emitter contract and the generic gradient — the
counterpart of ``paddle_tpu/fluid/registry.py`` for eager PyTorch.

  - An op is a PyTorch *emitter* with the JAX package's contract:
        forward(ctx, ins, attrs) -> {out_slot: [tensor, ...]}
    where ``ins`` maps input slot names to lists of tensors. The executor
    runs emitters op by op, eagerly, on the scope's device.

  - Gradients come from one generic grad emitter over torch.autograd.
    The JAX package re-traces the forward emitter under ``jax.vjp`` inside
    each grad op and lets XLA's CSE merge the copy; eager PyTorch has no
    CSE, so here each forward op runs ONCE: the executor runs a forward op
    that a later ``<type>_grad`` op differentiates through
    ``forward_with_grad`` (on detached ``requires_grad_()`` copies of its
    floating inputs, under ``torch.enable_grad()``), keeps that record,
    and the grad op calls ``torch.autograd.grad`` on it once
    (``run_grad``). A grad op with no record (its forward op did not run
    in this block run) replays the forward first — the JAX package's
    semantics. Ops may register a custom grad emitter via ``grad=``.

  - RNG-consuming ops (dropout, *_random) draw from a ``torch.Generator``
    seeded from the step seed folded with ``seed * 1000003 + op_seed``
    (``EmitCtx.rng``), so a replayed forward draws the same mask. The
    streams are deterministic; they cannot match ``jax.random``'s.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .enforce import enforce

# attr key carrying the forward-op metadata on generated grad ops
FWD_META_ATTR = "__fwd__"
RNG_SEED_ATTR = "__rng_seed__"

_MASK64 = (1 << 64) - 1


def fold_seed(a: int, b: int) -> int:
    """Mix ``b`` into the 64-bit seed ``a`` (splitmix64 finaliser):
    distinct (a, b) pairs give unrelated generator seeds."""
    x = (int(a) * 0x9E3779B97F4A7C15 + int(b) + 0x632BE59BD9B4E019) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


class EmitCtx:
    """Per-run context handed to emitters (role of the reference's
    ExecutionContext, operator.h:185): the device ops run on, RNG access,
    execution mode, and the owning Program. ``device`` is required — the
    executor passes its own, shape inference passes ``"meta"`` — so no
    internal path can drift to the CPU by leaving it out."""

    def __init__(self, device, root_seed: Optional[int] = None,
                 is_test: bool = False, program=None):
        self.device = torch.device(device)
        self._root_seed = root_seed
        self.is_test = is_test
        self.program = program

    def rng(self, attrs: Dict[str, Any]) -> Optional[torch.Generator]:
        """A generator on the op's device, seeded from the step seed and
        the op's seeds; ``None`` on ``meta`` (shape inference draws
        nothing)."""
        if self.device.type == "meta":
            return None
        if self._root_seed is None:
            raise RuntimeError("op requires RNG but no seed was provided")
        seed = int(attrs.get("seed", 0) or 0)
        op_seed = int(attrs.get(RNG_SEED_ATTR, 0))
        gen = torch.Generator(device=self.device)
        gen.manual_seed(fold_seed(self._root_seed, seed * 1000003 + op_seed))
        return gen

    def op_info(self, op_type: str) -> "OpInfo":
        """The emitters this run takes for ``op_type`` (a ParallelExecutor
        run's context wraps some for its mesh)."""
        return get_op_info(op_type)


class OpInfo:
    def __init__(
        self,
        type: str,
        forward: Callable,
        needs_rng: bool = False,
        grad: Optional[Callable] = None,
        infer_shape: Optional[Callable] = None,
        no_grad: Sequence[str] = (),
        ref: Optional[str] = None,
    ):
        self.type = type
        self.forward = forward
        self.needs_rng = needs_rng
        self.grad = grad
        self.infer_shape = infer_shape
        self.no_grad = frozenset(no_grad)
        self.ref = ref


OPS: Dict[str, OpInfo] = {}


def register_op(
    type: str,
    needs_rng: bool = False,
    grad: Optional[Callable] = None,
    infer_shape: Optional[Callable] = None,
    no_grad: Sequence[str] = (),
    ref: Optional[str] = None,
):
    """Decorator registering a forward emitter under an op type name
    (role of REGISTER_OPERATOR, op_registry.h:127)."""

    def deco(fn):
        enforce(type not in OPS, "op '%s' registered twice", type,
                context="register_op")
        OPS[type] = OpInfo(
            type, fn, needs_rng=needs_rng, grad=grad, infer_shape=infer_shape,
            no_grad=no_grad, ref=ref,
        )
        return fn

    return deco


def get_op_info(type: str) -> OpInfo:
    if type not in OPS:
        raise KeyError(f"no emitter registered for op type '{type}' (not "
                       "yet ported, or not an op)")
    return OPS[type]


def normalize_outs(outs) -> Dict[str, List[Any]]:
    """Emitters may return a single tensor, a dict of tensors, or a dict
    of lists; canonicalize to dict slot -> list."""
    if not isinstance(outs, dict):
        outs = {"Out": outs}
    norm = {}
    for slot, v in outs.items():
        if isinstance(v, (list, tuple)):
            norm[slot] = list(v)
        else:
            norm[slot] = [v]
    return norm


def _is_diff(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def run_forward(ctx: EmitCtx, op_type: str, ins, attrs) -> Dict[str, List[Any]]:
    info = ctx.op_info(op_type)
    return normalize_outs(info.forward(ctx, ins, attrs))


# (differentiable (slot, index) paths, their leaf tensors, the outputs)
GradRecord = Tuple[List[Tuple[str, int]], List[torch.Tensor],
                   Dict[str, List[Any]]]


def forward_with_grad(ctx: EmitCtx, op_type: str, ins, attrs):
    """Run a forward emitter with autograd on: every floating input
    outside the op's ``no_grad`` slots becomes a detached leaf that
    requires grad. Returns ``(outs, record)``; ``run_grad`` consumes the
    record."""
    info = ctx.op_info(op_type)
    cur = {s: list(lst) for s, lst in ins.items()}
    paths, leaves = [], []
    for s, lst in cur.items():
        if s in info.no_grad:
            continue
        for i, x in enumerate(lst):
            if _is_diff(x):
                lst[i] = x.detach().requires_grad_()
                paths.append((s, i))
                leaves.append(lst[i])
    with torch.enable_grad():
        outs = normalize_outs(info.forward(ctx, cur, attrs))
    return outs, (paths, leaves, outs)


def plan_grad_records(op_descs) -> Dict[int, int]:
    """grad-op index -> index of the forward op it differentiates, for
    every generic-path grad op whose forward op appears earlier in
    ``op_descs``: the last earlier op of the forward type whose outputs
    are the grad op's ``Out@<slot>`` names."""
    last: Dict[Any, int] = {}
    plan: Dict[int, int] = {}
    for idx, od in enumerate(op_descs):
        meta = od.attrs.get(FWD_META_ATTR) if od.type.endswith("_grad") \
            else None
        if meta is None:
            key = (od.type, tuple(sorted(
                (s, tuple(ns)) for s, ns in od.outputs.items())))
            last[key] = idx
            continue
        info = OPS.get(meta["type"])
        if info is None or info.grad is not None:
            continue
        key = (meta["type"], tuple(sorted(
            (s, tuple(od.inputs.get("Out@" + s, [])))
            for s in meta["out_slots"])))
        fwd = last.pop(key, None)
        if fwd is not None:
            plan[idx] = fwd
    return plan


def exec_op_descs(ctx: EmitCtx, op_descs, env: Dict[str, Any],
                  skip_types=("feed", "fetch"), keep=frozenset(),
                  plan: Optional[Dict[int, int]] = None):
    """Run a list of OpDescs into env, eagerly and in order — the
    executor's loop. ``plan`` (``plan_grad_records``) names the forward
    ops to record for their grad ops; everything else runs without
    autograd. ``keep`` protects names (fetch targets) from delete_var."""
    plan = plan_grad_records(op_descs) if plan is None else plan
    recorded = set(plan.values())
    records: Dict[int, GradRecord] = {}
    with torch.no_grad():
        for idx, od in enumerate(op_descs):
            if od.type in skip_types:
                continue
            if od.type == "delete_var":
                # memory_optimization_transpiler.release_memory marker:
                # drop the value (reference delete_var_op.cc frees the
                # buffer); fetch targets survive
                for n in od.input_names():
                    if n not in keep:
                        env.pop(n, None)
                continue
            ins = _op_ins(od, env)
            if od.type.endswith("_grad") and FWD_META_ATTR in od.attrs:
                fwd = plan.get(idx)
                outs = run_grad(ctx, ins, od.attrs,
                                records.pop(fwd, None) if fwd is not None
                                else None)
            elif idx in recorded:
                outs, records[idx] = forward_with_grad(ctx, od.type, ins,
                                                       od.attrs)
            else:
                outs = run_forward(ctx, od.type, ins, od.attrs)
            _store_outs(od, outs, env)


def _op_ins(od, env):
    return {slot: [env.get(n) if n else None for n in names]
            for slot, names in od.inputs.items()}


def _store_outs(od, outs, env):
    for slot, names in od.outputs.items():
        vals = outs.get(slot, [])
        for i, n in enumerate(names):
            if n and i < len(vals) and vals[i] is not None:
                env[n] = vals[i]


def run_sub_block(ctx: EmitCtx, op_descs, env: Dict[str, Any]):
    """Run a control-flow op's sub-block (forward ops only) into env,
    eagerly and in order, in the CALLER's grad mode: under the
    ``forward_with_grad`` of a control-flow op that a grad op
    differentiates, autograd records every op of every iteration, so the
    gradients of the values the block reads (a parameter read only
    inside a loop) flow back through the one recorded graph."""
    for od in op_descs:
        if od.type in ("feed", "fetch"):
            continue
        _store_outs(od, run_forward(ctx, od.type, _op_ins(od, env),
                                    od.attrs), env)


def run_grad(ctx: EmitCtx, ins: Dict[str, List[Any]], attrs: Dict[str, Any],
             record: Optional[GradRecord] = None):
    """Execute a generated ``<type>_grad`` op.

    Grad op IO convention (the JAX package's, after the reference's
    grad-op descs, grad_op_desc_maker.h):
      inputs:  fwd input slots as-is; fwd outputs under 'Out@<slot>';
               incoming output-gradients under 'GRAD@<out_slot>'
               (missing / '' entries mean "no gradient flows here": a
               zero cotangent)
      outputs: input-gradients under 'GRAD@<in_slot>' (zeros for an input
               the outputs do not depend on)
    ``record`` is the forward op's ``forward_with_grad`` record; without
    one the forward is replayed from the grad op's inputs.
    """
    meta = attrs[FWD_META_ATTR]
    info = ctx.op_info(meta["type"])
    fwd_attrs = dict(meta["attrs"])
    fwd_ins = {s: list(ins.get(s, [])) for s in meta["in_slots"]}

    if info.grad is not None:
        fwd_outs = {s: list(ins.get("Out@" + s, [])) for s in meta["out_slots"]}
        out_grads = {s: list(ins.get("GRAD@" + s, [])) for s in meta["out_slots"]}
        return normalize_outs(info.grad(ctx, fwd_ins, fwd_outs, out_grads, fwd_attrs))

    if record is None:
        _, record = forward_with_grad(ctx, meta["type"], fwd_ins, fwd_attrs)
    paths, leaves, outs = record
    if not paths:
        return {}
    ys, cts = [], []
    for s, lst in outs.items():
        gl = ins.get("GRAD@" + s, [])
        for i, y in enumerate(lst):
            g = gl[i] if i < len(gl) else None
            # a zero cotangent adds nothing: leave the output out
            if g is not None and isinstance(y, torch.Tensor) \
                    and y.requires_grad:
                ys.append(y)
                cts.append(g)
    gins = (torch.autograd.grad(ys, leaves, cts, allow_unused=True)
            if ys else [None] * len(leaves))

    result: Dict[str, List[Any]] = {
        "GRAD@" + s: [None] * len(fwd_ins[s]) for s in fwd_ins}
    for (s, i), leaf, g in zip(paths, leaves, gins):
        result["GRAD@" + s][i] = torch.zeros_like(leaf) if g is None else g
    return result
