"""Fused attention and mixture-of-experts ops (the counterpart of
``paddle_tpu/fluid/ops/attention_ops.py``)."""
from __future__ import annotations

from ...kernels.flash_attention import flash_attention
from ..registry import register_op
from . import mesh_ops
from .common import one


@register_op("ring_attention", no_grad=(),
             ref="python/paddle/fluid/nets.py:345 (composed attention)")
def ring_attention(ctx, ins, attrs):
    """Q/K/V: [B, S, H, D], float32 or bfloat16 (one dtype; bfloat16
    values come from the ``cast`` op). Attrs: causal (bool), scale (float
    or 0 = 1/sqrt(D)); impl, seq_axis, batch_axis and head_axis name mesh
    axes. The op is flash attention — the K2 kernel forward and K3a/K3b
    backward of Q's dtype on a card (bfloat16: the TPU kernels' bfloat16
    branch, Out bfloat16), their plain versions on the CPU. There is no
    sequence-length routing threshold.

    Under a ParallelExecutor mesh without ``seq_axis`` (dp / dp x tp
    runs) the kernels run through ``local_map`` on ``(batch_axis, None,
    head_axis, None)`` shards, as the JAX op runs its Pallas kernel in a
    ``shard_map`` (``paddle_tpu/fluid/ops/attention_ops.py:66-95``); an
    axis the mesh lacks or that does not divide stays whole. A mesh that
    holds ``seq_axis`` runs sequence parallelism, as the JAX op does
    there (``:96-112``): ``parallel.sequence_parallel_attention`` with
    ``impl`` ring or ulysses, in float32 PyTorch math (no kernel, as in
    the JAX package), batch kept on ``batch_axis`` and heads on
    ``head_axis`` where they divide (and, under Ulysses, where the local
    head count still divides over the sequence axis).

    On bfloat16 Q/K/V the op computes the JAX package's kernel branch:
    the Pallas kernels' ``lowp`` function
    (``paddle_tpu/fluid/ops/pallas_kernels/flash_attention.py:29-77``,
    ``_fwd_kernel``; the backward ``:147``, ``:216``), which the JAX op
    takes when ``pallas_enabled()`` and S >= ``flash_min_seq``
    (``paddle_tpu/fluid/ops/attention_ops.py:55-64``): P rounded to
    bfloat16 against the running max of each 128-key block, dS rounded
    before dK and dQ. It does not compute the JAX op's route at its
    default flags off a TPU or below 3072 keys,
    ``ring_attention_shard`` (``:95``;
    ``paddle_tpu/parallel/sequence_parallel.py:137``, block update
    ``:50-65``), which keeps P in float32: the two differ by up to a
    bfloat16 ulp of max|O| in ~40% of O
    (``tests/test_torch_bf16_routes.py``). The JAX route choice rests on
    ``jax.default_backend() == "tpu"`` and a threshold measured on a
    TPU v5e; neither transfers to a card, and the port's kernels are
    ports of the Pallas kernels."""
    from ...parallel.api import current_mesh

    q, k, v = one(ins, "Q"), one(ins, "K"), one(ins, "V")
    causal = bool(attrs.get("causal", False))
    scale = float(attrs.get("scale", 0.0)) or None
    mesh = current_mesh()
    if mesh_ops.mesh_operands(mesh, q, k, v):
        seq_axis = attrs.get("seq_axis", "sp")
        if seq_axis in mesh.mesh_dim_names:
            return {"Out": _sequence_parallel(mesh, q, k, v, causal, scale,
                                              seq_axis, attrs)}
        return {"Out": mesh_ops.flash_attention(
            mesh, q, k, v, causal, scale,
            attrs.get("batch_axis", "") or None,
            attrs.get("head_axis", "") or None)}
    return {"Out": flash_attention(q, k, v, causal=causal, scale=scale)}


def _sequence_parallel(mesh, q, k, v, causal, scale, seq_axis, attrs):
    """The JAX op's mesh branch (``attention_ops.py:96-112``): a batch or
    head axis the mesh lacks or that does not divide is demoted to
    replication, and so is a head axis whose local head count Ulysses
    could not split again over the sequence axis."""
    from ...parallel.sequence_parallel import sequence_parallel_attention

    impl = attrs.get("impl", "ring")
    sizes = dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))
    batch_axis = attrs.get("batch_axis", "") or None
    if batch_axis is not None and (batch_axis not in sizes
                                   or q.shape[0] % sizes[batch_axis]):
        batch_axis = None
    head_axis = attrs.get("head_axis", "") or None
    if head_axis is not None and (head_axis not in sizes
                                  or q.shape[2] % sizes[head_axis]):
        head_axis = None
    if (head_axis is not None and impl == "ulysses"
            and (q.shape[2] // sizes[head_axis]) % sizes[seq_axis]):
        head_axis = None
    return sequence_parallel_attention(
        q, k, v, mesh, seq_axis=seq_axis, batch_axis=batch_axis,
        head_axis=head_axis, causal=causal, scale=scale, impl=impl)


@register_op("moe_ffn", no_grad=(), ref="(TPU-native capability extension)")
def moe_ffn_op(ctx, ins, attrs):
    """Mixture-of-experts FFN (Switch-style top-1, dense dispatch). Inputs:
    X [.., d], RouterW [d, E], W1 [E, d, ff], W2 [E, ff, d]. Outputs: Out,
    AuxLoss (load-balancing loss — add a multiple of it to the model loss).
    Under a ParallelExecutor mesh holding attr ``ep_axis`` the dispatched
    activations shard over it (``parallel.moe``) and DTensor inserts the
    collectives."""
    from ...parallel.api import current_mesh
    from ...parallel.moe import moe_ffn

    x = one(ins, "X")
    router_w, w1, w2 = one(ins, "RouterW"), one(ins, "W1"), one(ins, "W2")
    ep_axis = attrs.get("ep_axis", "ep")
    mesh = current_mesh()
    if mesh is not None and ep_axis not in mesh.mesh_dim_names:
        mesh = None
    out, aux = moe_ffn(
        x, router_w, w1, w2, mesh=mesh, ep_axis=ep_axis,
        capacity_factor=float(attrs.get("capacity_factor", 1.25)),
    )
    return {"Out": out, "AuxLoss": aux}
