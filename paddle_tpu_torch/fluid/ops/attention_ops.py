"""Fused attention op (the counterpart of
``paddle_tpu/fluid/ops/attention_ops.py``)."""
from __future__ import annotations

from ...kernels.flash_attention import flash_attention
from ..registry import register_op
from .common import one


@register_op("ring_attention", no_grad=(),
             ref="python/paddle/fluid/nets.py:345 (composed attention)")
def ring_attention(ctx, ins, attrs):
    """Q/K/V: [B, S, H, D], float32 or bfloat16 (one dtype; bfloat16
    values come from the ``cast`` op). Attrs: causal (bool), scale (float
    or 0 = 1/sqrt(D)); impl, seq_axis, batch_axis and head_axis name the
    mesh axes of sequence parallelism, which is not ported yet (the port
    has no mesh): the op is single-device flash attention — the K2 kernel
    forward and K3a/K3b backward of Q's dtype on a card (bfloat16: the
    TPU kernels' bfloat16 branch, Out bfloat16), their plain versions on
    the CPU. There is no sequence-length routing threshold.

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
    return {"Out": flash_attention(
        one(ins, "Q"), one(ins, "K"), one(ins, "V"),
        causal=bool(attrs.get("causal", False)),
        scale=float(attrs.get("scale", 0.0)) or None)}
