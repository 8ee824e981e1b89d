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
    the CPU. There is no sequence-length routing threshold."""
    return {"Out": flash_attention(
        one(ins, "Q"), one(ins, "K"), one(ins, "V"),
        causal=bool(attrs.get("causal", False)),
        scale=float(attrs.get("scale", 0.0)) or None)}
