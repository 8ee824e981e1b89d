"""Transformer NMT (capability target: reference benchmark/fluid
machine_translation.py + test_parallel_executor.py:444 transformer config),
built from the port's fluid layers with static shapes (fixed max_len,
padding masks instead of LoD) — a copy of ``paddle_tpu/models/
transformer.py``.

This is the flagship model for multi-device sharding: fc weights shard on
the hidden axis (tensor parallel), feeds on batch (data parallel) — see
``paddle_tpu_torch.parallel.plan_transformer_tp`` and
``paddle_tpu_torch.mesh.transformer_rules``. With ``seq_parallel=True``
attention is the fused ``ring_attention`` op (the K2/K3 kernels on a
card); the decoder's self-attention is causal through the op, and under a
ParallelExecutor mesh the op keeps batch on ``dp`` and heads on
``tp_axis``; a mesh with ``sp_axis`` under ``plan_sequence_parallel()``
shards the sequence too and runs ring or Ulysses attention. With ``recompute=True`` each encoder and decoder layer is one
``Recompute`` region (its activations rebuilt in backward).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..fluid import layers
from ..fluid.initializer import NumpyArrayInitializer
from ..fluid.param_attr import ParamAttr


@dataclasses.dataclass
class TransformerConfig:
    src_vocab: int = 10000
    trg_vocab: int = 10000
    max_len: int = 64
    d_model: int = 256
    n_heads: int = 8
    d_ff: int = 1024
    n_layers: int = 2
    dropout: float = 0.1
    is_test: bool = False
    # fused attention: the ring_attention op (flash attention; under a
    # mesh holding `sp_axis` — plan_sequence_parallel() — ring or Ulysses
    # sequence parallelism by `sp_impl`). Attention-prob dropout is
    # skipped in this mode (flash attention never materializes the
    # probs).
    seq_parallel: bool = False
    sp_impl: str = "ring"
    sp_axis: str = "sp"
    # Megatron TP axis: the q/k/v projections are column-parallel under
    # plan_transformer_tp, so their [N,L,H,dh] reshape arrives with H
    # sharded over tp; the fused attention op keeps heads on that axis
    # inside its local_map
    tp_axis: str = "tp"
    # activation rematerialization: wrap each encoder/decoder layer in a
    # layers.Recompute region (torch.utils.checkpoint)
    recompute: bool = False


def _pos_encoding_table(max_len, d_model):
    pos = np.arange(max_len)[:, None]
    i = np.arange(d_model)[None, :]
    angle = pos / np.power(10000.0, (2 * (i // 2)) / d_model)
    table = np.zeros((max_len, d_model), dtype=np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


def _const_param(name, value):
    return layers.create_parameter(
        shape=list(value.shape), dtype="float32",
        attr=ParamAttr(name=name, initializer=NumpyArrayInitializer(value),
                       trainable=False),
    )


def _mha(cfg: TransformerConfig, q_in, kv_in, mask=None, causal=False,
         name=""):
    """Multi-head attention: fc projections on [N, L, D] (num_flatten_dims=2),
    batched 4D matmuls. With cfg.seq_parallel, the score/softmax/context
    chain is replaced by the fused ring attention op."""
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h

    def proj(x, pname):
        return layers.fc(
            input=x, size=d, num_flatten_dims=2, bias_attr=False,
            param_attr=ParamAttr(name=f"{name}.{pname}.w"),
        )

    if cfg.seq_parallel:
        if mask is not None:
            raise ValueError(
                "seq_parallel _mha only supports causal masking (the fused "
                "ring attention op takes no additive mask)"
            )
        q = layers.reshape(proj(q_in, "q"), shape=[0, 0, h, dh])
        k = layers.reshape(proj(kv_in, "k"), shape=[0, 0, h, dh])
        v = layers.reshape(proj(kv_in, "v"), shape=[0, 0, h, dh])
        ctx = layers.ring_attention(
            q, k, v, causal=causal, impl=cfg.sp_impl, seq_axis=cfg.sp_axis,
            head_axis=cfg.tp_axis,
        )  # [N, L, H, dh]
    else:
        def split_heads(x):
            r = layers.reshape(x, shape=[0, 0, h, dh])
            return layers.transpose(r, perm=[0, 2, 1, 3])  # [N, H, L, dh]

        q = split_heads(proj(q_in, "q"))
        k = split_heads(proj(kv_in, "k"))
        v = split_heads(proj(kv_in, "v"))

        scores = layers.matmul(q, k, transpose_y=True, alpha=dh ** -0.5)
        if mask is not None:
            scores = layers.elementwise_add(scores, mask)  # bcast [L,L] on tail
        weights = layers.softmax(scores)
        if cfg.dropout and not cfg.is_test:
            weights = layers.dropout(weights, dropout_prob=cfg.dropout,
                                     is_test=cfg.is_test)
        ctx = layers.matmul(weights, v)  # [N, H, L, dh]
        ctx = layers.transpose(ctx, perm=[0, 2, 1, 3])  # [N, L, H, dh]
    ctx = layers.reshape(ctx, shape=[0, 0, d])
    return layers.fc(
        input=ctx, size=d, num_flatten_dims=2, bias_attr=False,
        param_attr=ParamAttr(name=f"{name}.out.w"),
    )


def _ffn(cfg: TransformerConfig, x, name=""):
    hidden = layers.fc(
        input=x, size=cfg.d_ff, num_flatten_dims=2, act="relu",
        param_attr=ParamAttr(name=f"{name}.ff1.w"),
    )
    if cfg.dropout and not cfg.is_test:
        hidden = layers.dropout(hidden, dropout_prob=cfg.dropout,
                                is_test=cfg.is_test)
    return layers.fc(
        input=hidden, size=cfg.d_model, num_flatten_dims=2,
        param_attr=ParamAttr(name=f"{name}.ff2.w"),
    )


def _residual_ln(x, sub, name=""):
    return layers.layer_norm(
        layers.elementwise_add(x, sub), begin_norm_axis=2,
        param_attr=ParamAttr(name=f"{name}.ln.scale"),
        bias_attr=ParamAttr(name=f"{name}.ln.bias"),
    )


def _embed(cfg, ids, vocab, name):
    emb = layers.embedding(
        ids, size=[vocab, cfg.d_model],
        param_attr=ParamAttr(name=f"{name}.emb"),
    )
    pos = _const_param(f"{name}.pos_table",
                      _pos_encoding_table(cfg.max_len, cfg.d_model))
    x = layers.elementwise_add(emb, pos, axis=1)
    if cfg.dropout and not cfg.is_test:
        x = layers.dropout(x, dropout_prob=cfg.dropout, is_test=cfg.is_test)
    return x


def _maybe_recompute(cfg, layer_fn, x):
    """Wrap one transformer layer in a Recompute region when
    cfg.recompute (activation remat: backward re-runs the layer)."""
    if not cfg.recompute:
        return layer_fn(x)
    rc = layers.Recompute()
    with rc.block():
        out = layer_fn(x)
    return rc.output(out)


def encoder(cfg: TransformerConfig, src_ids):
    x = _embed(cfg, src_ids, cfg.src_vocab, "enc")
    for i in range(cfg.n_layers):
        def enc_layer(x, i=i):
            h = _residual_ln(x, _mha(cfg, x, x, name=f"enc{i}.self"),
                             name=f"enc{i}.a")
            return _residual_ln(h, _ffn(cfg, h, name=f"enc{i}"),
                                name=f"enc{i}.b")

        x = _maybe_recompute(cfg, enc_layer, x)
    return x


def decoder(cfg: TransformerConfig, trg_ids, enc_out):
    if cfg.seq_parallel:
        mask = None  # causal handled inside the ring attention op
    else:
        causal = np.triu(
            np.full((cfg.max_len, cfg.max_len), -1e9, dtype=np.float32), k=1
        )
        mask = _const_param("dec.causal_mask", causal)
    x = _embed(cfg, trg_ids, cfg.trg_vocab, "dec")
    for i in range(cfg.n_layers):
        def dec_layer(x, i=i):
            h = _residual_ln(x, _mha(cfg, x, x, mask=mask, causal=True,
                                     name=f"dec{i}.self"),
                             name=f"dec{i}.a")
            h = _residual_ln(h, _mha(cfg, h, enc_out, name=f"dec{i}.cross"),
                             name=f"dec{i}.b")
            return _residual_ln(h, _ffn(cfg, h, name=f"dec{i}"),
                                name=f"dec{i}.c")

        x = _maybe_recompute(cfg, dec_layer, x)
    return x


def build_train(cfg: TransformerConfig, src_ids, trg_ids, labels):
    """src_ids/trg_ids: [-1, max_len] int64; labels: [-1, max_len, 1] int64.
    Returns (avg_cost, logits)."""
    enc_out = encoder(cfg, src_ids)
    dec_out = decoder(cfg, trg_ids, enc_out)
    logits = layers.fc(
        input=dec_out, size=cfg.trg_vocab, num_flatten_dims=2,
        param_attr=ParamAttr(name="proj.w"),
    )
    cost = layers.softmax_with_cross_entropy(logits=logits, label=labels)
    avg_cost = layers.mean(cost)
    return avg_cost, logits
