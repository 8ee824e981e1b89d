"""Beam search ops (reference paddle/fluid/operators/beam_search_op.cc,
beam_search_decode_op.cc) — the counterpart of
``paddle_tpu/fluid/ops/beam_search_ops.py``.

As in the JAX package, beams are a fixed [B, beam] state the whole way:
a finished beam (its last id is ``end_id``) is frozen by offering only
``end_id`` at its unchanged score, where the reference shrinks LoD
levels on the host.
"""
from __future__ import annotations

import torch

from ..registry import register_op
from .common import one


def stable_top_k(x, k):
    """The k largest of each row, largest first, ties in index order —
    ``jax.lax.top_k``'s order (``torch.topk`` promises none among equal
    values). Frozen beams tie by construction: every candidate but
    ``end_id`` scores -inf, as do the -1e9 lanes of a first step."""
    vals, pos = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k]


@register_op("beam_search", no_grad=("PreIds", "PreScores", "Ids", "Scores"),
             ref="paddle/fluid/operators/beam_search_op.cc")
def beam_search(ctx, ins, attrs):
    """One expansion step.

    Inputs: PreIds [B, beam] (last step's ids), PreScores [B, beam]
    (cumulative log-probs), Scores [B, beam, V] (this step's log-probs;
    ``Ids`` [B, beam, V] optional candidate ids). Attrs: beam_size,
    end_id, level (ignored, a LoD artifact). Outputs: SelectedIds
    [B, beam] int64, SelectedScores [B, beam], ParentIdx [B, beam] int32
    (the beam each selection extends)."""
    pre_ids, pre_scores = one(ins, "PreIds"), one(ins, "PreScores")
    ids, scores = one(ins, "Ids"), one(ins, "Scores")
    beam_size = int(attrs.get("beam_size", scores.shape[1]))
    end_id = int(attrs.get("end_id", 0))

    B, K, V = scores.shape
    finished = pre_ids == end_id
    total = pre_scores[:, :, None] + scores  # [B, K, V]
    vocab = torch.arange(V, device=scores.device)[None, None, :] \
        if ids is None else ids
    frozen = torch.where(vocab == end_id, pre_scores[:, :, None],
                         torch.full_like(total, float("-inf")))
    total = torch.where(finished[:, :, None], frozen, total)

    top_scores, top_pos = stable_top_k(total.reshape(B, K * V), beam_size)
    parent = torch.div(top_pos, V, rounding_mode="floor").to(torch.int32)
    if ids is None:
        sel_ids = top_pos % V
    else:
        sel_ids = torch.take_along_dim(ids.reshape(B, K * V), top_pos, dim=1)
    return {"SelectedIds": sel_ids.long(), "SelectedScores": top_scores,
            "ParentIdx": parent}


@register_op("beam_search_decode",
             no_grad=("Ids", "Scores", "Parents", "Lengths"),
             ref="paddle/fluid/operators/beam_search_decode_op.cc")
def beam_search_decode(ctx, ins, attrs):
    """Backtrack the stacked steps into sentences.

    Inputs: Ids [T, B, beam] selected ids a step, Parents [T, B, beam],
    Scores [T, B, beam] cumulative scores. Outputs: SentenceIds
    [B, beam, T] int64 (every id after the first ``end_id`` set to
    ``end_id``), SentenceScores [B, beam] (the last step's scores)."""
    ids, parents = one(ins, "Ids"), one(ins, "Parents")
    scores = one(ins, "Scores")
    end_id = int(attrs.get("end_id", 0))
    T, B, K = ids.shape
    slot = torch.arange(K, device=ids.device).expand(B, K)
    toks = []
    for t in range(T - 1, -1, -1):
        toks.append(torch.take_along_dim(ids[t], slot, dim=1))
        slot = torch.take_along_dim(parents[t], slot, dim=1).long()
    seq = torch.stack(toks[::-1], dim=2)  # [B, K, T]
    seen = torch.cumsum((seq == end_id).to(torch.int32), dim=2) > 0
    seq = torch.where(seen, torch.full_like(seq, end_id), seq)
    return {"SentenceIds": seq.long(), "SentenceScores": scores[-1]}
