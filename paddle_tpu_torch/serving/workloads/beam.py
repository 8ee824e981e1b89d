"""n-best / beam decoding over SHARED prompt pages.

A beam here is not a new scheduler: it is k sibling requests forked
over the refcounted prefix index. One parent request decodes the
prompt once, asking for the fork position's top-k token order
(``topk_first``); its prompt pages publish into the PrefixIndex the
step its prefill completes. Each of the k children then submits
``prompt + [head_i]`` — ``alloc_prefix`` maps the parent's published
full pages by refcount (metadata only, no K/V copy) and COW-copies at
most the boundary tail page. The allocator's counters are the proof:
``prefix_shared_pages`` (entries with refs >= 2) rises while the
children are live, and each child's ``cached_tokens`` reports how much
prompt it never re-prefilled.

Because children are ordinary greedy requests under the per-(seed,
position) sampling contract, each beam's tail is BITWISE-equal to an
independent temperature-0 decode of ``prompt + [head_i]`` — page
sharing is invisible to the numerics (the tests hold it against a
fresh engine with no prefix cache).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from ..errors import ServingError


def beam_search(engine, prompt: Sequence[int], k: int = 2,
                max_new_tokens: int = 16,
                deadline_ms: Optional[float] = None,
                timeout: float = 300.0) -> Dict[str, Any]:
    """Decode the k best single-token forks of ``prompt`` to
    ``max_new_tokens`` each. Returns::

        {"beams": [[t_i, ...k tails...]], "prompt_len": P, "k": k,
         "cached_tokens": [per-child prefix-index hits],
         "shared_prompt_pages": refs>=2 pages while children live,
         "version": engine version}

    ``beams[0]`` is the greedy continuation. Requires the engine's
    prefix cache: without it every child would re-prefill the whole
    prompt and "beam" would silently be k independent decodes — the
    refusal is typed instead.
    """
    k = int(k)
    if k < 1:
        raise ValueError(f"beam width k must be >= 1, got {k}")
    max_new = int(max_new_tokens)
    if max_new < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
    if not engine.prefix_cache_enabled:
        raise ServingError(
            f"decoder '{engine.name}' has no prefix cache — beam "
            "children cannot share prompt pages (load it with "
            "prefix_cache=True)")
    if k > engine.spec.vocab:
        raise ValueError(
            f"beam width {k} exceeds vocab {engine.spec.vocab}")
    prompt = [int(t) for t in prompt]

    # parent: prefill once (publishing the prompt pages) and surface
    # the fork position's token order. Greedy on purpose — the fork
    # ranking must be the deterministic argsort of the step logits,
    # not a sample.
    parent = engine.generate(prompt, 1, deadline_ms=deadline_ms,
                             timeout=timeout, topk_first=k)
    heads = [int(t) for t in parent["first_topk"]]

    if max_new == 1:
        # no tails to decode; each beam IS its fork token
        return {"beams": [[h] for h in heads],
                "prompt_len": len(prompt), "k": k,
                "cached_tokens": [], "shared_prompt_pages": 0,
                "version": engine.version}

    # fork: submit all k children before waiting on any, so they share
    # the prompt pages CONCURRENTLY (alloc_prefix pins refcounts at
    # submit) and batch together in the scheduler
    reqs = [engine.submit(prompt + [h], max_new - 1,
                          deadline_ms=deadline_ms)
            for h in heads]
    # sharing evidence, sampled while every child holds its mapping:
    # pages referenced by >= 2 sequences right now. k beams over a
    # P-token prompt should map ~floor((P+1-1)/page_size) shared pages
    # once, not k copies
    pstats = engine.cache.allocator.prefix_stats() or {}
    shared = int(pstats.get("shared", 0))

    beams: List[List[int]] = []
    cached: List[int] = []
    first_err: Optional[BaseException] = None
    for h, req in zip(heads, reqs):
        if not req.ev.wait(timeout):
            if engine.cancel(req):
                if first_err is None:
                    first_err = ServingError(
                        f"beam child on '{engine.name}' timed out "
                        f"after {timeout}s")
                continue
        if req.error is not None:
            # keep draining the siblings (their pages must be freed by
            # completion, not abandoned), then surface the first error
            if first_err is None:
                first_err = req.error
            continue
        beams.append([h] + [int(t) for t in req.result["tokens"]])
        cached.append(int(req.result["cached_tokens"]))
    if first_err is not None:
        raise first_err

    return {"beams": beams, "prompt_len": len(prompt), "k": k,
            "cached_tokens": cached, "shared_prompt_pages": shared,
            "version": engine.version}
