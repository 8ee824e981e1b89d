"""ServingClient — typed client over distributed/rpc.py's RpcClient.

Transport retries are SAFE by construction: every frame carries the
idempotency token, and the server routes `infer` through its dedup
cache, so a retransmit after a dropped reply is answered from the
original response without re-running the batch. Application errors come
back as ``"<TypeName>: <message>"`` strings; `_raise_typed` maps the
name back to the serving exception class (ServerOverloaded,
DeadlineExceeded, ...) so callers catch types, not regexes."""
from __future__ import annotations

import re
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..distributed.rpc import RpcClient
from .errors import (DeadlineExceeded, EngineRetired, ModelNotFound,
                     RequestTooLarge, ServerOverloaded, ServingError,
                     StreamExpired)

__all__ = ["ServingClient", "TokenStream"]

from ..checkpoint.errors import CheckpointCorruptError, CheckpointError

_TYPED = {cls.__name__: cls for cls in
          (ServerOverloaded, DeadlineExceeded, ModelNotFound,
           RequestTooLarge, EngineRetired, ServingError, StreamExpired,
           # checkpoint deploy refusals arrive typed (a corrupt segment
           # keeps its tensor-named message across the wire)
           CheckpointError, CheckpointCorruptError,
           ValueError)}  # ValueError: spec/feed validation refusals

# rpc.py's client raises RuntimeError("RPC <m> failed: <Type>: <msg>")
_ERR_RE = re.compile(r"^RPC \S+ failed: (\w+): (.*)$", re.DOTALL)


def _ladder_arg(v):
    """Bucket/slot ladders ride the wire as int lists — except the
    literal string 'auto', which must reach the SERVER intact so the
    ladder resolves against the server's device kind, observed traffic,
    and tuning cache (autotune), not the client's."""
    if v is None or (isinstance(v, str) and v.strip().lower() == "auto"):
        return v
    return [int(x) for x in v]


def _raise_typed(e: RuntimeError):
    m = _ERR_RE.match(str(e))
    if m and m.group(1) in _TYPED:
        raise _TYPED[m.group(1)](m.group(2)) from e
    raise


class TokenStream:
    """Iterator over one streaming generate: yields tokens
    as the server decodes them, pulling chunked continuation frames
    over the framed RPC. The CLIENT owns the cursor (every frame names
    its offset explicitly), so a retransmitted frame after a lost reply
    is answered token-exact — and a fleet router can resume the same
    cursor on a different replica after a failover.

    ``delivered`` counts tokens handed to the caller; after exhaustion
    ``result`` holds the final dict (tokens / prompt_len / version /
    steps_to_first_token). ``close()`` (idempotent, best-effort) tells
    the server to cancel an unfinished sequence; iterating to the end
    closes automatically. Typed serving errors (DeadlineExceeded, ...)
    raise out of iteration; transport failures raise ConnectionError —
    the router's failover signal."""

    def __init__(self, cli: "ServingClient", model: str,
                 header: Dict[str, Any], wait_ms: float = 20000.0):
        self._cli = cli
        self._id = str(header["stream"])
        self._wait_ms = float(wait_ms)
        self._pending: deque = deque()
        self._next_offset = 0
        self._done = False
        self._closed = False
        self.model = str(model)
        self.version = int(header["version"])
        self.prompt_len = int(header["prompt_len"])
        self.delivered = 0
        self.result: Optional[Dict[str, Any]] = None

    def __iter__(self) -> "TokenStream":
        return self

    def __next__(self) -> int:
        while not self._pending and not self._done:
            try:
                resp = self._cli._stream_next(
                    self._id, self._next_offset, self._wait_ms)
            except StreamExpired:
                # the server already dropped the stream — nothing left
                # to close
                self._closed = True
                raise
            except ServingError:
                # terminal typed failure (DeadlineExceeded, retirement,
                # ...): release the server-side stream slot NOW instead
                # of leaving it to the idle-TTL sweep — a burst of
                # failed streams must not pin the bounded table
                self.close()
                raise
            self._pending.extend(int(t) for t in resp["tokens"])
            self._next_offset = int(resp["next_offset"])
            if resp.get("done"):
                self._done = True
                self.result = resp.get("result")
        if self._pending:
            self.delivered += 1
            return self._pending.popleft()
        self.close()
        raise StopIteration

    def close(self):
        """Release the server-side stream (cancels an unfinished
        sequence). Best-effort: a dead server's stream dies with it."""
        if self._closed:
            return
        self._closed = True
        try:
            self._cli._stream_close(self._id)
        except (ConnectionError, OSError, ServingError):
            pass

    def __enter__(self) -> "TokenStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ServingClient:
    """Blocking client for one ServingServer endpoint."""

    def __init__(self, addr, timeout: float = 180.0, retries: int = 3):
        self._rpc = RpcClient(addr, timeout=timeout, retries=retries)

    def infer(self, model: str, feeds: Dict[str, Any],
              deadline_ms: Optional[float] = None
              ) -> Tuple[List[np.ndarray], int]:
        """Returns (outputs, served_version). Raises ServerOverloaded /
        DeadlineExceeded / ModelNotFound / RequestTooLarge."""
        wire_feeds = {str(k): np.asarray(v) for k, v in feeds.items()}
        try:
            resp = self._rpc.call("infer", model, wire_feeds, deadline_ms)
        except RuntimeError as e:
            _raise_typed(e)
        return ([np.asarray(o) for o in resp["outputs"]],
                int(resp["version"]))

    def generate(self, model: str, prompt: Sequence[int],
                 max_new_tokens: int = 16,
                 deadline_ms: Optional[float] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 seed: int = 0, stream: bool = False,
                 stream_wait_ms: float = 20000.0
                 ) -> Union[Dict[str, Any], TokenStream]:
        """Autoregressive decode on a loaded decoder. Buffered
        (default) returns ``{"model", "version", "tokens",
        "prompt_len"}`` when the whole sequence finishes;
        ``stream=True`` returns a ``TokenStream`` that yields tokens AS
        THEY DECODE — the first one ~ceil(prompt/prefill_chunk) decode
        steps after admission instead of after the last token (the
        chunked-prefill win, finally visible to a client). Transport
        retries are dedup-safe either way: a retransmitted generate (or
        stream frame) is answered from the server's cache without
        re-decoding. ``temperature``/``top_k``/``seed`` select the
        per-request sampling policy (0.0 = greedy argmax; sampled
        output is deterministic given the seed — which is also what
        makes a fleet-level stream resume exact)."""
        prompt = [int(t) for t in prompt]
        try:
            if stream:
                header = self._rpc.call(
                    "generate_stream_start", model, prompt,
                    int(max_new_tokens), deadline_ms, float(temperature),
                    int(top_k), int(seed))
                return TokenStream(self, model, header,
                                   wait_ms=stream_wait_ms)
            return self._rpc.call(
                "generate", model, prompt,
                int(max_new_tokens), deadline_ms, float(temperature),
                int(top_k), int(seed))
        except RuntimeError as e:
            _raise_typed(e)

    def _stream_next(self, stream_id: str, offset: int,
                     wait_ms: float) -> Dict[str, Any]:
        try:
            return self._rpc.call("generate_stream_next", stream_id,
                                  int(offset), float(wait_ms))
        except RuntimeError as e:
            _raise_typed(e)

    def _stream_close(self, stream_id: str) -> Dict[str, Any]:
        try:
            return self._rpc.call("generate_stream_close", stream_id)
        except RuntimeError as e:
            _raise_typed(e)

    # -- typed workloads ------------------------------------------------
    def workload(self, model: str, workload: Dict[str, Any]
                 ) -> Dict[str, Any]:
        """Run one typed workload — a dict with a ``kind`` field
        ('generate' | 'constrained' | 'embed' | 'beam'; see
        serving.workloads.parse_workload for each kind's fields) — on a
        loaded decoder. Unknown kinds/fields refuse server-side before
        any engine work. Transport retries are dedup-safe: a
        retransmitted workload (beam included) is answered from the
        server's reply cache, never re-decoded."""
        try:
            return self._rpc.call("workload", model, dict(workload))
        except RuntimeError as e:
            _raise_typed(e)

    def constrained(self, model: str, prompt: Sequence[int], mask: Any,
                    max_new_tokens: int = 16,
                    deadline_ms: Optional[float] = None,
                    temperature: float = 0.0, top_k: int = 0,
                    seed: int = 0) -> Dict[str, Any]:
        """Grammar-constrained decode: ``mask`` is a TokenMaskSpec or
        its wire dict; disallowed tokens are masked from the logits
        before the per-(seed, position) choice, so output is exactly as
        deterministic as unconstrained generate."""
        if hasattr(mask, "to_dict"):
            mask = mask.to_dict()
        return self.workload(model, {
            "kind": "constrained", "prompt": [int(t) for t in prompt],
            "mask": dict(mask), "max_new_tokens": int(max_new_tokens),
            "deadline_ms": deadline_ms,
            "temperature": float(temperature), "top_k": int(top_k),
            "seed": int(seed)})

    def embed(self, model: str, prompt: Sequence[int],
              deadline_ms: Optional[float] = None) -> Dict[str, Any]:
        """Prompt-only embedding/scoring: mean-pooled final hidden
        state + per-token logprobs, served from the decoder's embed
        lane (load it with ``embeddings=True``) without occupying any
        decode slot."""
        return self.workload(model, {
            "kind": "embed", "prompt": [int(t) for t in prompt],
            "deadline_ms": deadline_ms})

    def beam(self, model: str, prompt: Sequence[int], k: int = 2,
             max_new_tokens: int = 16,
             deadline_ms: Optional[float] = None) -> Dict[str, Any]:
        """n-best decode: the k best single-token forks, each decoded
        greedily to ``max_new_tokens``, sharing the prompt's KV pages
        via the server decoder's prefix index (load with
        ``prefix_cache=True``)."""
        return self.workload(model, {
            "kind": "beam", "prompt": [int(t) for t in prompt],
            "k": int(k), "max_new_tokens": int(max_new_tokens),
            "deadline_ms": deadline_ms})

    def load_decoder(self, model: str,
                     spec: Optional[Dict[str, Any]] = None,
                     version: Optional[int] = None,
                     slots: Optional[Sequence[int]] = None,
                     page_size: Optional[int] = None,
                     num_pages: Optional[int] = None,
                     max_seq_len: Optional[int] = None,
                     max_queue: Optional[int] = None,
                     prefill_chunk: Optional[int] = None,
                     checkpoint_dir: Optional[str] = None,
                     prefix_cache: Optional[bool] = None,
                     reservation: Optional[str] = None,
                     draft_spec: Optional[Dict[str, Any]] = None,
                     draft_checkpoint_dir: Optional[str] = None,
                     spec_k: Optional[int] = None,
                     mesh_axes: Optional[str] = None,
                     embeddings: bool = False
                     ) -> Dict[str, Any]:
        """Deploy a DecodeEngine; hot-swaps like load_model. From a
        ``spec`` dict (see serving.decode.DecoderSpec) the server
        builds the deterministic seed decoder; ``checkpoint_dir`` (a
        path on the SERVER's filesystem) deploys real weights from a
        manifest checkpoint — spec optional then, and if given it must
        match the checkpoint's. ``prefill_chunk`` pins the chunked-
        prefill token budget (None = the server resolves it through its
        autotune cache/FLAGS). ``prefix_cache``/``reservation`` pin the
        KV policies (prompt-prefix KV reuse; 'demand' vs
        'worst_case' page reservation) — None defers to the server's
        FLAGS. ``draft_spec``/``draft_checkpoint_dir``/``spec_k``
        attach a speculative draft decoder (the draft
        proposes spec_k tokens per slot per round, the target verifies
        them in one chunked step; output stays bitwise-equal to
        non-speculative decode). spec_k=None defers to the server's
        autotune cache/FLAGS; a vocab/eos-mismatched draft is refused
        typed at load. ``mesh_axes`` (e.g. "tp=2") makes the
        replica SPAN chips — params shard per the decoder rules and the
        paged KV pool shards over the kv-head axis; '' pins single-chip
        even when the checkpoint recorded a mesh, None defers to the
        checkpoint's recording, then the server's FLAGS.
        ``embeddings=True`` warms the embed lane's compiled
        shapes so the decoder also serves prompt-only
        embedding/scoring workloads."""
        try:
            return self._rpc.call(
                "load_decoder", model,
                None if spec is None else dict(spec), version,
                _ladder_arg(slots),
                page_size, num_pages, max_seq_len, max_queue,
                None if prefill_chunk is None else int(prefill_chunk),
                None if checkpoint_dir is None else str(checkpoint_dir),
                None if prefix_cache is None else bool(prefix_cache),
                None if reservation is None else str(reservation),
                None if draft_spec is None else dict(draft_spec),
                (None if draft_checkpoint_dir is None
                 else str(draft_checkpoint_dir)),
                None if spec_k is None else int(spec_k),
                None if mesh_axes is None else str(mesh_axes),
                bool(embeddings))
        except RuntimeError as e:
            _raise_typed(e)

    def load_model(self, model: str, dirname: str,
                   version: Optional[int] = None, kind: str = "auto",
                   buckets: Optional[Sequence[int]] = None,
                   max_queue: Optional[int] = None,
                   max_wait_ms: Optional[float] = None) -> Dict[str, Any]:
        try:
            return self._rpc.call("load_model", model, dirname, version,
                                  kind, _ladder_arg(buckets),
                                  max_queue, max_wait_ms)
        except RuntimeError as e:
            _raise_typed(e)

    def unload_model(self, model: str) -> Dict[str, Any]:
        try:
            return self._rpc.call("unload_model", model)
        except RuntimeError as e:
            _raise_typed(e)

    def list_models(self) -> Dict[str, Any]:
        return self._rpc.call("list_models")

    def load_report(self) -> Dict[str, Any]:
        """Structured per-model load snapshot (free KV pages, live
        slots, queue depths, model/version set) — the routing signal;
        idempotent server-side, so scraping it never occupies
        dedup-cache slots."""
        return self._rpc.call("load_report")

    def health(self) -> Dict[str, Any]:
        return self._rpc.call("health")

    def close(self):
        self._rpc.close()
