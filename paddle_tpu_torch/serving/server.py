"""ServingServer — the RPC front door of the serving path: one-shot
Fluid inference models and autoregressive decoders.

Rides distributed/rpc.py (length-prefixed JSON + raw-segment framing),
so serving inherits idempotency-token dedup, retry-safe clients,
per-method latency histograms, trace-context adoption, and named fault
sites for chaos plans.

Methods (all fire the `serving.<method>` fault site before running, so
`PADDLE_TPU_FAULTS='error@serving.infer:0'` chaos plans reach them):

    infer(model, feeds, deadline_ms)   -> {model, version, outputs}
    generate(model, prompt, max_new_tokens, deadline_ms, ...)
                                       -> {model, version, tokens,
                                           prompt_len, ...}
    generate_stream_start(model, prompt, ...)
                                       -> {stream, version, prompt_len}
    generate_stream_next(stream, offset, wait_ms)
                                       -> {tokens, next_offset, done,
                                           result?} — the pull half of
                                          STREAMING generate
    generate_stream_close(stream)      -> cancels an unfinished stream
    load_model(model, dirname, ...)    -> engine stats (after the warm of
                                          every bucket)
    workload(model, workload)          -> one typed workload: generate,
                                          constrained, embed or beam
                                          (serving/workloads)
    load_decoder(model, spec, ...,
                 checkpoint_dir=)      -> decode-engine stats (after the
                                          full slot/width/chunk warm);
                                          checkpoint_dir deploys real
                                          weights from a verified
                                          manifest checkpoint
    unload_model(model)                -> final engine stats
    list_models()                      -> {name: stats}
    load_report()                      -> structured per-model load
                                          (free KV pages, live slots,
                                          queue depths) — the routing
                                          signal
    health()                           -> {"ok": True, "models": [...]}

``load_model`` serves a ``save_inference_model`` directory (written by
this package or by the JAX one) through an ``InferenceEngine`` on the
server's device; ``kind="exported"`` (a JAX StableHLO artifact) is
refused with a typed ``ServingError``. ``load_decoder(mesh_axes=...)``
serves one decoder sharded over the process group's ranks (every rank
runs the same deploy; rank 0 answers the requests); a checkpoint that
records a mesh deploys sharded over it unless ``mesh_axes`` says
otherwise (``''`` pins one device).

Retry semantics: `infer`, `generate`, `workload` and the three stream
methods ride the dedup cache — a retransmit after a lost reply is answered from the
cached response without re-running the batch (or re-decoding a whole
sequence and re-reserving KV pages), and a retransmitted
`generate_stream_start` must not admit a SECOND sequence. Each stream
frame is a pure read of (stream state, client-owned offset), so a
retransmitted frame is token-exact. `health`/`list_models`/`load_report`
are declared idempotent: cheap reads whose responses must not occupy
dedup-cache slots. Overload/deadline/not-found rejections are
application errors — RpcClient never retries them.

A hot-swap retires the old engine only after the registry pointer
flipped; a request that raced the flip gets EngineRetired from the old
engine and is transparently resubmitted to the current one
(`serving.swap_resubmits`).

``ServingServer(device=None)`` serves on the card and raises when there
is none; tests pass ``device="cpu"``.
"""
from __future__ import annotations

import os
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..distributed import faults as _faults
from ..distributed.rpc import RpcServer
from ..device import resolve_device
from ..observability import metrics as _metrics, tracing as _tracing
from ..observability.log import get_logger
from .engine import InferenceEngine
from .errors import (EngineRetired, ModelNotFound, ServerOverloaded,
                     ServingError, StreamExpired)
from .registry import ModelRegistry

__all__ = ["ServingServer"]

_log = get_logger("serving")

_m_resubmits = _metrics.counter("serving.swap_resubmits")
# streaming generate: starts/chunks/tokens count what
# actually crossed the wire incrementally; expired counts abandoned
# streams the idle sweep canceled (their KV pages freed)
_m_stream_starts = _metrics.counter("serving.stream.starts")
_m_stream_chunks = _metrics.counter("serving.stream.chunks")
_m_stream_tokens = _metrics.counter("serving.stream.tokens")
_m_stream_expired = _metrics.counter("serving.stream.expired")


class ServingServer:
    """RPC serving front end over a ModelRegistry."""

    # a request may race at most this many consecutive retirements (each
    # get() after a retirement returns the freshly-flipped engine, so >1
    # loop only happens under back-to-back deploys)
    _SWAP_RETRIES = 8

    def __init__(self, registry: Optional[ModelRegistry] = None,
                 dedup_cap: int = 1024, max_streams: int = 256,
                 stream_ttl: Optional[float] = None, device=None):
        from ..flags import FLAGS

        # every model this server loads lives here (None = the card)
        self.device = resolve_device(device)
        self._registry = registry or ModelRegistry()
        # open token streams: stream id -> {req, engine,
        # model, touched}. Bounded (max_streams) and idle-swept: a
        # stream nobody polls for stream_ttl seconds is canceled so an
        # abandoned client can't pin KV pages forever
        self._streams_mu = threading.Lock()
        self._streams: Dict[str, Dict[str, Any]] = {}  # guarded-by: _streams_mu
        self._max_streams = int(max_streams)
        self._stream_ttl = float(FLAGS["serving_stream_ttl"]
                                 if stream_ttl is None else stream_ttl)
        self._last_sweep = 0.0  # guarded-by: _streams_mu
        handlers = {
            "infer": self._infer,
            "generate": self._generate,
            "workload": self._workload,
            "generate_stream_start": self._generate_stream_start,
            "generate_stream_next": self._generate_stream_next,
            "generate_stream_close": self._generate_stream_close,
            "load_model": self._load_model,
            "load_decoder": self._load_decoder,
            "unload_model": self._unload_model,
            "list_models": self._list_models,
            "load_report": self._load_report,
            "health": self._health,
        }
        self._rpc = RpcServer(
            {m: self._guarded(m, fn) for m, fn in handlers.items()},
            dedup_cap=dedup_cap,
            idempotent={"health", "list_models", "load_report"},
        )
        # serializes load_model/load_decoder end-to-end: auto-versioning
        # is a read-then-deploy sequence, and two concurrent deploys of
        # one model racing it would mint duplicate version numbers (deploys
        # are rare and warm-bound — serializing them costs nothing that
        # matters)
        self._load_mu = threading.Lock()

    @staticmethod
    def _guarded(method: str, fn):
        """Every handler fires its `serving.<method>` fault site first,
        so chaos plans (`error@serving.generate:0`) reach the serving layer
        by name — the same seam the RPC transport already has."""
        def handler(*args, **kw):
            _faults.fire(f"serving.{method}")
            return fn(*args, **kw)
        return handler

    @property
    def registry(self) -> ModelRegistry:
        return self._registry

    # -- lifecycle --------------------------------------------------------
    def serve(self, host: str = "127.0.0.1", port: int = 0
              ) -> Tuple[str, int]:
        addr = self._rpc.serve(host, port)
        _tracing.set_process_label(f"serving:{addr[1]}")
        _log.info("serving server listening on %s:%d", *addr)
        return addr

    @property
    def address(self) -> Tuple[str, int]:
        return self._rpc.address

    def shutdown(self, drain: bool = True):
        self._rpc.shutdown()
        self._registry.unload_all(drain=drain)

    def kill(self):
        """Chaos seam: die the way a SIGKILLed replica dies — the
        transport severs every established connection mid-whatever
        (peers see resets, lost replies, refused dials), and NOTHING is
        drained or unloaded: engines keep whatever they were doing,
        answers go nowhere. The fleet chaos tests kill replicas with
        this; a FleetRouter must fail the traffic over."""
        self._rpc.kill()

    # -- handlers ---------------------------------------------------------
    def _on_engine(self, model: str, want_decoder: bool, mismatch: str,
                   fn):
        """THE swap-resubmit contract, in one place for infer/generate/
        stream-start: a request that races a hot-swap gets EngineRetired
        from the old engine — the registry already points at the
        replacement, so resubmit there, never fail the request."""
        model = str(model)
        for _ in range(self._SWAP_RETRIES):
            engine = self._registry.get(model)
            if (engine.kind == "decoder") != want_decoder:
                raise ServingError(mismatch.format(model=model))
            try:
                return fn(engine)
            except EngineRetired:
                _m_resubmits.inc()
                continue
        raise ServingError(
            f"model '{model}' kept retiring across "
            f"{self._SWAP_RETRIES} resubmits — deploy storm?")

    def _infer(self, model: str, feeds: Dict[str, Any],
               deadline_ms: Optional[float] = None) -> Dict[str, Any]:
        with _tracing.span("serving.request", model=str(model)):
            def run(engine):
                outputs, version = engine.infer(
                    feeds, deadline_ms=deadline_ms)
                return {"model": str(model), "version": version,
                        "outputs": [np.asarray(o) for o in outputs]}

            return self._on_engine(
                model, False,
                "model '{model}' is a decoder — call generate, "
                "not infer", run)

    def _generate(self, model: str, prompt: Sequence[int],
                  max_new_tokens: int = 16,
                  deadline_ms: Optional[float] = None,
                  temperature: float = 0.0, top_k: int = 0,
                  seed: int = 0) -> Dict[str, Any]:
        """Autoregressive decode on a loaded DecodeEngine. Same swap-
        resubmit contract as _infer: racing a hot-swap re-enqueues on
        the replacement decoder instead of failing the request.
        Sampling params thread through per request (decode.sample_token;
        deterministic given seed, so the dedup cache's answer to a
        retransmit equals what a re-decode would have produced)."""
        with _tracing.span("serving.decode.request", model=str(model)):
            return self._on_engine(
                model, True,
                "model '{model}' is not a decoder — call infer, "
                "not generate",
                lambda engine: {
                    "model": str(model),
                    **engine.generate(
                        prompt, max_new_tokens=max_new_tokens,
                        deadline_ms=deadline_ms, temperature=temperature,
                        top_k=top_k, seed=seed)})

    def _workload(self, model: str, workload: Dict[str, Any]
                  ) -> Dict[str, Any]:
        """Typed-workload dispatch: one RPC, one ``kind`` field
        selecting generate/constrained/embed/beam. Parse STRICTLY before
        touching any engine (an unknown kind or misspelled field must
        refuse, not silently decode unconstrained), then run under the
        same swap-resubmit contract as _generate. Not in the transport's
        idempotent set: a retransmit after a lost reply is answered from
        the dedup cache, not recomputed."""
        from .workloads import parse_workload, run_workload

        w = parse_workload(workload)
        return self._on_engine(
            model, True,
            "model '{model}' is not a decoder — workloads need a "
            "DecodeEngine",
            lambda engine: {"model": str(model),
                            **run_workload(engine, w)})

    # -- streaming generate -----------------------------------------------
    def _sweep_streams(self):
        """Cancel + drop streams nobody polled for stream_ttl seconds.
        Collect under the lock, cancel outside it (cancel takes the
        ENGINE's condition — never nest it under _streams_mu). TIME-
        GATED: every stream method calls this, and under heavy frame
        traffic a full-table scan per frame would turn _streams_mu
        into a data-path serialization point — the TTL is a seconds-
        scale promise, so one scan per ~ttl/10 keeps it at an O(1)
        check per frame."""
        now = time.monotonic()
        expired: List[Tuple[Any, Any]] = []
        with self._streams_mu:
            gate = min(30.0, max(0.05, self._stream_ttl / 10.0))
            if now - self._last_sweep < gate:
                return
            self._last_sweep = now
            for sid in list(self._streams):
                ent = self._streams[sid]
                if now - ent["touched"] > self._stream_ttl:
                    expired.append(self._streams.pop(sid))
        for ent in expired:
            _m_stream_expired.inc()
            _log.warning("stream on '%s' idle past %.0fs — canceling "
                         "the abandoned sequence", ent["model"],
                         self._stream_ttl)
            try:
                ent["engine"].cancel(ent["req"], msg="stream abandoned")
            except Exception:  # pragma: no cover - engine mid-retire
                pass

    def _generate_stream_start(self, model: str, prompt: Sequence[int],
                               max_new_tokens: int = 16,
                               deadline_ms: Optional[float] = None,
                               temperature: float = 0.0, top_k: int = 0,
                               seed: int = 0) -> Dict[str, Any]:
        """Admit a decode sequence and hand back a stream id; tokens
        are pulled incrementally with generate_stream_next. Rides the
        dedup cache (NOT idempotent-declared): a retransmitted start
        after a lost reply is answered with the ORIGINAL stream id —
        one admission, one page reservation, no duplicate sequence."""
        self._sweep_streams()
        with _tracing.span("serving.stream.start", model=str(model)):
            def run(engine):
                req = engine.submit(
                    prompt, max_new_tokens=max_new_tokens,
                    deadline_ms=deadline_ms, temperature=temperature,
                    top_k=top_k, seed=seed)
                sid = uuid.uuid4().hex
                # bound checked at INSERT (one locked section, no
                # check-then-act window for concurrent starts to
                # overshoot through); the submit is withdrawn on refusal
                with self._streams_mu:
                    full = len(self._streams) >= self._max_streams
                    if not full:
                        self._streams[sid] = {
                            "req": req, "engine": engine,
                            "model": str(model),
                            "touched": time.monotonic()}
                if full:
                    engine.cancel(req, msg="stream table full")
                    raise ServerOverloaded(
                        f"too many open token streams "
                        f"({self._max_streams}) — close or drain some "
                        "first")
                _m_stream_starts.inc()
                return {"stream": sid, "model": str(model),
                        "version": engine.version,
                        "prompt_len": len(req.prompt)}

            return self._on_engine(
                model, True,
                "model '{model}' is not a decoder — streaming "
                "generate needs one", run)

    def _generate_stream_next(self, stream: str, offset: int,
                              wait_ms: float = 20000.0
                              ) -> Dict[str, Any]:
        """One continuation frame: every token past ``offset``, blocking
        (bounded) until at least one exists or the sequence ends. A pure
        read of the stream's request state — the client owns the cursor
        — so a retransmitted frame (dedup-answered OR re-executed) is
        token-exact with zero extra decode steps. A failed sequence
        re-raises its typed error."""
        # every stream method sweeps: the TTL promise must not depend
        # on another START ever arriving (steady frame-only traffic
        # would otherwise pin abandoned entries — and their retired
        # engines' KV pools — forever)
        self._sweep_streams()
        with self._streams_mu:
            ent = self._streams.get(str(stream))
            if ent is not None:
                ent["touched"] = time.monotonic()
        if ent is None:
            raise StreamExpired(
                f"unknown stream '{stream}' — closed, expired "
                f"(idle > {self._stream_ttl:.0f}s), or from a previous "
                "server life")
        out = ent["engine"].stream_tokens(
            ent["req"], offset, timeout=max(0.0, float(wait_ms)) / 1e3)
        _m_stream_chunks.inc()
        if out["tokens"]:
            _m_stream_tokens.inc(len(out["tokens"]))
        return out

    def _generate_stream_close(self, stream: str) -> Dict[str, Any]:
        """Drop the stream; an unfinished sequence is canceled (pages
        freed now, the scheduler drops its slot at the next answer
        phase). Rides the dedup cache like start, so a retransmitted
        close cannot cancel a stream id a later caller was handed."""
        self._sweep_streams()
        with self._streams_mu:
            ent = self._streams.pop(str(stream), None)
        canceled = False
        if ent is not None and not ent["req"].ev.is_set():
            try:
                canceled = ent["engine"].cancel(
                    ent["req"], msg="stream closed by client")
            except Exception:  # pragma: no cover - engine mid-retire
                pass
        return {"closed": ent is not None, "canceled": canceled}

    def _resolve_version(self, model: str, version: Optional[int]) -> int:
        """Auto-assign (live+1) or validate a pinned version. A pinned
        version EQUAL to the live one is refused: the new engine would
        mint the same per-version gauge series (queue_depth/live_slots/
        kv pool) and the old engine's retirement would then zero the
        live engine's gauges — the clobber the per-version keying
        exists to prevent. Redeploying an older (or any other) pinned
        version is fine; only the collision is an error."""
        try:
            live = self._registry.get(model).version
        except ModelNotFound:
            live = None
        if version is None:
            return 1 if live is None else live + 1
        version = int(version)
        if live is not None and version == live:
            raise ValueError(
                f"model '{model}' v{version} is already the live "
                f"version — pin a different version or omit it to "
                f"auto-assign v{live + 1}")
        return version

    def _resolve_decoder_artifact(self, what: str, spec, checkpoint_dir):
        """One rule for (spec dict, checkpoint_dir) -> (DecoderSpec,
        params, mesh_meta), shared by the target and the speculative
        draft: a checkpoint loads real weights (onto this server's
        device) and its saved spec, a bare spec builds the deterministic
        seed decoder, and giving both cross-validates — a contradiction
        is a wrong-model deploy, refused before any warm. ``mesh_meta``
        is the mesh the checkpoint RECORDED at export (None for
        one-device artifacts or bare specs)."""
        from .decode import DecoderSpec

        if checkpoint_dir is not None:
            from ..checkpoint import (decoder_checkpoint_mesh,
                                      load_decoder_checkpoint)

            use_spec, params = load_decoder_checkpoint(
                str(checkpoint_dir), device=self.device)
            mesh_meta = decoder_checkpoint_mesh(str(checkpoint_dir))
            if spec is not None:
                want = DecoderSpec.from_dict(dict(spec))
                if want.to_dict() != use_spec.to_dict():
                    raise ValueError(
                        f"{what} spec given to load_decoder contradicts "
                        f"checkpoint '{checkpoint_dir}': "
                        f"{want.to_dict()} != {use_spec.to_dict()}")
            return use_spec, params, mesh_meta
        if spec is None:
            return None, None, None
        return DecoderSpec.from_dict(dict(spec)), None, None

    def _load_decoder(self, model: str,
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
        """Build + warm (every slot/width/chunk shape) + atomically
        install a DecodeEngine on this server's device. ``checkpoint_dir``
        loads REAL weights (and the spec) from a manifest checkpoint
        (checksum-verified, a typed error naming the tensor on
        corruption); ``spec`` alone deploys the deterministic seed-built
        decoder; giving both cross-validates. ``draft_spec`` /
        ``draft_checkpoint_dir`` attach a speculative DRAFT decoder the
        same way (same vocab/eos as the target, refused typed naming the
        field) and ``spec_k`` pins the proposals per round. Hot-swapping
        a decoder drains the old engine — every in-flight SEQUENCE
        finishes on its own KV cache before the old pool releases.
        ``mesh_axes`` shards the engine over the process group's ranks
        (every rank runs this same deploy; rank 0 takes the requests).
        The mesh resolves as the JAX server's: an explicit ``mesh_axes``
        wins (``''`` pins one device), else the mesh the checkpoint
        recorded (with its rules), else ``FLAGS['serving_mesh_axes']``."""
        from .decode import DecodeEngine

        model = str(model)
        use_spec, params, ckpt_mesh = self._resolve_decoder_artifact(
            "target", spec, checkpoint_dir)
        if use_spec is None:
            raise ValueError(
                "load_decoder needs a spec dict or a checkpoint_dir")
        use_draft, draft_params, _ = self._resolve_decoder_artifact(
            "draft", draft_spec, draft_checkpoint_dir)
        mesh_arg: Optional[Any] = None
        mesh_rules_arg: Optional[Any] = None
        if mesh_axes is not None:
            mesh_arg = str(mesh_axes)
        elif ckpt_mesh is not None:
            from ..mesh import MeshSpec

            mesh_arg = MeshSpec.from_dict(ckpt_mesh["spec"])
            mesh_rules_arg = ckpt_mesh.get("rules")
        # lint: allow-blocking — deploys serialize end-to-end; see
        # _load_mu above. generate traffic never takes this lock.
        with self._load_mu:
            version = self._resolve_version(model, version)

            def build():
                return DecodeEngine(
                    use_spec, name=model, params=params,
                    version=version, slots=slots, page_size=page_size,
                    num_pages=num_pages, max_seq_len=max_seq_len,
                    max_queue=max_queue, prefill_chunk=prefill_chunk,
                    prefix_cache=(None if prefix_cache is None
                                  else bool(prefix_cache)),
                    reservation=(None if reservation is None
                                 else str(reservation)),
                    draft_spec=use_draft, draft_params=draft_params,
                    spec_k=(None if spec_k is None else int(spec_k)),
                    mesh=mesh_arg, mesh_rules=mesh_rules_arg,
                    embeddings=bool(embeddings), device=self.device)

            engine = self._registry.deploy(model, build)
            return engine.stats()

    def _load_model(self, model: str, dirname: str,
                    version: Optional[int] = None,
                    kind: str = "auto",
                    buckets: Optional[Sequence[int]] = None,
                    max_queue: Optional[int] = None,
                    max_wait_ms: Optional[float] = None) -> Dict[str, Any]:
        """Load + warm + atomically install `dirname` under `model`, on
        this server's device. `kind`: 'program' (save_inference_model
        dir) or 'auto' (sniff the artifact); 'exported' (a JAX StableHLO
        export_compiled_model dir) is refused with a typed error."""
        model = str(model)
        if kind == "auto":
            kind = ("exported"
                    if os.path.exists(os.path.join(
                        dirname, "__stablehlo__.bin"))
                    else "program")
        if kind == "exported":
            InferenceEngine.from_exported_dir(dirname)  # raises typed
        if kind != "program":
            raise ValueError(f"load_model kind {kind!r}: want 'program', "
                             "'exported' or 'auto'")
        # lint: allow-blocking — the whole deploy (load + per-bucket warm
        # + drain of the old engine) is deliberately serialized; see
        # _load_mu above. infer traffic never takes this lock.
        with self._load_mu:
            version = self._resolve_version(model, version)

            def build():
                return InferenceEngine.from_inference_dir(
                    dirname, name=model, version=version, buckets=buckets,
                    max_queue=max_queue, max_wait_ms=max_wait_ms,
                    device=self.device)

            engine = self._registry.deploy(model, build)
            return engine.stats()

    def _unload_model(self, model: str) -> Dict[str, Any]:
        return self._registry.unload(str(model))

    def _list_models(self) -> Dict[str, Any]:
        return self._registry.stats()

    def _load_report(self) -> Dict[str, Any]:
        """Cheap structured load snapshot for capacity-aware routing.
        One dict per loaded model with the signal a fleet router
        balances on: free KV pages + live/max slots for
        decoders (the *Ragged Paged Attention* page-table view of
        remaining capacity), queue depth vs bound for both kinds, and
        the model/version set a fleet rollout polls for convergence.
        A few lock-guarded dict reads per model, declared idempotent so
        a router's scrape cadence never pins the dedup cache."""
        models: Dict[str, Any] = {}
        for name, st in self._registry.stats().items():
            entry: Dict[str, Any] = {
                "version": st["version"],
                "kind": st["kind"],
                "queue_depth": st["queue_depth"],
                "max_queue": st["max_queue"],
                "stopping": st["stopping"],
            }
            if st["kind"] == "decoder":
                kv = st["kv"]
                entry["free_pages"] = kv["pages_free"]
                entry["pages_total"] = kv["pages_total"]
                entry["page_size"] = kv["page_size"]
                entry["live_slots"] = st["live"]
                entry["max_slots"] = max(st["slots"])
                entry["max_seq_len"] = st["max_seq_len"]
                # speculative proposals per round (0 = off)
                entry["spec_k"] = st.get("spec_k", 0)
                # a mesh-sharded replica: the axes this one engine spans
                if st.get("mesh"):
                    entry["mesh"] = st["mesh"]
                # prefix-cache warmth: the MRU depth-1
                # chain digests let a FleetRouter recognize a replica
                # whose cache already covers a request's prefix —
                # steps-to-first-token there is ceil(suffix/chunk),
                # not ceil(prompt/chunk)
                if st.get("prefix") is not None:
                    entry["prefix_cache"] = st["prefix"]
            models[name] = entry
        return {"ok": True, "models": models}

    def load_report(self) -> Dict[str, Any]:
        """In-process alias for the load_report RPC: the same snapshot,
        without a loopback dial — a fleet member piggybacks it on every
        heartbeat, and a beat must never block on its own
        server's RPC queue."""
        return self._load_report()

    def _health(self) -> Dict[str, Any]:
        return {"ok": True, "models": self._registry.names()}
