"""paddle_tpu_torch.serving — inference and decode serving in PyTorch.

The counterpart of ``paddle_tpu.serving``: an ``InferenceEngine``
batches one-shot requests into a bucket ladder over a saved Fluid
program (``load_model``/``infer``; the fused ResNet runs the
hand-written conv kernel), and a ``DecodeEngine`` does continuous
batching over a paged KV cache (``kv_cache.py``) with the hand-written
ragged paged-attention kernel (``load_decoder``/``generate`` and token
streaming), speculative decoding with a draft decoder, and the typed
workloads (``workloads/``: constrained, embed, beam) over it. Both sit
behind a ``ModelRegistry`` that hot-swaps versions and a
``ServingServer``/``ServingClient`` pair on the RPC transport; decoders
deploy from a spec or a checkpoint (``paddle_tpu_torch.checkpoint``).
``python -m paddle_tpu_torch.serving --serve --load NAME=DIR`` starts a
server.
"""
from .client import ServingClient, TokenStream
from .decode import (DecodeEngine, DecoderSpec, build_decoder_params,
                     params_from_jax, sample_token, validate_draft_spec)
from .engine import (InferenceEngine, default_buckets, parse_buckets,
                     resolve_bucket_spec)
from .errors import (DeadlineExceeded, EngineRetired, ModelNotFound,
                     RequestTooLarge, ServerOverloaded, ServingError,
                     StreamExpired)
from .kv_cache import PageAllocator, PagedKvCache
from .registry import ModelRegistry
from .server import ServingServer

__all__ = [
    "DecodeEngine", "DecoderSpec", "InferenceEngine", "ModelRegistry",
    "ServingServer",
    "ServingClient", "TokenStream", "PageAllocator", "PagedKvCache",
    "ServingError", "ServerOverloaded", "DeadlineExceeded",
    "ModelNotFound", "RequestTooLarge", "EngineRetired", "StreamExpired",
    "build_decoder_params", "params_from_jax",
    "default_buckets", "parse_buckets", "resolve_bucket_spec",
    "sample_token", "validate_draft_spec",
]
