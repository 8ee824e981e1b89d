"""paddle_tpu_torch.serving — decode serving in PyTorch.

The counterpart of ``paddle_tpu.serving``'s decode path: a
``DecodeEngine`` does continuous batching over a paged KV cache
(``kv_cache.py``) with the hand-written ragged paged-attention kernel,
behind a ``ModelRegistry`` that hot-swaps versions and a
``ServingServer``/``ServingClient`` pair on the RPC transport
(``generate``/``load_decoder`` and token streaming). The one-shot
``InferenceEngine`` and the typed workloads wait for later slices.
"""
from .client import ServingClient, TokenStream
from .decode import (DecodeEngine, DecoderSpec, build_decoder_params,
                     params_from_jax, sample_token, validate_draft_spec)
from .engine import default_buckets, parse_buckets, resolve_bucket_spec
from .errors import (DeadlineExceeded, EngineRetired, ModelNotFound,
                     RequestTooLarge, ServerOverloaded, ServingError,
                     StreamExpired)
from .kv_cache import PageAllocator, PagedKvCache
from .registry import ModelRegistry
from .server import ServingServer

__all__ = [
    "DecodeEngine", "DecoderSpec", "ModelRegistry", "ServingServer",
    "ServingClient", "TokenStream", "PageAllocator", "PagedKvCache",
    "ServingError", "ServerOverloaded", "DeadlineExceeded",
    "ModelNotFound", "RequestTooLarge", "EngineRetired", "StreamExpired",
    "build_decoder_params", "params_from_jax",
    "default_buckets", "parse_buckets", "resolve_bucket_spec",
    "sample_token", "validate_draft_spec",
]
