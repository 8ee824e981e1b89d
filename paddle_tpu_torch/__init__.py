"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu, slice by slice.

The JAX package ``paddle_tpu`` is the reference; this package imports
neither it nor ``jax``. So far it ports decode serving: the paged KV
cache, the continuous-batching ``DecodeEngine`` and the RPC server and
client, with the ragged paged-attention TPU kernel rewritten by hand in
CUDA C++ for Hopper (``csrc/paged_attention.cu``). Entry points run on
the card unless the caller passes ``device="cpu"``.
"""
from .serving import (  # noqa: F401
    DecodeEngine,
    DecoderSpec,
    ServingClient,
    ServingServer,
    build_decoder_params,
    params_from_jax,
)

__all__ = ["DecodeEngine", "DecoderSpec", "ServingClient", "ServingServer",
           "build_decoder_params", "params_from_jax"]
