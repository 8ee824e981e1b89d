"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu, slice by slice.

The JAX package ``paddle_tpu`` is the reference; this package imports
neither it nor ``jax``. It ports decode serving (the paged KV cache, the
continuous-batching ``DecodeEngine``, the RPC server and client), fused
ResNet inference serving, and Fluid training (``paddle_tpu_torch.fluid``:
the Program IR, layers, backward, optimizers, an eager Executor, the
data input stack of ``DataFeeder`` and in-graph readers, control flow
and beam search) of the Transformer, ResNet-50, LeNet, VGG-16,
fit_a_line, the stacked LSTM, the DynamicRNN LSTM and the book's
machine translation, and the mesh layer (``mesh``, ``parallel``:
``fluid.ParallelExecutor`` on a DTensor ``DeviceMesh``).
Every TPU kernel on those paths is rewritten by hand in CUDA C++ for
Hopper (``csrc/``). ``reader``, ``dataset`` and ``batch`` are the JAX
package's top-level data helpers. Entry points run on the card unless
the caller passes ``device="cpu"``.
"""
from . import dataset, reader  # noqa: F401
from .reader import batch  # noqa: F401
from .serving import (  # noqa: F401
    DecodeEngine,
    DecoderSpec,
    ServingClient,
    ServingServer,
    build_decoder_params,
    params_from_jax,
)

__all__ = ["DecodeEngine", "DecoderSpec", "ServingClient", "ServingServer",
           "batch", "build_decoder_params", "dataset", "params_from_jax",
           "reader"]
