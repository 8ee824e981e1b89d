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
the caller passes ``device="cpu"``. ``analysis`` holds the static
passes (``python -m paddle_tpu_torch.analysis``): the program verifier
the Executor runs under ``FLAGS['verify_programs']``, the lock, guard
and invariant lints, and the guard sanitizer that
``PADDLE_TPU_SANITIZE=guards`` installs at import. ``v2`` is the
2016-era event-loop API (``init``, ``layer``, ``create``, ``SGD``,
``infer``) over the Fluid layers, and ``compat.trainer_config_helpers``
the legacy config DSL over ``v2``.
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

# PADDLE_TPU_SANITIZE=guards: instrument the guarded-by-annotated runtime
# classes so every declared-guard access asserts its lock is held (the
# dynamic half of the analysis/guards.py lint). Nothing to import unset.
from .flags import FLAGS as _FLAGS  # noqa: E402

if _FLAGS["sanitize"]:
    from .analysis import sanitize as _sanitize

    _sanitize.maybe_install()

__all__ = ["DecodeEngine", "DecoderSpec", "ServingClient", "ServingServer",
           "batch", "build_decoder_params", "dataset", "params_from_jax",
           "reader"]
