"""paddle_tpu_torch.fluid — the Fluid Program IR, layers, generic
backward, optimizers and an eager Executor in PyTorch (the counterpart of
``paddle_tpu.fluid``; reference python/paddle/fluid/__init__.py).

Ported so far: what training the repo's Transformer (and fit_a_line),
training ResNet, LeNet and VGG-16, and serving the fused ResNet need —
Program/Block/Operator/Variable/Parameter with ``to_bytes`` /
``parse_from_bytes`` in the JAX package's format, ``layers.data``,
``fc``, ``embedding``, ``conv2d``, ``batch_norm``, ``conv2d_bn_relu``,
``pool2d``, ``layer_norm``, ``dropout``, ``softmax``,
``softmax_with_cross_entropy``, ``accuracy``, ``topk``, ``mean``,
``reshape``, ``transpose``, ``matmul``, ``ring_attention``,
``elementwise_add``/``_sub``, ``square_error_cost``,
``create_parameter``, ``fill_constant``, ``assign``; ``nets``
(``simple_img_conv_pool``, ``img_conv_group``); ``append_backward``;
``SGD``, ``Momentum`` and ``Adam``; ``Executor``,
``Scope``, ``scope_guard``; ``io`` (``save_inference_model``,
``load_inference_model``, ``save_vars``/``load_vars``); the data input
stack: ``DataFeeder``, the reader layers (``open_recordio_file``,
``open_files``, ``shuffle``, ``batch``, ``multi_pass``,
``double_buffer``, ``read_file``, ``reset_reader``) run by the
executor's host pre-pass (``readers.py``), ``recordio_writer``; the
padded-sequence path: ``dynamic_lstm``, ``sequence_pool``,
``sequence_first_step``/``_last_step``. The executor runs on the card
unless given ``CPUPlace()`` (or ``"cpu"``).
"""
from . import core  # noqa: F401
from . import ops as _ops  # registers the op emitters  # noqa: F401
from . import (  # noqa: F401
    backward,
    enforce,
    initializer,
    io,
    layers,
    nets,
    optimizer,
    param_attr,
    readers,
    recordio_writer,
    unique_name,
)
from .backward import append_backward  # noqa: F401
from .convert import params_from_jax  # noqa: F401
from .core import CPUPlace, CUDAPlace  # noqa: F401
from .data_feeder import DataFeeder  # noqa: F401
from .enforce import EnforceNotMet  # noqa: F401
from .executor import (  # noqa: F401
    Executor,
    Scope,
    fetch_var,
    global_scope,
    scope_guard,
)
from .framework import (  # noqa: F401
    Block,
    Operator,
    Parameter,
    Program,
    Variable,
    default_main_program,
    default_startup_program,
    program_guard,
)
from .initializer import Constant, MSRA, Normal, Uniform, Xavier  # noqa: F401
from .io import (  # noqa: F401
    load_inference_model,
    load_params,
    load_vars,
    save_inference_model,
    save_params,
    save_vars,
)
from .param_attr import ParamAttr  # noqa: F401
