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
the optimizers (``SGD``, ``Momentum``, ``Adam``, ``Adagrad``,
``Adamax``, ``DecayedAdagrad``, ``Adadelta``, ``RMSProp``, ``Ftrl``,
``ModelAverage``) with gradient clipping (``clip``), weight decay
(``regularizer``), per-parameter learning rates and the LR schedules
(``layers.exponential_decay`` ... ``noam_decay``); ``layers.Recompute``;
``average.WeightedAverage``; ``Executor``, ``Scope``, ``scope_guard``;
``io`` (``save_inference_model``, ``load_inference_model``,
``save_vars``/``load_vars``, ``save_persistables``/``load_persistables``
in both forms, ``save_checkpoint``/``load_checkpoint``); the data input
stack: ``DataFeeder``, the reader layers (``open_recordio_file``,
``open_files``, ``shuffle``, ``batch``, ``multi_pass``,
``double_buffer``, ``read_file``, ``reset_reader``) run by the
executor's host pre-pass (``readers.py``), ``recordio_writer``; the
padded-sequence path: ``dynamic_lstm``, ``sequence_pool``,
``sequence_first_step``/``_last_step``; control flow: ``While``,
``ConditionalBlock``, ``Switch``, ``IfElse``, ``StaticRNN``,
``DynamicRNN``, the tensor arrays, ``beam_search`` and
``beam_search_decode``, with the activation, compare, logical and
reduce layers; the text, image and detection layers; SelectedRows
gradients (``embedding(is_sparse=True)``, ``selected_rows``) through
every optimizer, the rest of the op library's layers (``nce``,
``hsigmoid``, ...), ``evaluator``, ``metrics``, ``default_scope_funcs``,
``calc_gradient`` and ``WeightNormParamAttr``; ``ParallelExecutor`` on a
DTensor mesh (data-parallel, tensor-parallel and fully sharded plans),
``get_places``/``ParallelDo``, ``layers.moe`` and the
``DistributeTranspiler`` facade, with parameter-server training: the
executor runs the transpiler's ``send``/``recv``/``prefetch`` ops
against ``start_pserver``'s servers (``layers.Send``, ``Recv``,
``ListenAndServ``); the tool modules ``memory_optimization_transpiler``
(``memory_optimize``, ``release_memory``), ``profiler``, ``debugger``,
``graphviz`` and ``net_drawer``; ``concurrency`` (``Go``,
``make_channel``, ``Select`` over the port's native channel). The
executor runs on the card unless given ``CPUPlace()`` (or ``"cpu"``).
"""
from . import core  # noqa: F401
from . import ops as _ops  # registers the op emitters  # noqa: F401
from . import (  # noqa: F401
    average,
    backward,
    clip,
    concurrency,
    default_scope_funcs,
    distribute_transpiler,
    enforce,
    evaluator,
    initializer,
    io,
    layers,
    metrics,
    nets,
    optimizer,
    parallel_executor,
    param_attr,
    profiler,
    readers,
    recordio_writer,
    regularizer,
    selected_rows,
    unique_name,
)
from .memory_optimization_transpiler import (  # noqa: F401
    memory_optimize,
    release_memory,
)
from .backward import append_backward, calc_gradient  # noqa: F401
from . import debugger, graphviz, net_drawer  # noqa: F401
from .clip import (  # noqa: F401
    ErrorClipByValue,
    GradientClipByGlobalNorm,
    GradientClipByNorm,
    GradientClipByValue,
    set_gradient_clip,
)
from .convert import params_from_jax  # noqa: F401
from .core import CPUPlace, CUDAPlace  # noqa: F401
from .data_feeder import DataFeeder  # noqa: F401
from .distribute_transpiler import DistributeTranspiler  # noqa: F401
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
    load_checkpoint,
    load_inference_model,
    load_params,
    load_persistables,
    load_vars,
    save_checkpoint,
    save_inference_model,
    save_params,
    save_persistables,
    save_vars,
)
from .parallel_executor import ParallelExecutor  # noqa: F401
from .param_attr import ParamAttr, WeightNormParamAttr  # noqa: F401

Tensor = None  # runtime tensors are torch.Tensors; alias kept for API scripts
