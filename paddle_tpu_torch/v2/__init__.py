"""v2-compatible API facade (reference python/paddle/v2/ — the 2016-era
event-loop framework: trainer.py SGD:37/train:137, layer.py, parameters.py,
inference.py).

Capability, not code, parity: v2-style programs — build a cost layer,
create parameters, run an event-handler training loop — execute on the
port's Fluid core underneath (one Program, the eager Executor). The layer
DSL maps onto fluid layers.

Device: ``init(use_gpu=False)`` is the caller asking for the CPU, and
``init()`` or ``init(use_gpu=True)`` the card; ``create``, ``SGD`` and
``infer`` run there. Each also takes ``device=``; ``None``
means the device ``init`` chose, or else the card, which raises without
one. Nothing falls back to the CPU on its own."""
from .. import batch, reader  # noqa: F401
from .. import dataset  # noqa: F401
from . import (  # noqa: F401
    attr, data_feeder, evaluator, event, image, layer, minibatch, networks,
    op, optimizer, plot, topology,
)
from .layer import activation, data_type, pooling  # noqa: F401
from .topology import Topology  # noqa: F401
from .inference import infer  # noqa: F401
from .parameters import Parameters, create  # noqa: F401
from .parameters import _set_init_device
from .trainer import SGD  # noqa: F401


def init(use_gpu: bool = True, trainer_count: int = 1, **kwargs):
    """reference paddle.init: choose the device of the v2 entry points
    that follow — the card unless ``use_gpu=False`` asks for the CPU (a
    raise where there is no card). ``trainer_count`` is accepted for
    source compatibility (parallelism is the ParallelExecutor's)."""
    _set_init_device("cuda" if use_gpu else "cpu")
