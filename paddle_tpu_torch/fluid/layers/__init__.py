"""Layer functions of the port (``paddle_tpu/fluid/layers`` for the ops
ported so far)."""
from . import control_flow, io, nn, ops, sequence, tensor  # noqa: F401
from .control_flow import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .sequence import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
