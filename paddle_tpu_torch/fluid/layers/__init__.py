"""Layer functions of the port (``paddle_tpu/fluid/layers`` for the ops
ported so far)."""
from . import control_flow, detection, io, learning_rate_scheduler, nn, ops, pipeline, sequence, tensor  # noqa: F401
from .learning_rate_scheduler import *  # noqa: F401,F403
from .control_flow import *  # noqa: F401,F403
from .pipeline import Pipeline  # noqa: F401
from .detection import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .sequence import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
from . import math_op_patch  # noqa: F401  (patches the Variable operators)
