"""paddle_tpu_torch.distributed — the RPC transport under the serving
server, and the deterministic fault injection it consults."""
from . import faults  # noqa: F401
