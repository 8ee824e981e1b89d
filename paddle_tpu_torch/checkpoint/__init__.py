"""paddle_tpu_torch.checkpoint — only the typed errors so far; the
manifest format and decoder checkpoint loading are still to be ported."""
from .errors import CheckpointCorruptError, CheckpointError  # noqa: F401
