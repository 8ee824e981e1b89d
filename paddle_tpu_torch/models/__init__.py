"""Models built on the port's fluid layers (the counterpart of
``paddle_tpu.models``): so far the Transformer NMT."""
from . import transformer  # noqa: F401
