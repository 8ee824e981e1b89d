"""Models built on the port's fluid layers (the counterpart of
``paddle_tpu.models``): the Transformer NMT and ResNet (fused inference
form)."""
from . import resnet, transformer  # noqa: F401
