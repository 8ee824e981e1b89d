"""Models built on the port's fluid layers (the counterpart of
``paddle_tpu.models``): the Transformer NMT, ResNet (training and fused
inference forms), LeNet and VGG-16."""
from . import lenet, resnet, transformer, vgg  # noqa: F401
