"""Models built on the port's fluid layers (the counterpart of
``paddle_tpu.models``): the Transformer NMT, ResNet (training and fused
inference forms), LeNet, VGG-16 and the stacked LSTM text classifier."""
from . import lenet, resnet, stacked_lstm, transformer, vgg  # noqa: F401
