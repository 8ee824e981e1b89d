"""Models built on the port's fluid layers (the counterpart of
``paddle_tpu.models``): the Transformer NMT, ResNet (training and fused
inference forms), LeNet, VGG-16, the legacy benchmark suite's AlexNet,
GoogLeNet and SmallNet, the stacked LSTM text classifier and the
control-flow programs of seq2seq (DynamicRNN LSTM, machine translation
train and beam decode, seq_to_seq_net)."""
from . import (  # noqa: F401
    alexnet, googlenet, lenet, resnet, seq2seq, smallnet, stacked_lstm,
    transformer, vgg)
