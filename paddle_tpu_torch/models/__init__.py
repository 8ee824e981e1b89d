"""Models built on the port's fluid layers (the counterpart of
``paddle_tpu.models``): the Transformer NMT, ResNet (training and fused
inference forms), LeNet, VGG-16, the stacked LSTM text classifier and
the control-flow programs of seq2seq (DynamicRNN LSTM, machine
translation train and beam decode, seq_to_seq_net)."""
from . import lenet, resnet, seq2seq, stacked_lstm, transformer, vgg  # noqa: F401
