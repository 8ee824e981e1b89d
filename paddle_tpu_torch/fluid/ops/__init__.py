"""Op emitters of the port, registered at import (the counterpart of
``paddle_tpu/fluid/ops``). So far: the ops of the Transformer training
path, of fit_a_line, of the image-classification training path (ResNet,
LeNet, VGG), of the fused ResNet inference path and of the stacked LSTM
(``sequence_pool``, ``lstm``). Any other op type
raises "no emitter registered ... (not yet ported)" when a program
containing it is built or run."""
from . import (  # noqa: F401
    attention_ops,
    elementwise,
    loss_ops,
    math_ops,
    metric_ops,
    nn_ops,
    optimizer_ops,
    random_ops,
    sequence_ops,
    tensor_ops,
)
