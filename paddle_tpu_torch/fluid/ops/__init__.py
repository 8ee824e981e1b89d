"""Op emitters of the port, registered at import (the counterpart of
``paddle_tpu/fluid/ops``). So far: the ops of the Transformer training
path, of fit_a_line, of the image-classification training path (ResNet,
LeNet, VGG), of the fused ResNet inference path, of the stacked LSTM
(``sequence_pool``, ``lstm``), the activations, comparisons and
reductions, and Fluid control flow (``while``, ``conditional_block``,
``recurrent``, ``ifelse``, ``dynamic_recurrent``, the tensor arrays,
``recompute``) with beam search, the clip ops and every optimizer op of
the JAX package (dense gradients), and the recurrent, sequence, CRF, CTC
and text-metric ops of the book's text chapters (``gru``, ``lstmp``, the
LoD family, ``linear_chain_crf``, ``warpctc``, ``edit_distance``,
``chunk_eval``, ...), and the image and vision breadth (the conv
transposes, ``conv3d``, ``depthwise_conv2d``, the 3-D and indexed pools,
``unpool``, ``lrn``, ``spp``, ``roi_pool``, the resizes) with the SSD
detection ops (``prior_box``, ``box_coder``, ``bipartite_match``,
``multiclass_nms``, ``detection_map``, ...), and the rest of Fluid's
op library: SelectedRows gradients (a sparse ``lookup_table``'s, taken
by ``sum``, the clip ops and every optimizer op), the losses
(``nce``, ``hierarchical_sigmoid``, ``lambda_cost``, ...), sampling,
the gather/scatter family and the ranking and metric ops (``auc``,
``precision_recall``, ``positive_negative_pair``), and the GPipe
region ops ``pipeline`` and ``pipeline_cut``. Any other op type
raises "no emitter registered ... (not yet ported)" when a program
containing it is built or run."""
from . import (  # noqa: F401
    activations,
    attention_ops,
    beam_search_ops,
    compare_ops,
    control_flow,
    crf_ops,
    ctc_ops,
    detection_ops,
    elementwise,
    loss_ops,
    math_ops,
    metric_ops,
    nce_op,
    nn_ops,
    optimizer_ops,
    pipeline_op,
    random_ops,
    reduce_ops,
    sequence_ops,
    tensor_ops,
    vision_ops,
)
