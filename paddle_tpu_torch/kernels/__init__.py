"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. Importing this package needs neither nvcc nor a card: a kernel
builds at its first launch on a CUDA tensor."""
from . import (  # noqa: F401
    conv_bn_relu,
    flash_attention,
    layer_norm,
    paged_attention,
)
from .conv_bn_relu import fold_bn, fused_conv_bn_relu_reference  # noqa: F401
from .flash_attention import (  # noqa: F401
    flash_attention_bwd_reference,
    flash_attention_fwd_reference,
)
from .layer_norm import layer_norm_reference  # noqa: F401
from .paged_attention import (  # noqa: F401
    paged_attention_reference,
)
