"""reference python/paddle/v2/attr.py: parameter/extra attribute aliases
over the fluid ParamAttr machinery."""
from ..fluid.param_attr import ParamAttr, WeightNormParamAttr  # noqa: F401

Param = ParamAttr
ParameterAttribute = ParamAttr


class ExtraAttr:
    """reference ExtraLayerAttribute — accepted for source compatibility;
    drop_rate maps to dropout at the layer level, the rest (device
    placement, error clipping thresholds) are superseded by mesh
    placement and fluid.clip."""

    def __init__(self, error_clipping_threshold=None, drop_rate=None,
                 device=None, **kwargs):
        self.error_clipping_threshold = error_clipping_threshold
        self.drop_rate = drop_rate
        self.device = device


ExtraLayerAttribute = ExtraAttr
