"""Model-compression toolkit (reference python/paddle/fluid/contrib/slim/).

Counterpart of ``paddle_tpu/slim``: of it the port has the weight-only
post-training quantization (``quantization.PostTrainingWeightQuantPass``,
``mark_weight_quant``); quantization-aware training and activation PTQ
(``QuantizationTransformPass``, ``PostTrainingQuantization``,
``quant_aware``) come with a later slice of the port.
"""
from .quantization import (  # noqa: F401
    PostTrainingWeightQuantPass,
    mark_weight_quant,
)
