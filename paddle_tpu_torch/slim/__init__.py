"""Model-compression toolkit (reference
python/paddle/fluid/contrib/slim/): quantization-aware training,
post-training activation quantization and weight-only post-training
quantization over static Programs.

Counterpart of ``paddle_tpu/slim``, with the same exports.
"""
from .quantization import (  # noqa: F401
    PostTrainingQuantization,
    PostTrainingWeightQuantPass,
    QuantizationTransformPass,
    mark_weight_quant,
    quant_aware,
)
