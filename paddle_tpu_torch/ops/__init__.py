"""Ops of the PyTorch port.

- The static-graph lowerings (``math_ops``, ``tensor_ops``, ``nn_ops``,
  ``activations``, ``creation``, ``embedding_ops``, ``optimizer_ops``,
  ``fused``, ``flash_attention``, ``grad_generic``): importing this package registers them
  with ``framework.lowering``, as importing ``paddle_tpu.ops`` does.
- The kernels' wrappers and plain versions: paged attention
  (``paged_attention``, B5/B6), flash attention with a streamed bias
  (``flash_attention_bias``, B1) and the flash-attention training op
  (``flash_attention``, B2 forward and B3/B4 backward).
- The decode-time token samplers (``sampling_ops``) and the quantization
  constants (``quant_ops``).

Importing this package builds no kernel: the CUDA libraries are compiled
at first launch (``native/build.py``).
"""
from . import (  # noqa: F401
    activations,
    creation,
    embedding_ops,
    flash_attention,
    fused,
    grad_generic,
    math_ops,
    nn_ops,
    optimizer_ops,
    tensor_ops,
)
