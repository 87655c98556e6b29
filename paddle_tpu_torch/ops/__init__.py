"""Ops of the PyTorch port.

- The lowerings (``math_ops``, ``tensor_ops``, ``linalg_ops``,
  ``nn_ops``, ``activations``, ``creation``, ``embedding_ops``,
  ``optimizer_ops``, ``misc``, ``fused``, ``flash_attention``,
  ``grad_generic``, ``quant_ops``), which the static executor and dygraph's ``run_op``
  both run: importing this package registers them with
  ``framework.lowering``, as importing ``paddle_tpu.ops`` does.
- The kernels' wrappers and plain versions: paged attention
  (``paged_attention``, B5/B6), flash attention with a streamed bias
  (``flash_attention_bias``, B1), the flash-attention training op
  (``flash_attention``, B2 forward and B3/B4 backward) and the
  weight-only dequant-fused matmul (``quant_ops``, B7).
- The decode-time token samplers (``sampling_ops``).

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
    linalg_ops,
    math_ops,
    misc,
    nn_ops,
    optimizer_ops,
    quant_ops,
    tensor_ops,
)
