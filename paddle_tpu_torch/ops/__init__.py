"""Ops of the PyTorch port.

- The lowerings (``math_ops``, ``tensor_ops``, ``linalg_ops``,
  ``nn_ops``, ``rnn_ops``, ``activations``, ``creation``, ``embedding_ops``,
  ``control_flow``, ``loss_ops``, ``interp_ops``,
  ``optimizer_ops``, ``misc``, ``fused``, ``flash_attention``,
  ``grad_generic``, ``quant_ops``, ``moe_ops``, ``collective``, and the
  vision and detection ops: ``vision_ops``, ``detection_ops``,
  ``nms_ops``, ``deformable_ops``, ``sampling_ops``'s ``correlation``,
  and the sequence ops and the rest of the op library:
  ``sequence_ops``, ``tail_ops``, ``misc_ops``, ``sampling_ops``'s
  ``nce`` and ``sample_logits``, and ``layer_scan``, the region ops of
  scan-over-layers),
  which the static executor and dygraph's ``run_op``
  both run: importing this package registers them with
  ``framework.lowering``, as importing ``paddle_tpu.ops`` does.
- The kernels' wrappers and plain versions: paged attention
  (``paged_attention``, B5/B6), flash attention with a streamed bias
  (``flash_attention_bias``, B1), the flash-attention training op
  (``flash_attention``, B2 forward and B3/B4 backward) and the
  weight-only dequant-fused matmul (``quant_ops``, B7).
- The decode-time token samplers (``sampling_ops``, beside
  ``correlation``).

Importing this package builds no kernel: the CUDA libraries are compiled
at first launch (``native/build.py``).
"""
from . import (  # noqa: F401
    activations,
    collective,
    control_flow,
    creation,
    deformable_ops,
    detection_ops,
    embedding_ops,
    flash_attention,
    fused,
    grad_generic,
    interp_ops,
    layer_scan,
    linalg_ops,
    loss_ops,
    math_ops,
    misc,
    misc_ops,
    moe_ops,
    nms_ops,
    nn_ops,
    optimizer_ops,
    quant_ops,
    rnn_ops,
    sampling_ops,
    sequence_ops,
    tail_ops,
    tensor_ops,
    vision_ops,
)
