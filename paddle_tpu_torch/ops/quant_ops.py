"""Quantization constants the port's KV cache needs.

Of ``paddle_tpu/ops/quant_ops.py`` only ``SCALE_EPS`` is on the serving
path (``serving/kv_cache.py`` clamps every int8 scale to it and resets
freed pages' scale planes to it).  The weight-only ``dequant_matmul``
kernel waits for the quantized-inference slice.
"""
SCALE_EPS = 1e-8
