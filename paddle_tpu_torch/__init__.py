"""paddle_tpu_torch — the PyTorch / CUDA port of paddle_tpu.

A package beside ``paddle_tpu`` (the JAX reference, which it never
imports), ported slice by slice.  The first slice is the decode server:
``paddle_tpu_torch.serving.DecodeServer`` -> ``DecodeEngine`` ->
``TransformerLM`` over the paged KV cache, whose attention runs in the
hand-written Hopper kernels of ``ops/paged_attention.py``
(``csrc/paged_attention.cu``).  Entry points run on the CUDA card
unless the caller passes ``device="cpu"``; importing the package builds
no kernel.  ``ROADMAP.md`` lists what is still to be ported.
"""
__version__ = "0.1.0"
