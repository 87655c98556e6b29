"""paddle_tpu_torch — the PyTorch / CUDA port of paddle_tpu.

A package beside ``paddle_tpu`` (the JAX reference, which it never
imports), ported slice by slice:

1. the decode server: ``serving.DecodeServer`` -> ``DecodeEngine`` ->
   ``TransformerLM`` over the paged KV cache, whose attention runs in the
   hand-written Hopper kernels of ``ops/paged_attention.py``
   (``csrc/paged_attention.cu``);
2. static-graph training: programs built with ``layers`` (the BERT
   builders in ``text``), ``amp.decorate(...).minimize(loss)``, and
   ``Executor`` running them op by op, with fused attention in the flash
   kernel of ``ops/flash_attention_bias.py`` (``csrc/flash_attention.cu``).

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``, ``CPUPlace()``); importing the package builds no
kernel.  ``ROADMAP.md`` lists what is still to be ported.
"""
from . import framework, ops  # noqa: F401
from . import initializer, layers, optimizer, regularizer  # noqa: F401
from .framework.executor import Executor  # noqa: F401
from .framework.flags import get_flags, set_flags  # noqa: F401
from .framework.place import CPUPlace, CUDAPlace  # noqa: F401
from .param_attr import ParamAttr  # noqa: F401

__version__ = "0.2.0"
