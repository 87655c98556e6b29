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
   kernel of ``ops/flash_attention_bias.py`` (``csrc/flash_attention.cu``);
3. the graph-pass pipeline (``framework/passes.py``) in front of the
   executor, whose attention pass rewrites the unfused attention chain to
   ``flash_attention``, run by the flash training kernels of
   ``ops/flash_attention.py`` (``csrc/flash_attention.cu``,
   ``csrc/flash_attention_bwd.cu``);
4. weight-only int8 / fp8 inference: ``fluid.io.save_inference_model``,
   then ``inference.create_predictor(inference.Config(dir))``, with
   ``FLAGS_weight_quant`` (or ``slim.mark_weight_quant``) arming the
   weight-quant pass, whose ``dequant_matmul`` ops run the dequant-fused
   matmul kernel of ``ops/quant_ops.py`` (``csrc/dequant_matmul.cu``);
5. static-graph ResNet-50 training (``vision.resnet50_train_program``,
   SGD with momentum, bf16 AMP): convolution, pooling and batch norm on
   cuDNN / ATen with explicit convolution and batch-norm gradients
   (``ops/nn_ops.py``); no hand-written kernel runs on this path.

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``, ``CPUPlace()``); importing the package builds no
kernel.  ``ROADMAP.md`` lists what is still to be ported.
"""
from . import framework, ops  # noqa: F401
from . import initializer, layers, optimizer, regularizer  # noqa: F401
from . import fluid, inference, slim  # noqa: F401
from .framework.executor import Executor  # noqa: F401
from .framework.flags import get_flags, set_flags  # noqa: F401
from .framework.place import CPUPlace, CUDAPlace  # noqa: F401
from .param_attr import ParamAttr  # noqa: F401

__version__ = "0.2.0"
