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
   (``ops/nn_ops.py``); no hand-written kernel runs on this path;
6. the executor's compiled step: CUDA-graph capture
   (``framework/graphs.py``);
7. dygraph and the 2.0 API: ``set_device``, ``to_tensor`` and the
   ``tensor`` functions, ``nn`` layers and ``nn.functional``,
   ``optimizer.Momentum(...).step()``, ``amp.auto_cast``, ``autograd``
   (``PyLayer``, ``grad``) and ``vision.models`` (LeNet, ResNet), run
   eagerly by the same lowerings, ``torch.autograd`` as the tape
   (``dygraph/``); no hand-written kernel runs on dygraph ResNet-50;
8. the 2.0 high-level API: ``Model(network).prepare(optimizer, loss,
   metrics)`` then ``fit`` / ``evaluate`` / ``predict`` over
   ``io.DataLoader`` (spawned worker processes with no card, device
   prefetch), in dygraph and, under ``enable_static()``, through the
   executor's captured programs; ``metric``, ``hapi.callbacks``,
   ``flops``/``summary`` over programs, ``vision.datasets`` /
   ``transforms`` and MobileNet / VGG; no hand-written kernel runs on
   this path either;
9. the rest of ``nn`` (``LSTM`` / ``GRU`` / ``SimpleRNN`` over the
   ``rnn`` op on torch's fused recurrent ops, ``MultiHeadAttention`` and
   the ``Transformer`` stacks, the ``conv2d_transpose`` / ``group_norm``
   / ``instance_norm`` lowerings) and ``text`` (``datasets``, greedy and
   beam-search ``decode``): text models train through ``Model.fit`` in
   dygraph; no hand-written kernel runs on these paths;
10. the rest of the executor, with checkpoints: the pipelined window
   (``run`` returns a lazy ``StepHandle``, ``FLAGS_max_inflight_steps``
   steps in flight), ``use_prune``, the NaN scan, ``FLAGS_benchmark``,
   ``ckpt`` (the asynchronous, atomic ``CheckpointManager``,
   ``snapshot_scope`` / ``restore_scope``, ``ResumableIterator``),
   ``save`` / ``load``, ``incubate.checkpoint.auto_checkpoint``,
   ``distributed.checkpoint`` at one process and ``ModelCheckpoint``'s
   default route; fused BERT-base trains through it with B1 on its path;
11. ``distributed`` at one process: ``fleet.init``,
   ``DistributedStrategy`` and ``fleet.distributed_optimizer(opt)
   .minimize(loss)`` over the single-process meta-optimizer chain (amp,
   recompute, gradient merge, LARS, LAMB, DGC), the collective functions
   and ``DataParallel`` at world size 1; an ERNIE-1.0-width finetune
   trains through amp + recompute with B1 on its path;
12. ``jit`` and ``static``: ``jit.to_static`` / ``TracedLayer`` trace a
   dygraph ``Layer`` into a program (run by the executor, captured on
   the card when it has no control flow), ``jit.save`` / ``jit.load``
   export it through ``fluid.io.save_inference_model`` and serve it
   through ``inference.Predictor`` (int8 through the dequant kernel
   under ``FLAGS_weight_quant``); ``dy2static`` turns Python
   ``if``/``while``/``for`` over tensors into ``cond_pair`` / ``while``
   ops, which the executor runs eagerly (``ops/control_flow.py``).

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``, ``CPUPlace()``); importing the package builds no
kernel.  ``ROADMAP.md`` lists what is still to be ported.
"""
from . import framework, ops  # noqa: F401
from . import initializer, layers, optimizer, regularizer  # noqa: F401
from . import dygraph  # noqa: F401
from .dygraph import grad, no_grad, to_variable  # noqa: F401
from .dygraph.base import (  # noqa: F401
    disable_static,
    enable_static,
    get_device,
    in_dygraph_mode,
    seed,
    set_device,
)
from .dygraph.tensor import Tensor  # noqa: F401

# 2.0 flat namespace (reference python/paddle/__init__.py)
from . import tensor  # noqa: F401
from . import nn  # noqa: F401
from . import io  # noqa: F401
from . import metric  # noqa: F401
from . import text, vision  # noqa: F401
from . import hapi  # noqa: F401
from .hapi import Model  # noqa: F401
from .hapi.model import InputSpec  # noqa: F401
from .hapi import callbacks  # noqa: F401
from .hapi.model_stat import flops, summary  # noqa: F401
from .tensor import (  # noqa: F401
    abs, add, add_n, all, allclose, any, arange, argmax, argmin, argsort,
    assign, bmm, broadcast_to, cast, ceil, chunk, clip, concat, cos, cumsum,
    diag, divide, dot, equal, equal_all, exp, expand, expand_as, eye, flatten,
    flip, floor, floor_divide, full, full_like, gather, gather_nd,
    greater_equal, greater_than, increment, index_select, isfinite, isinf,
    isnan, less_equal, less_than, linspace, log, log1p, log2, log10,
    logical_and, logical_not, logical_or, logical_xor, logsumexp, masked_select,
    matmul, max, maximum, mean, meshgrid, min, minimum, mm, mod, multinomial,
    multiply, nonzero, norm, normal, not_equal, numel, ones, ones_like, pow,
    prod, rand, randint, randn, randperm, reciprocal, remainder, reshape,
    roll, round, rsqrt, scale, scatter, scatter_nd_add, sign, sin, slice,
    sort, split, sqrt, square, squeeze, stack, std, subtract, sum, t,
    tanh, tile, to_tensor, topk, trace, transpose, tril, triu, uniform,
    unsqueeze, unstack, var, where, zeros, zeros_like,
)
from .tensor.math import kron, neg, stanh  # noqa: F401
from .tensor.search import index_sample  # noqa: F401
from . import fluid, inference, slim  # noqa: F401
from . import amp, autograd  # noqa: F401
from .framework.executor import Executor, StepHandle  # noqa: F401
from .framework.backward import append_backward, calc_gradient  # noqa: F401
from .framework.scope import global_scope  # noqa: F401
from .framework.flags import get_flags, set_flags  # noqa: F401
from .framework.place import CPUPlace, CUDAPlace, TPUPlace  # noqa: F401
from .framework.program import (  # noqa: F401
    Program,
    default_main_program,
    default_startup_program,
    program_guard,
)
from .param_attr import ParamAttr  # noqa: F401
from . import ckpt, incubate  # noqa: F401
from .serialization import load, save  # noqa: F401
from . import distributed, serving  # noqa: F401
from . import jit, static  # noqa: F401
from . import distribution, utils, version  # noqa: F401

__version__ = version.full_version
