"""Dygraph (eager) mode of the PyTorch port.

Counterpart of ``paddle_tpu/dygraph``: eager execution of the same
lowering rules the static executor runs (``framework/lowering.py``), on
torch tensors, with ``torch.autograd`` as the tape; ``jit`` traces
it into static programs, with ``dy2static`` converting Python control
flow over tensors.
"""
from . import base  # noqa: F401
from .backward import grad, run_backward  # noqa: F401
from .base import (  # noqa: F401
    disable_static,
    enable_grad,
    enable_static,
    enabled,
    get_device,
    guard,
    in_dygraph_mode,
    no_grad,
    seed,
    set_device,
    to_variable,
)
from .eager import Tracer, apply_torch, run_op, tracer  # noqa: F401
from . import dy2static, jit  # noqa: F401
from .jit import TracedLayer, declarative, to_static  # noqa: F401
from .layers import Layer, state_dict_from_numpy  # noqa: F401
from .tensor import Parameter, Tensor  # noqa: F401
