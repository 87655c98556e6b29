"""Dygraph (eager) mode of the PyTorch port.

Counterpart of ``paddle_tpu/dygraph``: eager execution of the same
lowering rules the static executor runs (``framework/lowering.py``), on
torch tensors, with ``torch.autograd`` as the tape.  ``jit`` and
``dy2static`` come with a later slice of the port.
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
from .eager import apply_torch, run_op  # noqa: F401
from .layers import Layer, state_dict_from_numpy  # noqa: F401
from .tensor import Parameter, Tensor  # noqa: F401
