"""``paddle.static`` namespace (reference python/paddle/static/__init__.py)
over the port's IR and ``Executor``.

Counterpart of ``paddle_tpu/static/__init__.py``.  ``BuildStrategy``,
``ExecutionStrategy`` and ``CompiledProgram`` record their settings for
API compatibility: the executor's graph passes and its captured steps do
what their fusion and memory knobs asked for, so a ``CompiledProgram``
runs as its program does.  ``CompiledProgram.with_data_parallel`` over
more than one place needs several devices, which the port does not run
yet (ROADMAP Queue A item 8).  ``cuda_places`` names real cards;
``tpu_places`` keeps the JAX package's name and maps to them, as
``inference.Config.enable_tpu`` does.  ``py_func`` embeds a host Python
callable (``ops/misc.py``); a program holding one runs eagerly.
"""
from __future__ import annotations

import contextlib

import torch

from ..fluid import scope_guard  # noqa: F401
from ..framework import (  # noqa: F401
    Executor,
    Program,
    Scope,
    default_main_program,
    default_startup_program,
    global_scope,
    program_guard,
)
from ..framework.program import Variable  # noqa: F401
from ..framework.backward import append_backward, calc_gradient  # noqa: F401
from ..framework import unique_name  # noqa: F401
from ..fluid.io import (  # noqa: F401
    load_inference_model,
    save_inference_model,
)
from ..hapi.model import InputSpec  # noqa: F401
from ..layers import data  # noqa: F401
from ..param_attr import WeightNormParamAttr  # noqa: F401
from ..serialization import load, save  # noqa: F401

# static nn layer surface (reference paddle.static.nn)
from .. import layers as nn  # noqa: F401


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """Reference paddle.static.gradients -> fluid calc_gradient."""
    return calc_gradient(targets, inputs, target_gradients, no_grad_set)


@contextlib.contextmanager
def name_scope(prefix=None):
    """Reference fluid.name_scope: prefixes generated var names.  The
    names stay unique: the current generator numbers the prefixed keys
    (the JAX package hands ``unique_name.guard`` the prefix string as a
    generator, and its first name raises ``TypeError``)."""
    if not prefix:
        yield
        return
    outer = unique_name._generator
    with unique_name.guard(lambda key: outer(f"{prefix}/{key}")):
        yield


def cpu_places(device_count=None):
    from ..framework.place import CPUPlace

    n = device_count or 1
    return [CPUPlace() for _ in range(n)]


def cuda_places(device_ids=None):
    """One ``CUDAPlace`` per card: ``device_ids``, or every card torch
    sees."""
    from ..framework.place import CUDAPlace

    ids = device_ids if device_ids is not None \
        else range(torch.cuda.device_count())
    return [CUDAPlace(i) for i in ids]


def tpu_places(device_ids=None):
    """The JAX package's name for the accelerator's places: the cards."""
    return cuda_places(device_ids if device_ids is not None else [0])


class BuildStrategy:
    """Config shim (reference details/build_strategy.h): pass toggles are
    recorded; the executor's passes and captured steps own fusion and
    memory."""

    def __init__(self):
        self.reduce_strategy = 0
        self.gradient_scale_strategy = 0
        self.debug_graphviz_path = ""
        self.enable_inplace = True
        self.fuse_all_reduce_ops = True
        self.fuse_elewise_add_act_ops = True
        self.memory_optimize = True
        self.sync_batch_norm = False
        self.enable_auto_fusion = True


class ExecutionStrategy:
    """Config shim (reference execution_strategy.h)."""

    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 1
        self.num_iteration_per_run = 1
        self.use_thread_barrier = False


class CompiledProgram:
    """Reference fluid.compiler.CompiledProgram: wraps a Program with
    build/exec strategies.  The Executor accepts it anywhere a Program
    goes."""

    def __init__(self, program, build_strategy=None):
        self._program = program
        self._build_strategy = build_strategy or BuildStrategy()
        self._places = None

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None):
        if places is not None and len(places) > 1:
            from ..distributed.parallel_env import later

            raise later(f"CompiledProgram.with_data_parallel over "
                        f"{len(places)} places")
        self._build_strategy = build_strategy or self._build_strategy
        self._places = places
        return self

    # duck-type as a Program for Executor.run
    def __getattr__(self, name):
        return getattr(self._program, name)


def py_func(func, x, out, backward_func=None, skip_vars_in_backward_input=None):
    """Reference paddle.static.py_func: embed a host Python callable (see
    the ``py_func`` lowering in ``ops/misc.py``)."""
    from ..layer_helper import LayerHelper
    from ..ops import misc

    fid = id(func)
    misc.register_py_func(fid, func)
    helper = LayerHelper("py_func")
    xs = x if isinstance(x, (list, tuple)) else [x]
    outs = out if isinstance(out, (list, tuple)) else [out]
    helper.append_op("py_func", {"X": list(xs)}, {"Out": list(outs)},
                     {"forward_callable_id": fid})
    return out


class Print:
    """Reference paddle.static.Print, as the JAX package has it: returns
    its input and builds nothing."""

    def __new__(cls, input, *a, **k):
        return input


__all__ = [
    "append_backward", "gradients", "Executor", "global_scope",
    "scope_guard", "BuildStrategy", "CompiledProgram", "ExecutionStrategy",
    "ParallelExecutor", "program_guard", "WeightNormParamAttr",
    "default_main_program", "default_startup_program", "Program", "data",
    "InputSpec", "save", "load", "save_inference_model",
    "load_inference_model", "cpu_places", "cuda_places", "tpu_places",
    "Variable", "name_scope", "py_func", "nn", "Print",
]

ParallelExecutor = CompiledProgram
