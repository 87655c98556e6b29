"""``fluid``-compatible namespace, so that reference-era user scripts
port directly.

Counterpart of ``paddle_tpu/fluid/__init__.py`` (role parity:
python/paddle/fluid/__init__.py of the reference), holding the names
of it that the port has: the builders, the executor and its places, the
scope (with ``scope_guard``), and ``io`` (checkpointing and inference
export).
"""
import contextlib

from .. import initializer, layers, optimizer, profiler, regularizer  # noqa: F401
from ..framework import (  # noqa: F401
    CPUPlace,
    CUDAPlace,
    Executor,
    Program,
    Scope,
    default_main_program,
    default_startup_program,
    global_scope,
    program_guard,
)
from ..framework import unique_name  # noqa: F401
from ..framework.backward import append_backward, calc_gradient  # noqa: F401
from ..framework.program import Variable  # noqa: F401
from ..layers import data  # noqa: F401
from ..param_attr import ParamAttr  # noqa: F401

from . import io  # noqa: F401


def scope_guard(scope):
    """Make ``scope`` the global scope inside a ``with`` block."""
    from ..framework.scope import _switch_scope

    @contextlib.contextmanager
    def _guard():
        old = _switch_scope(scope)
        try:
            yield
        finally:
            _switch_scope(old)

    return _guard()
