"""Dygraph ``DataParallel`` and ``spawn``, at one process.

Counterpart of ``paddle_tpu/distributed/parallel.py`` (reference
python/paddle/fluid/dygraph/parallel.py: ``DataParallel``:335,
``scale_loss``:432, ``apply_collective_grads``:441; distributed/spawn.py:231).
At world size 1 ``scale_loss`` returns the loss and
``apply_collective_grads`` has nothing to sum; the wrapper delegates
``parameters``, ``named_parameters``, ``state_dict`` and
``set_state_dict`` to the wrapped layer, so the keys are the wrapped
layer's own, as in the JAX package.  Several processes (``spawn`` with
``nprocs > 1``) raise the later-slice error (ROADMAP Queue A item 8).
"""
from __future__ import annotations

from ..dygraph.layers import Layer
from .parallel_env import ParallelEnv, get_world_size, init_parallel_env, later


def prepare_context(strategy=None):
    init_parallel_env()
    return ParallelEnv()


class DataParallel(Layer):
    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1):
        super().__init__()
        self._layers = layers
        self._nranks = max(get_world_size(), ParallelEnv().world_size)
        if self._nranks > 1:
            raise later(f"DataParallel over {self._nranks} processes")

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        return None

    # delegation so DataParallel looks like the wrapped layer
    def parameters(self, include_sublayers=True):
        return self._layers.parameters(include_sublayers)

    def named_parameters(self, prefix="", include_sublayers=True):
        return self._layers.named_parameters(prefix, include_sublayers)

    def state_dict(self, *a, **kw):
        return self._layers.state_dict(*a, **kw)

    def set_state_dict(self, *a, **kw):
        return self._layers.set_state_dict(*a, **kw)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """Reference distributed/spawn.py: one process per device.  The port
    runs ``func`` in this process with the parallel environment checked;
    ``nprocs > 1`` raises the later-slice error."""
    if nprocs is not None and int(nprocs) > 1:
        raise later(f"spawn(nprocs={nprocs})")
    init_parallel_env()
    return func(*args)
