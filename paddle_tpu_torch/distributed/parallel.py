"""Dygraph ``DataParallel`` and ``spawn``.

Counterpart of ``paddle_tpu/distributed/parallel.py`` (reference
python/paddle/fluid/dygraph/parallel.py: ``DataParallel``:335,
``scale_loss``:432, ``apply_collective_grads``:441; distributed/spawn.py:231).
Above one rank (a live process group, ``init_parallel_env``),
``scale_loss`` divides the loss by the number of ranks and
``apply_collective_grads`` all-reduces every parameter's gradient over
the group, in flat buckets of up to ``comm_buffer_size`` MB a dtype (the
reference's coalesced allreduce; the JAX package all-gathers each
gradient and sums, the same sums); at world size 1 the loss is returned
as it is and there is nothing to sum.  The wrapper delegates
``parameters``, ``named_parameters``, ``state_dict`` and
``set_state_dict`` to the wrapped layer, so the keys are the wrapped
layer's own, as in the JAX package.  ``spawn`` with ``nprocs > 1``
raises the later-slice error (ROADMAP Queue A item 8).
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
        self._bucket_bytes = int(comm_buffer_size) * 1024 * 1024
        if self._nranks > 1 and get_world_size() != self._nranks:
            raise RuntimeError(
                f"DataParallel over {self._nranks} processes needs the "
                f"process group: call distributed.init_parallel_env() "
                f"first")

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def scale_loss(self, loss):
        if self._nranks <= 1:
            return loss
        from ..tensor.math import scale

        return scale(loss, 1.0 / self._nranks)

    def apply_collective_grads(self):
        """Sum every parameter's gradient over the ranks, in place."""
        if self._nranks <= 1:
            return None
        import torch
        import torch.distributed as dist

        from ..ops.collective import _all_reduce

        def reduce(grads):
            summed = _all_reduce(dist, torch.cat([g.reshape(-1)
                                                  for g in grads]), "sum")
            off = 0
            with torch.no_grad():
                for g in grads:
                    g.copy_(summed[off:off + g.numel()].view_as(g))
                    off += g.numel()

        buckets, sizes = {}, {}
        for p in self._layers.parameters():
            g = p._value.grad
            if g is None:
                continue
            key = (g.dtype, g.device)
            n = g.numel() * g.element_size()
            if sizes.get(key, 0) and sizes[key] + n > self._bucket_bytes:
                reduce(buckets.pop(key))
                sizes[key] = 0
            buckets.setdefault(key, []).append(g)
            sizes[key] = sizes.get(key, 0) + n
        for grads in buckets.values():
            reduce(grads)
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
