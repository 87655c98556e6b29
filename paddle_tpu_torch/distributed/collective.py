"""paddle.distributed collective functions.

Counterpart of ``paddle_tpu/distributed/collective.py`` (reference
python/paddle/distributed/collective.py:89-444): broadcast, all_reduce,
reduce, all_gather, scatter and barrier emit their ``c_*`` op through
``dispatch.op_call``.  On graph Variables they append it to the program;
on eager tensors they run it at once through the tracer, and the result
is written back into the input tensor, as the reference's functions
mutate their input.  The lowerings (``ops/collective.py``) call
``torch.distributed`` on the live process group, and are the one-rank
identities without one.  ``barrier`` is a process-level rendezvous on
the group.
"""
from __future__ import annotations

from ..dispatch import op_call
from .parallel_env import group_live


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3


_RED_SUFFIX = {ReduceOp.SUM: "sum", ReduceOp.MAX: "max",
               ReduceOp.MIN: "min", ReduceOp.PROD: "prod"}


def all_reduce(tensor, op=ReduceOp.SUM, group=0, use_calc_stream=True):
    out = op_call(f"c_allreduce_{_RED_SUFFIX[op]}", {"X": tensor},
                  {"ring_id": int(group), "use_calc_stream": use_calc_stream})
    _write_back(tensor, out)
    return out


def reduce(tensor, dst, op=ReduceOp.SUM, group=0, use_calc_stream=True):
    out = op_call(f"c_reduce_{_RED_SUFFIX[op]}", {"X": tensor},
                  {"ring_id": int(group), "root_id": int(dst),
                   "use_calc_stream": use_calc_stream})
    _write_back(tensor, out)
    return out


def broadcast(tensor, src, group=0, use_calc_stream=True):
    out = op_call("c_broadcast", {"X": tensor},
                  {"ring_id": int(group), "root": int(src),
                   "use_calc_stream": use_calc_stream})
    _write_back(tensor, out)
    return out


def all_gather(tensor_list, tensor, group=0, use_calc_stream=True):
    out = op_call("c_allgather", {"X": tensor},
                  {"ring_id": int(group), "use_calc_stream": use_calc_stream})
    if isinstance(tensor_list, list):
        n = get_world_size()
        if n > 1:
            from ..tensor.manipulation import split

            tensor_list.extend(split(out, n, axis=0))
        else:
            tensor_list.append(out)
    return out


def scatter(tensor, tensor_list=None, src=0, group=0, use_calc_stream=True):
    src_val = tensor
    if tensor_list:
        from ..tensor.manipulation import concat

        src_val = concat(list(tensor_list), axis=0)
    out = op_call("c_scatter", {"X": src_val},
                  {"ring_id": int(group), "root": int(src),
                   "use_calc_stream": use_calc_stream})
    _write_back(tensor, out)
    return out


def barrier(group=0):
    """A process-level rendezvous on the live group (nothing to wait for
    without one)."""
    if group_live():
        import torch.distributed as dist

        dist.barrier()


def get_rank():
    from .parallel_env import get_rank as _r

    return _r()


def get_world_size():
    from .parallel_env import get_world_size as _w

    return max(_w(), 1)


def _write_back(tensor, out):
    """Reference collective functions mutate their input tensor in
    place."""
    if tensor is not out and hasattr(tensor, "_set_raw") \
            and hasattr(out, "_value"):
        tensor._set_raw(out._value)
