"""Search / sort API (reference python/paddle/tensor/search.py).

Counterpart of ``paddle_tpu/tensor/search.py``."""
from __future__ import annotations

from ..dispatch import op_call


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return op_call("arg_max", {"X": x},
                   {"axis": -1 if axis is None else int(axis),
                    "keepdims": bool(keepdim), "flatten": axis is None},
                   dtype="int64", name=name)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return op_call("arg_min", {"X": x},
                   {"axis": -1 if axis is None else int(axis),
                    "keepdims": bool(keepdim), "flatten": axis is None},
                   dtype="int64", name=name)


def argsort(x, axis=-1, descending=False, name=None):
    _, idx = op_call("argsort", {"X": x},
                     {"axis": int(axis), "descending": bool(descending)},
                     outs=("Out", "Indices"), name=name)
    return idx


def sort(x, axis=-1, descending=False, name=None):
    out, _ = op_call("argsort", {"X": x},
                     {"axis": int(axis), "descending": bool(descending)},
                     outs=("Out", "Indices"), name=name)
    return out


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    return op_call("top_k_v2", {"X": x},
                   {"k": int(k), "axis": -1 if axis is None else int(axis),
                    "largest": bool(largest), "sorted": bool(sorted)},
                   outs=("Out", "Indices"), name=name)


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=False)
    return op_call("where", {"Condition": condition, "X": x, "Y": y}, {}, name=name)


def nonzero(x, as_tuple=False):
    out = op_call("where_index", {"Condition": x}, {}, dtype="int64")
    if as_tuple:
        from .manipulation import unstack

        nd = len(x.shape)
        return tuple(unstack(out, axis=1, num=nd))
    return out


def index_sample(x, index):
    from .manipulation import take_along_axis

    return take_along_axis(x, index, axis=1)


def masked_select(x, mask, name=None):
    from ..dygraph.eager import apply_torch

    # dynamic output shape: eager-only, as in the JAX package
    return apply_torch(lambda v, m: v[m.to(bool)], x, mask)
