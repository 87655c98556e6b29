"""Linear algebra API (reference python/paddle/tensor/linalg.py).

Counterpart of ``paddle_tpu/tensor/linalg.py``."""
from __future__ import annotations

from ..dispatch import op_call


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    return op_call("matmul_v2", {"X": x, "Y": y},
                   {"trans_x": bool(transpose_x), "trans_y": bool(transpose_y)},
                   name=name)


def mm(input, mat2, name=None):
    return matmul(input, mat2, name=name)


def bmm(x, y, name=None):
    return op_call("bmm", {"X": x, "Y": y}, {}, name=name)


def dot(x, y, name=None):
    return op_call("dot", {"X": x, "Y": y}, {}, name=name)


def norm(x, p="fro", axis=None, keepdim=False, name=None):
    if p == "fro" and axis is None:
        return op_call("frobenius_norm", {"X": x},
                       {"dim": [], "keep_dim": keepdim, "reduce_all": True}, name=name)
    if axis is None:
        axis = -1
    if isinstance(axis, (list, tuple)) and p == "fro":
        return op_call("frobenius_norm", {"X": x},
                       {"dim": list(axis), "keep_dim": keepdim, "reduce_all": False},
                       name=name)
    porder = {"inf": float("inf"), "-inf": float("-inf")}.get(p, p)
    return op_call("p_norm", {"X": x},
                   {"porder": float(porder), "axis": int(axis), "keepdim": keepdim,
                    "epsilon": 1e-12}, name=name)


def dist(x, y, p=2, name=None):
    from . import math as _math

    return norm(_math.subtract(x, y), p=float(p))


def transpose(x, perm, name=None):
    from .manipulation import transpose as _t

    return _t(x, perm, name)


def cross(x, y, axis=None, name=None):
    from ..dygraph.eager import apply_torch
    import torch

    ax = -1 if axis is None else axis
    return apply_torch(lambda a, b: torch.linalg.cross(a, b, dim=ax), x, y)


def cholesky(x, upper=False, name=None):
    from ..dygraph.eager import apply_torch
    import torch

    def fn(v):
        c = torch.linalg.cholesky(v)
        return c.transpose(-1, -2) if upper else c

    return apply_torch(fn, x)


def matmul_broadcast(x, y, name=None):
    return matmul(x, y, name=name)
