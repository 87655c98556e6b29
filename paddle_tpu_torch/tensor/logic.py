"""Comparison / logical API (reference python/paddle/tensor/logic.py).

Counterpart of ``paddle_tpu/tensor/logic.py``."""
from __future__ import annotations

import numpy as np

from ..dispatch import op_call


def _cmp(op_type):
    def fn(x, y, name=None):
        return op_call(op_type, {"X": x, "Y": y}, {"axis": -1}, dtype="bool", name=name)

    fn.__name__ = op_type
    return fn


equal = _cmp("equal")
not_equal = _cmp("not_equal")
less_than = _cmp("less_than")
less_equal = _cmp("less_equal")
greater_than = _cmp("greater_than")
greater_equal = _cmp("greater_equal")


def _logical(op_type):
    def fn(x, y=None, out=None, name=None):
        if y is None:
            return op_call(op_type, {"X": x}, {}, dtype="bool", name=name)
        return op_call(op_type, {"X": x, "Y": y}, {}, dtype="bool", name=name)

    fn.__name__ = op_type
    return fn


logical_and = _logical("logical_and")
logical_or = _logical("logical_or")
logical_xor = _logical("logical_xor")


def logical_not(x, out=None, name=None):
    return op_call("logical_not", {"X": x}, {}, dtype="bool", name=name)


def equal_all(x, y, name=None):
    from . import math as _math

    return _math.all(equal(x, y))


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    from ..dygraph.eager import apply_torch
    import torch

    return apply_torch(lambda a, b: torch.tensor(
        torch.allclose(*torch.broadcast_tensors(a, b.to(a.dtype)),
                       rtol=rtol, atol=atol, equal_nan=equal_nan),
        device=a.device), x, y)


def is_empty(x, name=None):
    return bool(int(np.prod(x.shape)) == 0)
