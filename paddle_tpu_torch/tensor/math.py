"""Tensor math API (reference python/paddle/tensor/math.py).

Counterpart of ``paddle_tpu/tensor/math.py``.  Each function is
dual-mode via dispatch.op_call: eager on torch tensors or appended to
the static IR, same op either way.
"""
from __future__ import annotations

from ..dispatch import op_call
from ..framework import dtypes


def _ew(op_type, x, y, name=None, axis=-1):
    return op_call(op_type, {"X": x, "Y": y}, {"axis": axis}, name=name)


def add(x, y, name=None):
    return _ew("elementwise_add", x, y, name)


def subtract(x, y, name=None):
    return _ew("elementwise_sub", x, y, name)


def multiply(x, y, name=None):
    return _ew("elementwise_mul", x, y, name)


def divide(x, y, name=None):
    return _ew("elementwise_div", x, y, name)


def floor_divide(x, y, name=None):
    return _ew("elementwise_floordiv", x, y, name)


def remainder(x, y, name=None):
    return _ew("elementwise_mod", x, y, name)


mod = floor_mod = remainder


def pow(x, y, name=None):
    if isinstance(y, (int, float)):
        return op_call("pow", {"X": x}, {"factor": float(y)}, name=name)
    return _ew("elementwise_pow", x, y, name)


def maximum(x, y, name=None):
    return _ew("elementwise_max", x, y, name)


def minimum(x, y, name=None):
    return _ew("elementwise_min", x, y, name)


def _unary(op_type):
    def fn(x, name=None):
        return op_call(op_type, {"X": x}, {}, name=name)

    fn.__name__ = op_type
    return fn


exp = _unary("exp")
expm1 = _unary("expm1")
log = _unary("log")
log2 = _unary("log2")
log10 = _unary("log10")
log1p = _unary("log1p")
sqrt = _unary("sqrt")
rsqrt = _unary("rsqrt")
abs = _unary("abs")
ceil = _unary("ceil")
floor = _unary("floor")
round = _unary("round")
reciprocal = _unary("reciprocal")
sign = _unary("sign")
sin = _unary("sin")
sinh = _unary("sinh")
asin = _unary("asin")
asinh = _unary("asinh")
cos = _unary("cos")
cosh = _unary("cosh")
acos = _unary("acos")
acosh = _unary("acosh")
tan = _unary("tan")
atan = _unary("atan")
atanh = _unary("atanh")
tanh = _unary("tanh")
erf = _unary("erf")
square = _unary("square")


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    out = op_call("scale", {"X": x},
                  {"scale": float(scale), "bias": float(bias),
                   "bias_after_scale": bool(bias_after_scale)}, name=name)
    if act:
        out = op_call(act, {"X": out}, {})
    return out


def neg(x, name=None):
    return scale(x, -1.0)


def increment(x, value=1.0, name=None):
    return op_call("increment", {"X": x}, {"step": float(value)}, name=name)


def _reduce(op_type):
    def fn(x, axis=None, keepdim=False, name=None):
        if axis is None:
            dim, reduce_all = [], True
        else:
            dim = [axis] if isinstance(axis, int) else list(axis)
            reduce_all = False
        return op_call(op_type, {"X": x},
                       {"dim": dim, "keep_dim": bool(keepdim), "reduce_all": reduce_all},
                       name=name)

    fn.__name__ = op_type
    return fn


sum = _reduce("reduce_sum")
mean = _reduce("reduce_mean")
max = _reduce("reduce_max")
min = _reduce("reduce_min")
prod = _reduce("reduce_prod")


def all(x, axis=None, keepdim=False, name=None):
    return _reduce("reduce_all")(x, axis, keepdim, name)


def any(x, axis=None, keepdim=False, name=None):
    return _reduce("reduce_any")(x, axis, keepdim, name)


def cumsum(x, axis=None, dtype=None, name=None):
    attrs = {"axis": -1 if axis is None else int(axis), "flatten": axis is None}
    out = op_call("cumsum", {"X": x}, attrs, name=name)
    if dtype is not None:
        out = cast(out, dtype)
    return out


def clip(x, min=None, max=None, name=None):
    lo = float(min) if min is not None else -3.4e38
    hi = float(max) if max is not None else 3.4e38
    return op_call("clip", {"X": x}, {"min": lo, "max": hi}, name=name)


def cast(x, dtype):
    return op_call("cast", {"X": x},
                   {"out_dtype": dtypes.to_enum(dtype), "in_dtype": 0},
                   dtype=dtype)


def isnan(x, name=None):
    return op_call("isnan_v2", {"X": x}, {}, dtype="bool")


def isinf(x, name=None):
    return op_call("isinf_v2", {"X": x}, {}, dtype="bool")


def isfinite(x, name=None):
    return op_call("isfinite_v2", {"X": x}, {}, dtype="bool")


def add_n(inputs, name=None):
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    return op_call("sum", {"X": list(inputs)}, {}, name=name)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return op_call("stanh", {"X": x}, {"scale_a": scale_a, "scale_b": scale_b})


def kron(x, y, name=None):
    from ..dygraph.eager import apply_torch
    import torch

    return apply_torch(torch.kron, x, y)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    from ..dygraph.eager import apply_torch
    import torch

    return apply_torch(lambda v: torch.diagonal(
        v, offset=offset, dim1=axis1, dim2=axis2).sum(-1), x)


def logsumexp(x, axis=None, keepdim=False, name=None):
    from ..dygraph.eager import apply_torch
    import torch

    def fn(v):
        ax = tuple(range(v.dim())) if axis is None else (
            tuple(axis) if isinstance(axis, (list, tuple)) else axis)
        return torch.logsumexp(v, dim=ax, keepdim=keepdim)

    return apply_torch(fn, x)
