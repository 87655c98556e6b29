"""Tensor creation API (reference python/paddle/tensor/creation.py).

Counterpart of ``paddle_tpu/tensor/creation.py``; ``to_tensor`` makes its
tensor on the place (``dygraph/base.py``)."""
from __future__ import annotations

import numpy as np

from ..dispatch import op_call
from ..framework import dtypes


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    from ..dygraph.base import guard, to_variable

    if place is not None:
        with guard(place):
            t = to_variable(data, dtype=dtype)
    else:
        t = to_variable(data, dtype=dtype)
    t.stop_gradient = stop_gradient
    return t


def _shape_list(shape):
    if isinstance(shape, (int, np.integer)):
        return [int(shape)]
    return [int(s) for s in shape]


def full(shape, fill_value, dtype="float32", name=None):
    return op_call("fill_constant", {},
                   {"shape": _shape_list(shape), "dtype": dtypes.to_enum(dtype),
                    "value": float(fill_value)}, dtype=dtype, name=name)


def zeros(shape, dtype="float32", name=None):
    return full(shape, 0.0, dtype, name)


def ones(shape, dtype="float32", name=None):
    return full(shape, 1.0, dtype, name)


def full_like(x, fill_value, dtype=None, name=None):
    attrs = {"value": float(fill_value)}
    if dtype is not None:
        attrs["dtype"] = dtypes.to_enum(dtype)
    return op_call("fill_any_like", {"X": x}, attrs, dtype=dtype, name=name)


def zeros_like(x, dtype=None, name=None):
    return full_like(x, 0.0, dtype, name)


def ones_like(x, dtype=None, name=None):
    return full_like(x, 1.0, dtype, name)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = ("int64" if all(isinstance(v, (int, np.integer)) for v in (start, end, step))
                 else "float32")
    nd = dtypes.to_np(dtype)
    sv = to_tensor(np.asarray(start, dtype=nd))
    ev = to_tensor(np.asarray(end, dtype=nd))
    pv = to_tensor(np.asarray(step, dtype=nd))
    return op_call("range", {"Start": sv, "End": ev, "Step": pv}, {},
                   dtype=dtype, name=name)


def linspace(start, stop, num, dtype="float32", name=None):
    sv = to_tensor(np.asarray(start, dtype="float32")) if not hasattr(start, "shape") else start
    ev = to_tensor(np.asarray(stop, dtype="float32")) if not hasattr(stop, "shape") else stop
    nv = to_tensor(np.asarray(num, dtype="int32")) if not hasattr(num, "shape") else num
    return op_call("linspace", {"Start": sv, "Stop": ev, "Num": nv},
                   {"dtype": dtypes.to_enum(dtype)}, dtype=dtype, name=name)


def eye(num_rows, num_columns=None, dtype="float32", name=None):
    return op_call("eye", {},
                   {"num_rows": int(num_rows),
                    "num_columns": int(num_columns) if num_columns is not None else -1,
                    "dtype": dtypes.to_enum(dtype)}, dtype=dtype, name=name)


def empty(shape, dtype="float32", name=None):
    return zeros(shape, dtype, name)  # deterministic stand-in


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype, name)


def assign(x, output=None):
    from ..framework.program import Variable
    from ..layer_helper import LayerHelper

    if isinstance(x, (np.ndarray, list, tuple, int, float)):
        arr = np.asarray(x)
        if arr.dtype == np.float64:
            arr = arr.astype(np.float32)
        if isinstance(output, Variable):
            # static in-place form with constant data: materialize via
            # assign_value straight into the output var
            from ..framework import dtypes

            key = {"float32": "fp32_values", "int32": "int32_values",
                   "int64": "int64_values", "bool": "bool_values"}.get(
                       str(arr.dtype), "fp32_values")
            LayerHelper("assign").append_op(
                "assign_value", {}, {"Out": [output.name]},
                {"shape": list(arr.shape), "dtype": dtypes.to_enum(str(arr.dtype)),
                 key: arr.ravel().tolist()})
            return output
        x = to_tensor(arr)
    if output is None:
        return op_call("assign", {"X": x}, {})
    if isinstance(output, Variable):
        LayerHelper("assign").append_op("assign", {"X": [x.name]},
                                        {"Out": [output.name]}, {})
        return output
    output._set_raw(op_call("assign", {"X": x}, {})._value)
    return output


def diag(x, offset=0, padding_value=0, name=None):
    from ..dygraph.eager import apply_torch
    import torch

    def fn(v):
        out = torch.diag(v, diagonal=offset)
        if v.dim() == 1 and padding_value != 0:
            n = out.shape[0]
            mask = torch.ones(n, n, dtype=torch.bool,
                              device=v.device).triu(offset).tril(offset)
            out = torch.where(mask, out, torch.full(
                (), padding_value, dtype=out.dtype, device=out.device))
        return out

    return apply_torch(fn, x)


def tril(x, diagonal=0, name=None):
    return op_call("tril_triu", {"X": x}, {"diagonal": int(diagonal), "lower": True})


def triu(x, diagonal=0, name=None):
    return op_call("tril_triu", {"X": x}, {"diagonal": int(diagonal), "lower": False})


def meshgrid(*args, **kwargs):
    args = list(args[0]) if len(args) == 1 and isinstance(args[0], (list, tuple)) else list(args)
    return op_call("meshgrid", {"X": args}, {}, outs=("Out",),
                   out_counts={"Out": len(args)})
