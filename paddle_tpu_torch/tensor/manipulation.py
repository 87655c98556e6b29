"""Tensor manipulation API (reference python/paddle/tensor/manipulation.py).

Counterpart of ``paddle_tpu/tensor/manipulation.py``."""
from __future__ import annotations

import numpy as np

from ..dispatch import op_call


def reshape(x, shape, name=None):
    return op_call("reshape2", {"X": x}, {"shape": [int(s) for s in shape]},
                   outs=("Out",), name=name)


def transpose(x, perm, name=None):
    return op_call("transpose2", {"X": x}, {"axis": [int(p) for p in perm]},
                   outs=("Out",), name=name)


def t(x, name=None):
    nd = len(x.shape)
    if nd <= 1:
        return x
    return transpose(x, [1, 0], name)


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    return op_call("flatten_contiguous_range", {"X": x},
                   {"start_axis": int(start_axis), "stop_axis": int(stop_axis)},
                   outs=("Out",), name=name)


def squeeze(x, axis=None, name=None):
    axes = [] if axis is None else ([axis] if isinstance(axis, int) else list(axis))
    return op_call("squeeze2", {"X": x}, {"axes": axes}, outs=("Out",), name=name)


def unsqueeze(x, axis, name=None):
    axes = [axis] if isinstance(axis, int) else list(axis)
    return op_call("unsqueeze2", {"X": x}, {"axes": axes}, outs=("Out",), name=name)


def concat(x, axis=0, name=None):
    return op_call("concat", {"X": list(x)}, {"axis": int(axis)}, name=name)


def stack(x, axis=0, name=None):
    return op_call("stack", {"X": list(x)}, {"axis": int(axis)}, outs=("Y",), name=name)


def unstack(x, axis=0, num=None, name=None):
    n = num if num is not None else x.shape[axis]
    return op_call("unstack", {"X": x}, {"axis": int(axis), "num": int(n)},
                   outs=("Y",), out_counts={"Y": int(n)}, name=name)


def split(x, num_or_sections, axis=0, name=None):
    if isinstance(num_or_sections, int):
        n = num_or_sections
        attrs = {"num": n, "axis": int(axis), "sections": []}
    else:
        sections = [int(s) for s in num_or_sections]
        total = x.shape[int(axis)]
        if any(s == -1 for s in sections):
            known = sum(s for s in sections if s != -1)
            sections = [total - known if s == -1 else s for s in sections]
        n = len(sections)
        attrs = {"num": 0, "axis": int(axis), "sections": sections}
    return list(op_call("split", {"X": x}, attrs, outs=("Out",),
                        out_counts={"Out": n}, name=name))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis, name)


def tile(x, repeat_times, name=None):
    return op_call("tile", {"X": x},
                   {"expand_times": [int(r) for r in repeat_times],
                    "repeat_times": [int(r) for r in repeat_times]}, name=name)


def expand(x, shape, name=None):
    return op_call("expand_v2", {"X": x}, {"shape": [int(s) for s in shape]}, name=name)


def expand_as(x, y, name=None):
    return op_call("expand_as_v2", {"X": x, "target_tensor": y},
                   {"target_shape": [int(s) for s in y.shape]}, name=name)


def broadcast_to(x, shape, name=None):
    return expand(x, shape, name)


def flip(x, axis, name=None):
    axes = [axis] if isinstance(axis, int) else list(axis)
    return op_call("flip", {"X": x}, {"axis": axes}, name=name)


def roll(x, shifts, axis=None, name=None):
    shifts = [shifts] if isinstance(shifts, int) else list(shifts)
    axes = ([] if axis is None else ([axis] if isinstance(axis, int) else list(axis)))
    return op_call("roll", {"X": x}, {"shifts": shifts, "axis": axes}, name=name)


def gather(x, index, axis=0, name=None):
    return op_call("gather", {"X": x, "Index": index}, {"axis": int(axis)}, name=name)


def gather_nd(x, index, name=None):
    return op_call("gather_nd", {"X": x, "Index": index}, {}, name=name)


def index_select(x, index, axis=0, name=None):
    return op_call("index_select", {"X": x, "Index": index}, {"dim": int(axis)}, name=name)


def scatter(x, index, updates, overwrite=True, name=None):
    return op_call("scatter", {"X": x, "Ids": index, "Updates": updates},
                   {"overwrite": bool(overwrite)}, name=name)


def scatter_nd_add(x, index, updates, name=None):
    return op_call("scatter_nd_add", {"X": x, "Index": index, "Updates": updates},
                   {}, name=name)


def slice(x, axes, starts, ends, name=None):
    return op_call("slice", {"Input": x},
                   {"axes": [int(a) for a in axes],
                    "starts": [int(s) for s in starts],
                    "ends": [int(e) for e in ends]}, name=name)


def strided_slice(x, axes, starts, ends, strides, name=None):
    return op_call("strided_slice", {"Input": x},
                   {"axes": [int(a) for a in axes], "starts": [int(s) for s in starts],
                    "ends": [int(e) for e in ends], "strides": [int(s) for s in strides]},
                   name=name)


def take_along_axis(arr, indices, axis, name=None):
    return op_call("take_along_axis", {"Input": arr, "Index": indices},
                   {"Axis": int(axis)}, outs=("Result",), name=name)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    from ..dygraph.eager import apply_torch
    import torch

    size = index_num // nshards

    def fn(v):
        shard = v // size
        return torch.where(shard == shard_id, v % size,
                           torch.full((), ignore_value, dtype=v.dtype,
                                      device=v.device))

    return apply_torch(fn, input)
