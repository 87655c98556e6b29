"""Tensor manipulation ops: ``reshape2``, ``slice``, ``gather``, ``cast``.

Counterpart of ``paddle_tpu/ops/tensor_ops.py``, limited to the op types
the static BERT program emits (the rest come with later slices).
Reference parity: operators/reshape_op.cc, slice_op.cc, gather_op.cc,
cast_op.cc.
"""
from __future__ import annotations

import torch

from ..framework.lowering import register_lower
from .common import attr_dtype


def _resolve_reshape(x, shape):
    out = [int(s) for s in shape]
    for i, s in enumerate(out):
        if s == 0:  # 0 copies the input's dim
            out[i] = x.shape[i]
    return out


@register_lower("reshape2")
def _reshape(ctx, op):
    x = ctx.in1(op, "X")
    if op.inputs.get("ShapeTensor") or op.inputs.get("Shape"):
        raise NotImplementedError(
            "reshape2 with a shape tensor input comes with a later slice "
            "of the port; pass the shape attr")
    ctx.set_out(op, "Out", x.reshape(_resolve_reshape(x, op.attr("shape", []))))
    if op.outputs.get("XShape"):
        # the reference's XShape carries the input shape behind a 0 dim
        ctx.set_out(op, "XShape", x.new_zeros((0,) + tuple(x.shape)))


@register_lower("slice")
def _slice(ctx, op):
    x = ctx.in1(op, "Input")
    axes = [int(a) for a in op.attr("axes", [])]
    starts = [int(s) for s in op.attr("starts", [])]
    ends = [int(e) for e in op.attr("ends", [])]
    decrease = [int(d) for d in op.attr("decrease_axis", []) or []]
    idx = [slice(None)] * x.dim()
    for a, s, e in zip(axes, starts, ends):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    out = x[tuple(idx)]
    squeeze = tuple(d for d in decrease if out.shape[d] == 1)
    if squeeze:
        out = out.squeeze(squeeze)
    ctx.set_out(op, "Out", out)


@register_lower("gather")
def _gather(ctx, op):
    x = ctx.in1(op, "X")
    index = ctx.in1(op, "Index")
    axis = int(op.attr("axis", 0))
    if index.dim() == 2 and index.shape[1] == 1:
        index = index.squeeze(-1)
    axis %= x.dim()
    out = torch.index_select(x, axis, index.reshape(-1))
    ctx.set_out(op, "Out", out.reshape(
        tuple(x.shape[:axis]) + tuple(index.shape) + tuple(x.shape[axis + 1:])))


@register_lower("cast")
def _cast(ctx, op):
    ctx.set_out(op, "Out", ctx.in1(op, "X").to(attr_dtype(op, "out_dtype")))
