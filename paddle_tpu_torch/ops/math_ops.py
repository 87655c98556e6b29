"""Math ops: ``mul``, the elementwise family, ``sum``, reductions.

Counterpart of ``paddle_tpu/ops/math_ops.py``, limited to the op types
the static BERT program emits (the rest come with later slices).
Reference parity: operators/mul_op.cc, elementwise/*, sum_op.cc,
reduce_ops/*, mean_op.cc.  ``mul`` is one ``torch.matmul``: a large
matrix product outside any kernel of the port.
"""
from __future__ import annotations

import torch

from ..framework.lowering import register_lower
from .common import bcast_shapes_elementwise, promote


@register_lower("mul")
def _mul(ctx, op):
    """Flattening matmul: X flattened at x_num_col_dims, Y at y_num_col_dims."""
    x = ctx.in1(op, "X")
    y = ctx.in1(op, "Y")
    xn = int(op.attr("x_num_col_dims", 1))
    yn = int(op.attr("y_num_col_dims", 1))
    xs, ys = x.shape, y.shape
    x2 = x.reshape(-1, _prod(xs[xn:]))
    y2 = y.reshape(_prod(ys[:yn]), -1)
    x2, y2 = promote(x2, y2)
    out = x2 @ y2
    ctx.set_out(op, "Out", out.reshape(tuple(xs[:xn]) + tuple(ys[yn:])))


def _prod(t):
    p = 1
    for v in t:
        p *= int(v)
    return p


_BINARY = {
    "elementwise_add": torch.add,
    "elementwise_mul": torch.mul,
    "elementwise_div": torch.div,
    "elementwise_max": torch.maximum,
}


def _make_binary(fn):
    def lower(ctx, op):
        x = ctx.in1(op, "X")
        y = ctx.in1(op, "Y")
        axis = int(op.attr("axis", -1))
        x, y = bcast_shapes_elementwise(x, y, axis)
        ctx.set_out(op, "Out", fn(*promote(x, y)))

    return lower


for _name, _fn in _BINARY.items():
    register_lower(_name)(_make_binary(_fn))


@register_lower("sum")
def _sum(ctx, op):
    xs = ctx.in_list(op, "X")
    out = xs[0]
    for x in xs[1:]:
        out = torch.add(*promote(out, x))
    ctx.set_out(op, "Out", out)


def _reduce_axes(op, x):
    axes = op.attr("dim", None)
    if op.attr("reduce_all", False) or axes is None or axes == []:
        return tuple(range(x.dim()))
    axes = axes if isinstance(axes, (list, tuple)) else [axes]
    return tuple(int(a) % x.dim() for a in axes)


@register_lower("reduce_sum")
def _reduce_sum(ctx, op):
    x = ctx.in1(op, "X")
    keep = bool(op.attr("keep_dim", False))
    axes = _reduce_axes(op, x)
    out = torch.sum(x, dim=axes, keepdim=keep) if axes else x
    if x.dtype != torch.bool and not x.is_floating_point():
        out = out.to(x.dtype)  # jnp.sum keeps integer types, torch widens
    ctx.set_out(op, "Out", out)


@register_lower("mean")
def _mean(ctx, op):
    # reference mean_op reduces to a single-element tensor of shape [1]
    ctx.set_out(op, "Out", torch.mean(ctx.in1(op, "X")).reshape(1))


@register_lower("mean_grad")
def _mean_grad(ctx, op):
    x = ctx.in1(op, "X")
    dy = ctx.in1(op, "Out@GRAD")
    ctx.set_out(op, "X@GRAD", (dy.reshape(()) / x.numel())
                .expand(x.shape).to(x.dtype))
