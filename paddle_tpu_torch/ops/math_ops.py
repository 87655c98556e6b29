"""Math ops: ``mul``, ``matmul``, the elementwise family, ``scale``,
``sum``, reductions.

Counterpart of ``paddle_tpu/ops/math_ops.py``, limited to the op types
the static BERT program emits, fused or unfused, and ``scale`` (the
``uint8_input`` head of the ResNet program); the rest come with later
slices.  Reference parity: operators/mul_op.cc, matmul_op.cc,
elementwise/*, scale_op.cc, sum_op.cc, reduce_ops/*, mean_op.cc.  ``mul``
and ``matmul`` are one ``torch.matmul`` each: large matrix products
outside any kernel of the port.  ``matmul_grad`` takes the generic gradient.
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


def _matmul_common(x, y, trans_x, trans_y, alpha=1.0):
    if trans_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if trans_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(*promote(x, y))
    if alpha != 1.0:
        out = out * alpha
    return out


@register_lower("matmul")
def _matmul(ctx, op):
    out = _matmul_common(
        ctx.in1(op, "X"), ctx.in1(op, "Y"),
        bool(op.attr("transpose_X", False)),
        bool(op.attr("transpose_Y", False)),
        float(op.attr("alpha", 1.0)))
    ctx.set_out(op, "Out", out)


@register_lower("matmul_v2")
def _matmul_v2(ctx, op):
    out = _matmul_common(
        ctx.in1(op, "X"), ctx.in1(op, "Y"),
        bool(op.attr("trans_x", False)), bool(op.attr("trans_y", False)))
    ctx.set_out(op, "Out", out)


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


@register_lower("scale")
def _scale(ctx, op):
    """``x * scale + bias`` (or ``(x + bias) * scale``), computed in the
    type jax's promotion gives (a ``ScaleTensor`` is float32) and
    returned in ``x.dtype``."""
    x = ctx.in1(op, "X")
    s_in = ctx.in_list(op, "ScaleTensor")
    scale = s_in[0].reshape(()) if s_in else float(op.attr("scale", 1.0))
    bias = torch.full((), float(op.attr("bias", 0.0)), dtype=x.dtype,
                      device=x.device)
    xs = promote(x, scale)[0] if s_in else x
    if bool(op.attr("bias_after_scale", True)):
        out = xs * scale + bias
    else:
        out = (xs + bias) * scale
    ctx.set_out(op, "Out", out.to(x.dtype))


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
