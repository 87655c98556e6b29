"""Math ops: the matmul family, the elementwise family, ``scale``,
``sum``, reductions, comparisons and logical ops, unary math, ``pow``,
``clip``, the finiteness tests and ``increment``.

Counterpart of ``paddle_tpu/ops/math_ops.py`` (``increment`` is in the
JAX package's ``misc.py``).  Reference parity: operators/mul_op.cc,
matmul_op.cc, elementwise/*, scale_op.cc, sum_op.cc, reduce_ops/*,
mean_op.cc, compare_op.cc, logical_op.cc, activation_op.cc (the unary
math), pow_op.cc, clip_op.cc, isfinite_op.cc, maximum / minimum
(elementwise, numpy broadcasting).  ``mul`` and ``matmul``
are one ``torch.matmul`` each: large matrix products outside any kernel
of the port.  Gradients: the explicit ``mean_grad``, else the generic
gradient (static programs) or autograd (dygraph).

Types follow jax's promotion (``common.promote``) where torch's differs:
integer reductions keep their type (``reduce_sum``/``reduce_prod``; a
mean of integers is float32), integer unary math (``exp``, ``sqrt``, ...)
is float32.
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
    "elementwise_sub": torch.sub,
    "elementwise_mul": torch.mul,
    "elementwise_div": torch.div,
    "elementwise_max": torch.maximum,
    "elementwise_min": torch.minimum,
    "elementwise_pow": torch.pow,
    "elementwise_mod": torch.remainder,
    # piecewise constant: no gradient (jax's is zero), none recorded
    "elementwise_floordiv": lambda x, y: torch.floor_divide(x.detach(),
                                                            y.detach()),
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


def _make_reduce(fn):
    def lower(ctx, op):
        x = ctx.in1(op, "X")
        axes = _reduce_axes(op, x)
        keep = bool(op.attr("keep_dim", False))
        ctx.set_out(op, "Out", fn(x, axes, keep) if axes else x)

    return lower


def _prod_dims(x, axes, keep):
    out = x
    for a in sorted(axes, reverse=True):
        out = out.prod(dim=a, keepdim=keep)
    return out.to(x.dtype) if x.dtype != torch.bool else out.int()


def _mean_dims(x, axes, keep):
    if not (x.is_floating_point() or x.is_complex()):
        x = x.float()
    return torch.mean(x, dim=axes, keepdim=keep)


for _name, _fn in {
    "reduce_mean": _mean_dims,
    "reduce_max": lambda x, a, k: torch.amax(x, dim=a, keepdim=k),
    "reduce_min": lambda x, a, k: torch.amin(x, dim=a, keepdim=k),
    "reduce_prod": _prod_dims,
    "reduce_all": lambda x, a, k: torch.all(x.bool(), dim=a, keepdim=k),
    "reduce_any": lambda x, a, k: torch.any(x.bool(), dim=a, keepdim=k),
}.items():
    register_lower(_name)(_make_reduce(_fn))


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


@register_lower("increment")
def _increment(ctx, op):
    x = ctx.in1(op, "X")
    ctx.set_out(op, "Out", x + torch.full((), float(op.attr("step", 1.0)),
                                          dtype=x.dtype, device=x.device))


@register_lower("dot")
def _dot(ctx, op):
    x, y = promote(ctx.in1(op, "X"), ctx.in1(op, "Y"))
    ctx.set_out(op, "Out", torch.sum(x * y, dim=-1, keepdim=x.dim() > 1))


@register_lower("bmm")
def _bmm(ctx, op):
    ctx.set_out(op, "Out", torch.matmul(*promote(ctx.in1(op, "X"),
                                                 ctx.in1(op, "Y"))))


# ---------------------------------------------------------------------------
# comparison / logical
# ---------------------------------------------------------------------------


def _make_compare(fn):
    def lower(ctx, op):
        x, y = bcast_shapes_elementwise(ctx.in1(op, "X"), ctx.in1(op, "Y"),
                                        int(op.attr("axis", -1)))
        ctx.set_out(op, "Out", fn(*promote(x, y)))

    return lower


for _name, _fn in {
    "equal": torch.eq,
    "not_equal": torch.ne,
    "less_than": torch.lt,
    "less_equal": torch.le,
    "greater_than": torch.gt,
    "greater_equal": torch.ge,
}.items():
    register_lower(_name)(_make_compare(_fn))


def _make_logical(fn):
    def lower(ctx, op):
        ctx.set_out(op, "Out", fn(ctx.in1(op, "X"), ctx.in1(op, "Y")))

    return lower


for _name, _fn in {
    "logical_and": torch.logical_and,
    "logical_or": torch.logical_or,
    "logical_xor": torch.logical_xor,
}.items():
    register_lower(_name)(_make_logical(_fn))


@register_lower("logical_not")
def _logical_not(ctx, op):
    ctx.set_out(op, "Out", torch.logical_not(ctx.in1(op, "X")))


# ---------------------------------------------------------------------------
# unary math (non-activation)
# ---------------------------------------------------------------------------


def _float(x):
    return x if x.is_floating_point() or x.is_complex() else x.float()


_UNARY = {
    "exp": lambda x: torch.exp(_float(x)),
    "log": lambda x: torch.log(_float(x)),
    "log2": lambda x: torch.log2(_float(x)),
    "log10": lambda x: torch.log10(_float(x)),
    "log1p": lambda x: torch.log1p(_float(x)),
    "sqrt": lambda x: torch.sqrt(_float(x)),
    "rsqrt": lambda x: torch.rsqrt(_float(x)),
    "abs": torch.abs,
    "ceil": torch.ceil,
    "floor": torch.floor,
    "round": torch.round,
    "cos": lambda x: torch.cos(_float(x)),
    "sin": lambda x: torch.sin(_float(x)),
    "tan": lambda x: torch.tan(_float(x)),
    "acos": lambda x: torch.acos(_float(x)),
    "asin": lambda x: torch.asin(_float(x)),
    "atan": lambda x: torch.atan(_float(x)),
    "cosh": lambda x: torch.cosh(_float(x)),
    "sinh": lambda x: torch.sinh(_float(x)),
    "reciprocal": lambda x: torch.reciprocal(_float(x)),
    "square": torch.square,
    "sign": torch.sign,
    "erf": lambda x: torch.erf(_float(x)),
}


def _make_unary(fn):
    def lower(ctx, op):
        ctx.set_out(op, "Out", fn(ctx.in1(op, "X")))

    return lower


for _name, _fn in _UNARY.items():
    register_lower(_name)(_make_unary(_fn))


@register_lower("pow")
def _pow(ctx, op):
    x = ctx.in1(op, "X")
    f_in = ctx.in_list(op, "FactorTensor")
    factor = f_in[0].reshape(()) if f_in else op.attr("factor", 1.0)
    ctx.set_out(op, "Out", torch.pow(x, factor))


@register_lower("clip")
def _clip(ctx, op):
    ctx.set_out(op, "Out", torch.clamp(ctx.in1(op, "X"), op.attr("min", None),
                                       op.attr("max", None)))


@register_lower("isfinite", "isfinite_v2")
def _isfinite(ctx, op):
    out = torch.isfinite(ctx.in1(op, "X"))
    ctx.set_out(op, "Out", out.all() if op.type == "isfinite" else out)


@register_lower("isnan_v2")
def _isnan(ctx, op):
    ctx.set_out(op, "Out", torch.isnan(ctx.in1(op, "X")))


@register_lower("isinf_v2")
def _isinf(ctx, op):
    ctx.set_out(op, "Out", torch.isinf(ctx.in1(op, "X")))


# at a tie both sides take half the gradient, as under jax.vjp
@register_lower("maximum")
def _maximum(ctx, op):
    ctx.set_out(op, "Out", torch.maximum(*promote(ctx.in1(op, "X"),
                                                  ctx.in1(op, "Y"))))


@register_lower("minimum")
def _minimum(ctx, op):
    ctx.set_out(op, "Out", torch.minimum(*promote(ctx.in1(op, "X"),
                                                  ctx.in1(op, "Y"))))
