"""Activation ops (reference operators/activation_op.cc).

Counterpart of ``paddle_tpu/ops/activations.py``: one torch expression
per activation, with the JAX rules' attributes and defaults.  ``gelu``
takes ``approximate`` from the op's attribute: the tanh form when set,
the exact erf form otherwise (``jax.nn.gelu`` and
``torch.nn.functional.gelu`` agree on both).  ``softplus`` is
``log(1 + e^x)`` computed as ``logaddexp(x, 0)``, ``jax.nn.softplus``'s
form (``F.softplus`` switches to x above 20).  Gradients: the generic
gradient (static programs) or autograd (dygraph).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..framework.lowering import register_lower


def _f(op, name, default):
    return float(op.attr(name, default))


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _softshrink(x, lam):
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(x > lam, x - lam, torch.where(x < -lam, x + lam, zero))


_SIMPLE = {
    "relu": lambda x, op: torch.relu(x),
    "relu6": lambda x, op: torch.clamp(x, 0.0, _f(op, "threshold", 6.0)),
    "sigmoid": lambda x, op: torch.sigmoid(x),
    "tanh": lambda x, op: torch.tanh(x),
    "tanh_shrink": lambda x, op: x - torch.tanh(x),
    "softplus": lambda x, op: _softplus(x),
    "softsign": lambda x, op: x / (1 + torch.abs(x)),
    "softshrink": lambda x, op: _softshrink(x, _f(op, "lambda", 0.5)),
    "hard_shrink": lambda x, op: torch.where(
        torch.abs(x) > _f(op, "threshold", 0.5), x, torch.zeros_like(x)),
    "hard_sigmoid": lambda x, op: torch.clamp(
        _f(op, "slope", 0.2) * x + _f(op, "offset", 0.5), 0.0, 1.0),
    "hard_swish": lambda x, op: x * torch.clamp(
        x + _f(op, "offset", 3.0), 0.0, _f(op, "threshold", 6.0))
    / _f(op, "scale", 6.0),
    "swish": lambda x, op: x * torch.sigmoid(_f(op, "beta", 1.0) * x),
    "silu": lambda x, op: F.silu(x),
    "mish": lambda x, op: x * torch.tanh(_softplus(x)),
    "elu": lambda x, op: F.elu(x, alpha=_f(op, "alpha", 1.0)),
    "celu": lambda x, op: F.celu(x, alpha=_f(op, "alpha", 1.0)),
    "selu": lambda x, op: _f(op, "scale", 1.0507009873554805) * torch.where(
        x > 0, x, _f(op, "alpha", 1.6732632423543772) * torch.expm1(x)),
    "leaky_relu": lambda x, op: F.leaky_relu(x, _f(op, "alpha", 0.02)),
    "logsigmoid": lambda x, op: F.logsigmoid(x),
    "thresholded_relu": lambda x, op: torch.where(
        x > _f(op, "threshold", 1.0), x, torch.zeros_like(x)),
    "stanh": lambda x, op: _f(op, "scale_b", 1.7159) * torch.tanh(
        _f(op, "scale_a", 0.67) * x),
    "brelu": lambda x, op: torch.clamp(x, _f(op, "t_min", 0.0),
                                       _f(op, "t_max", 24.0)),
    "expm1": lambda x, op: torch.expm1(x),
    "atanh": lambda x, op: torch.atanh(x),
    "asinh": lambda x, op: torch.asinh(x),
    "acosh": lambda x, op: torch.acosh(x),
}


def _unary(fn):
    def lower(ctx, op):
        ctx.set_out(op, "Out", fn(ctx.in1(op, "X"), op))

    return lower


for _name, _fn in _SIMPLE.items():
    register_lower(_name)(_unary(_fn))


@register_lower("gelu")
def _gelu(ctx, op):
    approx = "tanh" if bool(op.attr("approximate", False)) else "none"
    ctx.set_out(op, "Out", F.gelu(ctx.in1(op, "X"), approximate=approx))


@register_lower("prelu")
def _prelu(ctx, op):
    x = ctx.in1(op, "X")
    alpha = ctx.in1(op, "Alpha")
    if op.attr("mode", "all") == "channel" and alpha.numel() > 1:
        alpha = alpha.reshape([1, -1] + [1] * (x.dim() - 2))
    ctx.set_out(op, "Out", torch.where(x > 0, x, alpha * x))


@register_lower("maxout")
def _maxout(ctx, op):
    x = ctx.in1(op, "X")  # NCHW
    groups = int(op.attr("groups"))
    axis = int(op.attr("axis", 1))
    shape = list(x.shape)
    shape[axis:axis + 1] = [shape[axis] // groups, groups]
    ctx.set_out(op, "Out", torch.amax(x.reshape(shape), dim=axis + 1))
