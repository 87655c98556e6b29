"""Creation and random ops: ``fill_constant``, ``assign``,
``gaussian_random``, ``uniform_random``, ``dropout`` (+ grad).

Counterpart of ``paddle_tpu/ops/creation.py``, limited to the op types
the static BERT and ResNet programs and their startup programs emit
(``uniform_random`` initializes ResNet's fc weight), and ``assign``,
which the redundant-cast pass leaves where a cast was (the rest come
with later slices).  Random ops draw from the executor's
``torch.Generator`` (``ops/common.op_generator``); the JAX package draws
from threefry, so the two agree in distribution, not in bits.

Dropout keeps the reference's default ``downgrade_in_infer``: training
zeroes dropped elements without rescaling the kept ones, inference
scales by ``1 - p``.  Its ``Mask`` output (uint8) feeds ``dropout_grad``.
"""
from __future__ import annotations

import torch

from ..framework.lowering import register_lower
from .common import attr_dtype, op_generator


@register_lower("fill_constant")
def _fill_constant(ctx, op):
    if op.inputs.get("ShapeTensor") or op.inputs.get("ShapeTensorList"):
        raise NotImplementedError(
            "fill_constant with a shape tensor input comes with a later "
            "slice of the port; pass the shape attr")
    value = op.attr("value", 0.0)
    if op.attr("str_value", ""):
        value = float(op.attr("str_value"))
    shape = [int(s) for s in op.attr("shape", [])]
    ctx.set_out(op, "Out", torch.full(shape, value, dtype=attr_dtype(op),
                                      device=ctx.device))


@register_lower("assign")
def _assign(ctx, op):
    ctx.set_out(op, "Out", ctx.in1(op, "X"))


@register_lower("gaussian_random")
def _gaussian_random(ctx, op):
    shape = [int(s) for s in op.attr("shape", [])]
    mean = float(op.attr("mean", 0.0))
    std = float(op.attr("std", 1.0))
    z = torch.randn(shape, generator=op_generator(ctx, op),
                    dtype=torch.float32, device=ctx.device)
    ctx.set_out(op, "Out", (mean + std * z).to(attr_dtype(op)))


@register_lower("uniform_random")
def _uniform_random(ctx, op):
    shape = [int(s) for s in op.attr("shape", [])]
    lo = float(op.attr("min", -1.0))
    hi = float(op.attr("max", 1.0))
    u = torch.rand(shape, generator=op_generator(ctx, op),
                   dtype=torch.float32, device=ctx.device)
    ctx.set_out(op, "Out", (lo + (hi - lo) * u).to(attr_dtype(op)))


@register_lower("dropout")
def _dropout(ctx, op):
    x = ctx.in1(op, "X")
    p = float(op.attr("dropout_prob", 0.5))
    impl = op.attr("dropout_implementation", "downgrade_in_infer")
    if bool(op.attr("is_test", False)):
        out = x if impl == "upscale_in_train" else x * (1.0 - p)
        ctx.set_out(op, "Out", out)
        ctx.set_out(op, "Mask", torch.ones_like(x, dtype=torch.uint8))
        return
    u = torch.rand(x.shape, generator=op_generator(ctx, op),
                   dtype=torch.float32, device=x.device)
    keep = u < 1.0 - p   # bernoulli(1 - p), as jax.random.bernoulli draws it
    if impl == "upscale_in_train":
        scale = 0.0 if p >= 1.0 else 1.0 / (1.0 - p)
        out = torch.where(keep, x * scale, torch.zeros_like(x))
    else:
        out = torch.where(keep, x, torch.zeros_like(x))
    ctx.set_out(op, "Out", out)
    ctx.set_out(op, "Mask", keep.to(torch.uint8))


@register_lower("dropout_grad")
def _dropout_grad(ctx, op):
    dy = ctx.in1(op, "Out@GRAD")
    keep = ctx.in1(op, "Mask").to(dy.dtype)
    p = float(op.attr("dropout_prob", 0.5))
    if op.attr("dropout_implementation",
               "downgrade_in_infer") == "upscale_in_train":
        scale = 0.0 if p >= 1.0 else 1.0 / (1.0 - p)
        dx = dy * keep * scale
    else:
        dx = dy * keep
    ctx.set_out(op, "X@GRAD", dx)
