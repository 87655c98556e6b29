"""Creation and random ops: ``fill_constant``, ``fill_any_like``,
``assign``, ``assign_value``, ``range``, ``linspace``, ``eye``,
``gaussian_random``, ``truncated_gaussian_random``, ``uniform_random``,
``randint``, ``randperm``, ``dropout`` (+ grad).

Counterpart of ``paddle_tpu/ops/creation.py``.  Random ops draw from the
executor's ``torch.Generator`` (``ops/common.op_generator``), or in
dygraph from the place's; the JAX package draws from threefry, so the
two agree in distribution, not in bits.  ``range`` and ``linspace`` read
their bounds on the host, as the JAX rules read them at trace time.

Dropout keeps the reference's default ``downgrade_in_infer``: training
zeroes dropped elements without rescaling the kept ones, inference
scales by ``1 - p``.  Its ``Mask`` output (uint8) feeds ``dropout_grad``.
"""
from __future__ import annotations

import torch

from ..framework.lowering import register_lower
from ..initializer import truncated_normal
from .common import attr_dtype, op_generator, shard_rand


@register_lower("fill_constant")
def _fill_constant(ctx, op):
    shape = [int(s) for s in op.attr("shape", [])]
    st = op.inputs.get("ShapeTensor") or op.inputs.get("ShapeTensorList")
    if st:
        # read on the host (a program holding one runs eagerly,
        # capture_reason "shape_tensor")
        vals = [ctx.get(n).reshape(-1) for n in st]
        if len(vals) == 1 and vals[0].numel() > 1:
            shape = [int(v) for v in vals[0].tolist()]
        else:
            shape = [int(v.item()) for v in vals]
    value = op.attr("value", 0.0)
    if op.attr("str_value", ""):
        value = float(op.attr("str_value"))
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
    # each data-parallel rank masks its own slice (per_shard in the JAX
    # package)
    u = shard_rand(ctx, op, tuple(x.shape), x.device)
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


@register_lower("fill_any_like", "fill_zeros_like")
def _fill_any_like(ctx, op):
    x = ctx.in1(op, "X")
    dt = op.attr("dtype", -1)
    dtype = x.dtype if dt in (-1, 0, None) else attr_dtype(op)
    ctx.set_out(op, "Out", torch.full(tuple(x.shape), op.attr("value", 0.0),
                                      dtype=dtype, device=x.device))


@register_lower("truncated_gaussian_random")
def _truncated_gaussian_random(ctx, op):
    shape = [int(s) for s in op.attr("shape", [])]
    z = truncated_normal(op_generator(ctx, op), shape)
    out = float(op.attr("mean", 0.0)) + float(op.attr("std", 1.0)) * z
    ctx.set_out(op, "Out", out.to(attr_dtype(op)))


@register_lower("randint")
def _randint(ctx, op):
    shape = [int(s) for s in op.attr("shape", [])]
    gen = op_generator(ctx, op)
    out = torch.randint(int(op.attr("low", 0)), int(op.attr("high", 1)),
                        shape, generator=gen, device=gen.device)
    ctx.set_out(op, "Out", out.to(attr_dtype(op, default="int64")))


@register_lower("randperm")
def _randperm(ctx, op):
    gen = op_generator(ctx, op)
    out = torch.randperm(int(op.attr("n")), generator=gen, device=gen.device)
    ctx.set_out(op, "Out", out.to(attr_dtype(op, default="int64")))


def _host(t):
    return t.reshape(-1)[0].item()


@register_lower("range")
def _range(ctx, op):
    start = ctx.in1(op, "Start")
    vals = [_host(ctx.in1(op, s)) for s in ("Start", "End", "Step")]
    ctx.set_out(op, "Out", torch.arange(*vals, dtype=start.dtype,
                                        device=start.device))


@register_lower("linspace")
def _linspace(ctx, op):
    start = ctx.in1(op, "Start")
    ctx.set_out(op, "Out", torch.linspace(
        _host(start), _host(ctx.in1(op, "Stop")),
        int(_host(ctx.in1(op, "Num"))), dtype=attr_dtype(op),
        device=start.device))


@register_lower("eye")
def _eye(ctx, op):
    n = int(op.attr("num_rows"))
    m = int(op.attr("num_columns", -1))
    ctx.set_out(op, "Out", torch.eye(n, n if m in (-1, 0) else m,
                                     dtype=attr_dtype(op), device=ctx.device))


@register_lower("assign_value")
def _assign_value(ctx, op):
    dtype = attr_dtype(op)
    shape = [int(s) for s in op.attr("shape", [])]
    for key in ("fp32_values", "int32_values", "int64_values", "bool_values"):
        vals = op.attr(key, None)
        if vals:
            ctx.set_out(op, "Out", torch.tensor(
                vals, dtype=dtype, device=ctx.device).reshape(shape))
            return
    ctx.set_out(op, "Out", torch.zeros(shape, dtype=dtype, device=ctx.device))
