"""Optimizer update ops: ``sgd``, ``momentum``, ``adam`` and ``adamw``.

Counterpart of ``paddle_tpu/ops/optimizer_ops.py`` (``_sgd``,
``_momentum``, ``_adam``); the other updates (``adagrad``, ``adamax``,
``rmsprop``, ``lamb``, ...) come with a later slice.  Reference parity:
sgd_op.cc, momentum_op.cc (``use_nesterov``, ``regularization_method ==
"l2_decay"``), adam_op.cc.  ``sgd`` and
``momentum`` update in the parameter's type; Adam and AdamW run in float32
whatever the parameter's type.  Each writes its outputs back under their
own names (the executor stores them into the scope).  The JAX package
wraps AdamW's gradient in an ``optimization_barrier`` that keeps XLA from
fusing the weight-gradient matmul into the update on the TPU; eager torch
fuses nothing, so the barrier has no counterpart here.
"""
from __future__ import annotations

import torch

from ..framework.lowering import register_lower
from .common import as_scalar


@register_lower("sgd")
def _sgd(ctx, op):
    p = ctx.in1(op, "Param")
    g = ctx.in1(op, "Grad").to(p.dtype)
    lr = as_scalar(ctx.in1(op, "LearningRate")).to(p.dtype)
    ctx.set_out(op, "ParamOut", p - lr * g)


@register_lower("momentum")
def _momentum(ctx, op):
    p = ctx.in1(op, "Param")
    g = ctx.in1(op, "Grad").to(p.dtype)
    v = ctx.in1(op, "Velocity")
    lr = as_scalar(ctx.in1(op, "LearningRate")).to(p.dtype)
    mu = float(op.attr("mu", 0.9))
    rd = float(op.attr("regularization_coeff", 0.0))
    if op.attr("regularization_method", "") == "l2_decay" and rd:
        g = g + rd * p
    v_new = mu * v + g
    if bool(op.attr("use_nesterov", False)):
        p_new = p - lr * (g + mu * v_new)
    else:
        p_new = p - lr * v_new
    ctx.set_out(op, "ParamOut", p_new)
    ctx.set_out(op, "VelocityOut", v_new)


@register_lower("adam", "adamw")
def _adam(ctx, op):
    p = ctx.in1(op, "Param")
    g = ctx.in1(op, "Grad").float()
    m1 = ctx.in1(op, "Moment1")
    m2 = ctx.in1(op, "Moment2")
    b1p = ctx.in1(op, "Beta1Pow")
    b2p = ctx.in1(op, "Beta2Pow")
    lr = as_scalar(ctx.in1(op, "LearningRate")).float()
    b1 = float(op.attr("beta1", 0.9))
    b2 = float(op.attr("beta2", 0.999))
    eps = float(op.attr("epsilon", 1e-8))

    pf = p.float()
    if op.type == "adamw" and bool(op.attr("with_decay", True)):
        coeff = float(op.attr("coeff", op.attr("weight_decay", 0.01)))
        pf = pf * (1.0 - lr * coeff)
    m1n = b1 * m1 + (1 - b1) * g
    m2n = b2 * m2 + (1 - b2) * g.square()
    # reference adam_op: bias correction uses the *input* pows (beta^t at
    # step t, accumulators initialized to beta), pows advance afterwards
    lr_t = lr * torch.sqrt(1 - as_scalar(b2p)) / (1 - as_scalar(b1p))
    pn = pf - lr_t * m1n / (torch.sqrt(m2n) + eps)
    ctx.set_out(op, "ParamOut", pn.to(p.dtype))
    ctx.set_out(op, "Moment1Out", m1n)
    ctx.set_out(op, "Moment2Out", m2n)
    ctx.set_out(op, "Beta1PowOut", b1p * b1)
    ctx.set_out(op, "Beta2PowOut", b2p * b2)
