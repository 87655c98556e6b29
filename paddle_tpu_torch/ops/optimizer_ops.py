"""Optimizer update op: ``adamw``.

Counterpart of ``paddle_tpu/ops/optimizer_ops.py`` (``_adam``), limited
to the update the static BERT program emits (``adam`` and the other
updates come with later slices).  The update runs in
float32 whatever the parameter's type, and writes the parameter, both
moments and both beta powers back under their own names (the executor
stores them into the scope).  The JAX package wraps the gradient in an
``optimization_barrier`` that keeps XLA from fusing the weight-gradient
matmul into the update on the TPU; eager torch fuses nothing, so the
barrier has no counterpart here.
"""
from __future__ import annotations

import torch

from ..framework.lowering import register_lower
from .common import as_scalar


@register_lower("adamw")
def _adamw(ctx, op):
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
    if bool(op.attr("with_decay", True)):
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
