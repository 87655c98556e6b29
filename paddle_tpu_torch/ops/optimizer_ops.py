"""Optimizer update ops: ``sgd``, ``momentum``, ``adam``, ``adamw``,
``adamax``, ``adagrad``, ``adadelta``, ``rmsprop``, ``lamb``,
``lars_momentum``, ``ftrl`` and ``dpsgd``; the shadow update of
``ExponentialMovingAverage``, ``ema_update``; and the AMP dynamic loss
scaling's ``check_finite_and_unscale`` and ``update_loss_scaling``.

Counterpart of ``paddle_tpu/ops/optimizer_ops.py``: every op the port's
``optimizer/static_opt.py`` and ``amp`` build, computed on the device with
no host branch, so a captured step keeps them.  ``dpsgd``'s Gaussian noise
is drawn from the program's ``torch.Generator`` (or one seeded by the op's
``seed`` attr), so it matches the JAX package's draw in its statistics,
not bit for bit.  Reference parity: sgd_op.cc, momentum_op.cc
(``use_nesterov``, ``regularization_method == "l2_decay"``), adam_op.cc,
adamax_op.cc, adagrad_op.cc, adadelta_op.cc, rmsprop_op.cc (``centered``),
lamb_op.cc, lars_momentum_op.cc, ftrl_op.h, dpsgd_op.h.  ``sgd``, ``momentum``, ``adamax``, ``adagrad``, ``adadelta``
and ``rmsprop`` update in the parameter's type; Adam, AdamW and LAMB run
in float32 whatever the parameter's type.  Each writes its outputs back under their
own names (the executor stores them into the scope).  The JAX package
wraps AdamW's gradient in an ``optimization_barrier`` that keeps XLA from
fusing the weight-gradient matmul into the update on the TPU; eager torch
fuses nothing, so the barrier has no counterpart here.
"""
from __future__ import annotations

import torch

from ..framework.lowering import register_lower
from .common import as_scalar, op_generator


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


@register_lower("adamax")
def _adamax(ctx, op):
    p = ctx.in1(op, "Param")
    g = ctx.in1(op, "Grad")
    m = ctx.in1(op, "Moment")
    inf_norm = ctx.in1(op, "InfNorm")
    b1p = ctx.in1(op, "Beta1Pow")
    lr = as_scalar(ctx.in1(op, "LearningRate"))
    b1 = float(op.attr("beta1", 0.9))
    b2 = float(op.attr("beta2", 0.999))
    eps = float(op.attr("epsilon", 1e-8))
    mn = b1 * m + (1 - b1) * g
    inf_n = torch.maximum(b2 * inf_norm, g.abs() + eps)
    pn = p - (lr / (1 - as_scalar(b1p))) * (mn / inf_n)
    ctx.set_out(op, "ParamOut", pn)
    ctx.set_out(op, "MomentOut", mn)
    ctx.set_out(op, "InfNormOut", inf_n)


@register_lower("adagrad")
def _adagrad(ctx, op):
    p = ctx.in1(op, "Param")
    g = ctx.in1(op, "Grad")
    mom = ctx.in1(op, "Moment")
    lr = as_scalar(ctx.in1(op, "LearningRate"))
    eps = float(op.attr("epsilon", 1e-6))
    mn = mom + g.square()
    ctx.set_out(op, "ParamOut", p - lr * g / (torch.sqrt(mn) + eps))
    ctx.set_out(op, "MomentOut", mn)


@register_lower("adadelta")
def _adadelta(ctx, op):
    p = ctx.in1(op, "Param")
    g = ctx.in1(op, "Grad")
    avg_sq = ctx.in1(op, "AvgSquaredGrad")
    avg_upd = ctx.in1(op, "AvgSquaredUpdate")
    rho = float(op.attr("rho", 0.95))
    eps = float(op.attr("epsilon", 1e-6))
    asq = rho * avg_sq + (1 - rho) * g.square()
    upd = torch.sqrt(avg_upd + eps) / torch.sqrt(asq + eps) * g
    ctx.set_out(op, "ParamOut", p - upd)
    ctx.set_out(op, "AvgSquaredGradOut", asq)
    ctx.set_out(op, "AvgSquaredUpdateOut",
                rho * avg_upd + (1 - rho) * upd.square())


@register_lower("rmsprop")
def _rmsprop(ctx, op):
    p = ctx.in1(op, "Param")
    g = ctx.in1(op, "Grad")
    ms = ctx.in1(op, "MeanSquare")
    mom = ctx.in1(op, "Moment")
    lr = as_scalar(ctx.in1(op, "LearningRate"))
    eps = float(op.attr("epsilon", 1e-10))
    rho = float(op.attr("decay", 0.9))
    momentum = float(op.attr("momentum", 0.0))
    msn = rho * ms + (1 - rho) * g.square()
    if bool(op.attr("centered", False)):
        mgn = rho * ctx.in1(op, "MeanGrad") + (1 - rho) * g
        denom = msn - mgn.square() + eps
        ctx.set_out(op, "MeanGradOut", mgn)
    else:
        denom = msn + eps
    momn = momentum * mom + lr * g / torch.sqrt(denom)
    ctx.set_out(op, "ParamOut", p - momn)
    ctx.set_out(op, "MeanSquareOut", msn)
    ctx.set_out(op, "MomentOut", momn)


@register_lower("lamb")
def _lamb(ctx, op):
    p = ctx.in1(op, "Param")
    g = ctx.in1(op, "Grad").float()
    m1 = ctx.in1(op, "Moment1")
    m2 = ctx.in1(op, "Moment2")
    b1p = ctx.in1(op, "Beta1Pow")
    b2p = ctx.in1(op, "Beta2Pow")
    lr = as_scalar(ctx.in1(op, "LearningRate")).float()
    b1 = float(op.attr("beta1", 0.9))
    b2 = float(op.attr("beta2", 0.999))
    eps = float(op.attr("epsilon", 1e-6))
    wd = float(op.attr("weight_decay", 0.01))
    pf = p.float()
    m1n = b1 * m1 + (1 - b1) * g
    m2n = b2 * m2 + (1 - b2) * g.square()
    mhat = m1n / (1 - as_scalar(b1p))
    vhat = m2n / (1 - as_scalar(b2p))
    r = mhat / (torch.sqrt(vhat) + eps) + wd * pf
    w_norm = torch.linalg.vector_norm(pf)
    r_norm = torch.linalg.vector_norm(r)
    trust = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                        torch.ones_like(w_norm))
    ctx.set_out(op, "ParamOut", (pf - lr * trust * r).to(p.dtype))
    ctx.set_out(op, "Moment1Out", m1n)
    ctx.set_out(op, "Moment2Out", m2n)
    ctx.set_out(op, "Beta1PowOut", b1p * b1)
    ctx.set_out(op, "Beta2PowOut", b2p * b2)


@register_lower("lars_momentum")
def _lars_momentum(ctx, op):
    """Momentum with a layer-wise rate: ``lr * lars_coeff * ||p|| /
    (||g|| + lars_weight_decay * ||p|| + epsilon)`` when both norms are
    positive, else ``lr``."""
    p = ctx.in1(op, "Param")
    g = ctx.in1(op, "Grad")
    v = ctx.in1(op, "Velocity")
    lr = as_scalar(ctx.in1(op, "LearningRate"))
    mu = float(op.attr("mu", 0.9))
    lars_coeff = float(op.attr("lars_coeff", 0.001))
    lars_wd = float(op.attr("lars_weight_decay", 0.0005))
    eps = float(op.attr("epsilon", 0.0))
    p_norm = torch.linalg.vector_norm(p)
    g_norm = torch.linalg.vector_norm(g)
    local_lr = torch.where(
        (p_norm > 0) & (g_norm > 0),
        lr * lars_coeff * p_norm / (g_norm + lars_wd * p_norm + eps), lr)
    vn = mu * v + local_lr * (g + lars_wd * p)
    ctx.set_out(op, "ParamOut", p - vn)
    ctx.set_out(op, "VelocityOut", vn)


@register_lower("ftrl")
def _ftrl(ctx, op):
    """Follow-the-regularized-leader with L1/L2 terms and a learning-rate
    power (``lr_power`` -0.5: the square-root schedule)."""
    p = ctx.in1(op, "Param")
    g = ctx.in1(op, "Grad")
    sq = ctx.in1(op, "SquaredAccumulator")
    lin = ctx.in1(op, "LinearAccumulator")
    lr = as_scalar(ctx.in1(op, "LearningRate"))
    l1 = float(op.attr("l1", 0.0))
    l2 = float(op.attr("l2", 0.0))
    lr_power = float(op.attr("lr_power", -0.5))
    new_sq = sq + torch.square(g)
    sigma = (torch.pow(new_sq, -lr_power) - torch.pow(sq, -lr_power)) / lr
    new_lin = lin + g - sigma * p
    y = torch.pow(new_sq, -lr_power) / lr + 2 * l2
    shrunk = torch.where(torch.abs(new_lin) > l1,
                         (-new_lin + torch.sign(new_lin) * l1) / y,
                         torch.zeros_like(p))
    ctx.set_out(op, "ParamOut", shrunk)
    ctx.set_out(op, "SquaredAccumOut", new_sq)
    ctx.set_out(op, "LinearAccumOut", new_lin)


@register_lower("dpsgd")
def _dpsgd(ctx, op):
    """Differentially-private SGD: the batch gradient L2-clipped to
    ``clip``, plus Gaussian noise of deviation ``clip * sigma /
    batch_size``, then the SGD step, in float32."""
    p = ctx.in1(op, "Param")
    g = ctx.in1(op, "Grad").float()
    lr = as_scalar(ctx.in1(op, "LearningRate")).float()
    clip = float(op.attr("clip", 10.0))
    batch_size = float(op.attr("batch_size", 16.0))
    sigma = float(op.attr("sigma", 1.0))
    norm = torch.sqrt(torch.sum(g * g))
    g = g * torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)
    noise = torch.randn(g.shape, generator=op_generator(ctx, op),
                        device=g.device, dtype=torch.float32)
    noise = noise * (clip * sigma / batch_size)
    ctx.set_out(op, "ParamOut", (p.float() - lr * (g + noise)).to(p.dtype))


@register_lower("ema_update")
def _ema_update(ctx, op):
    """``ExponentialMovingAverage``'s shadow: ``decay * shadow + (1 -
    decay) * param`` in float32, ``decay`` from the ``Decay`` input (the
    ramp) when there is one, else the attr."""
    p = ctx.in1(op, "Param").float()
    s = ctx.in1(op, "Shadow").float()
    if op.inputs.get("Decay"):
        decay = as_scalar(ctx.in1(op, "Decay")).float()
    else:
        decay = float(op.attr("decay", 0.999))
    ctx.set_out(op, "ShadowOut", decay * s + (1.0 - decay) * p)


@register_lower("check_finite_and_unscale")
def _check_finite_and_unscale(ctx, op):
    """Each gradient over the loss scale; ``FoundInfinite`` [1] is set
    when any of them holds a non-finite value (reference
    check_finite_and_unscale_op.cc)."""
    scale = as_scalar(ctx.in1(op, "Scale")).float()
    found = torch.zeros((), dtype=torch.bool, device=ctx.device)
    for name_in, name_out in zip(op.inputs.get("X", []),
                                 op.outputs.get("Out", [])):
        x = ctx.get(name_in)
        xs = x.float() / scale
        found = found | ~torch.isfinite(xs).all()
        ctx.set(name_out, xs if x.dtype == torch.float16 else xs.to(x.dtype))
    ctx.set_out(op, "FoundInfinite", found.reshape(1))


@register_lower("update_loss_scaling")
def _update_loss_scaling(ctx, op):
    """The dynamic loss scale's step (reference update_loss_scaling_op.cc):
    grow by ``incr_ratio`` after ``incr_every_n_steps`` finite steps,
    shrink by ``decr_ratio`` (not below 1) after
    ``decr_every_n_nan_or_inf`` non-finite ones, and zero the gradients
    of a non-finite step so its update is skipped."""
    found = ctx.in1(op, "FoundInfinite").reshape(())
    scale = as_scalar(ctx.in1(op, "PrevLossScaling"))
    good = as_scalar(ctx.in1(op, "InGoodSteps"))
    bad = as_scalar(ctx.in1(op, "InBadSteps"))
    incr_every = op.attr("incr_every_n_steps", 1000)
    decr_every = op.attr("decr_every_n_nan_or_inf", 2)
    incr_ratio = op.attr("incr_ratio", 2.0)
    decr_ratio = op.attr("decr_ratio", 0.5)
    new_bad = torch.where(found, bad + 1, torch.zeros_like(bad))
    new_good = torch.where(found, torch.zeros_like(good), good + 1)
    shrink = new_bad >= decr_every
    grow = new_good >= incr_every
    new_scale = torch.where(
        shrink, torch.clamp(scale * decr_ratio, min=1.0),
        torch.where(grow, scale * incr_ratio, scale))
    new_bad = torch.where(shrink, torch.zeros_like(new_bad), new_bad)
    new_good = torch.where(grow, torch.zeros_like(new_good), new_good)
    ctx.set_out(op, "LossScaling", new_scale.reshape(1))
    ctx.set_out(op, "OutGoodSteps", new_good.reshape(1).to(torch.int32))
    ctx.set_out(op, "OutBadSteps", new_bad.reshape(1).to(torch.int32))
    for name_in, name_out in zip(op.inputs.get("X", []),
                                 op.outputs.get("Out", [])):
        x = ctx.get(name_in)
        ctx.set(name_out, torch.where(found, torch.zeros_like(x), x))
