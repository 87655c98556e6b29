"""Loss ops beyond the softmax / cross-entropy family.

Counterpart of ``paddle_tpu/ops/loss_ops.py`` (``cos_sim``, which the
JAX file also holds, is in ``nn_ops.py`` here).  Reference parity:
operators/{bce_loss,nll_loss,kldiv_loss,log_loss,hinge_loss,rank_loss,
margin_rank_loss,smooth_l1_loss,sigmoid_focal_loss,bpr_loss,l1_norm,
warpctc}_op.cc.  Each is a few torch lines on the tensor's device;
gradients come from the generic ``<type>_grad`` (autograd over the
replayed forward), as the JAX package's come from ``jax.vjp``.

``warpctc`` is the JAX package's ``optax.ctc_loss`` written out in torch
(``ctc_loss``), not ``F.ctc_loss``: optax scores a forbidden transition
with log(eps) = -1e5 instead of -inf, so an infeasible alignment (a
label longer than its logits allow) gives the same large finite loss in
both packages where ``F.ctc_loss`` gives inf, and every feasible one
agrees with the exact CTC loss to float32 rounding.  ``WarpCTCGrad`` is
zeros, as there: the gradient comes through ``Loss``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..framework.lowering import register_lower

CTC_LOG_EPSILON = -1e5     # optax.ctc_loss's log(+0)


@register_lower("bce_loss")
def _bce_loss(ctx, op):
    x = ctx.in1(op, "X")                       # probabilities
    label = ctx.in1(op, "Label")
    xc = torch.clamp(x, 1e-12, 1.0 - 1e-12)
    ctx.set_out(op, "Out", -(label * torch.log(xc)
                             + (1.0 - label) * torch.log1p(-xc)))


@register_lower("nll_loss")
def _nll_loss(ctx, op):
    x = ctx.in1(op, "X")                       # log-probabilities [N, C, ...]
    label = ctx.in1(op, "Label").long()
    weight = ctx.in1(op, "Weight")
    ignore_index = int(op.attr("ignore_index", -100))
    reduction = op.attr("reduction", "mean")
    safe = torch.clamp(label, 0, x.shape[1] - 1)
    picked = torch.gather(x, 1, safe.unsqueeze(1)).squeeze(1)
    w = weight[safe] if weight is not None else torch.ones_like(picked)
    w = torch.where(label == ignore_index, torch.zeros_like(w), w)
    loss = -picked * w
    total_w = torch.sum(w)
    if reduction == "mean":
        out = torch.sum(loss) / torch.clamp_min(total_w, 1e-12)
    elif reduction == "sum":
        out = torch.sum(loss)
    else:
        out = loss
    ctx.set_out(op, "Out", out)
    ctx.set_out(op, "Total_weight", total_w)


@register_lower("kldiv_loss")
def _kldiv_loss(ctx, op):
    x = ctx.in1(op, "X")                       # log-probabilities
    target = ctx.in1(op, "Target")
    reduction = op.attr("reduction", "mean")
    loss = torch.where(
        target > 0,
        target * (torch.log(torch.clamp_min(target, 1e-12)) - x),
        torch.zeros_like(target))
    if reduction == "mean":
        out = torch.mean(loss)
    elif reduction == "sum":
        out = torch.sum(loss)
    elif reduction == "batchmean":
        out = torch.sum(loss) / x.shape[0]
    else:
        out = loss
    ctx.set_out(op, "Loss", out)


@register_lower("log_loss")
def _log_loss(ctx, op):
    p = ctx.in1(op, "Predicted")
    label = ctx.in1(op, "Labels")
    eps = float(op.attr("epsilon", 1e-4))
    ctx.set_out(op, "Loss", -label * torch.log(p + eps)
                - (1.0 - label) * torch.log(1.0 - p + eps))


@register_lower("hinge_loss")
def _hinge_loss(ctx, op):
    logits = ctx.in1(op, "Logits")
    labels = ctx.in1(op, "Labels")
    ctx.set_out(op, "Loss", torch.clamp_min(
        1.0 - (2.0 * labels - 1.0) * logits, 0.0))


@register_lower("rank_loss")
def _rank_loss(ctx, op):
    d = ctx.in1(op, "Left") - ctx.in1(op, "Right")
    ctx.set_out(op, "Out", torch.logaddexp(torch.zeros_like(d), d)
                - ctx.in1(op, "Label") * d)


@register_lower("margin_rank_loss")
def _margin_rank_loss(ctx, op):
    x1 = ctx.in1(op, "X1")
    out = torch.clamp_min(-ctx.in1(op, "Label") * (x1 - ctx.in1(op, "X2"))
                          + float(op.attr("margin", 0.0)), 0.0)
    ctx.set_out(op, "Out", out)
    ctx.set_out(op, "Activated", (out > 0).to(x1.dtype))


@register_lower("smooth_l1_loss")
def _smooth_l1_loss(ctx, op):
    in_w = ctx.in1(op, "InsideWeight")
    out_w = ctx.in1(op, "OutsideWeight")
    s2 = float(op.attr("sigma", 1.0)) ** 2
    d = ctx.in1(op, "X") - ctx.in1(op, "Y")
    if in_w is not None:
        d = d * in_w
    ad = torch.abs(d)
    loss = torch.where(ad < 1.0 / s2, 0.5 * d * d * s2, ad - 0.5 / s2)
    if out_w is not None:
        loss = loss * out_w
    ctx.set_out(op, "Diff", d)
    # the reference's Out is always [N, 1]
    ctx.set_out(op, "Out", loss.sum(dim=tuple(range(1, loss.dim())))
                .reshape(-1, 1) if loss.dim() > 1 else loss)


@register_lower("sigmoid_focal_loss")
def _sigmoid_focal_loss(ctx, op):
    x = ctx.in1(op, "X")                       # [N, C] logits
    label = ctx.in1(op, "Label")               # [N, 1]; 0 is background
    gamma = float(op.attr("gamma", 2.0))
    alpha = float(op.attr("alpha", 0.25))
    c = x.shape[1]
    # classes are 1-based: target[i, j] = 1 where label[i] == j + 1
    tgt = (label.reshape(-1, 1) == torch.arange(
        1, c + 1, device=x.device)[None, :]).to(x.dtype)
    p = torch.sigmoid(x)
    ce = torch.clamp_min(x, 0) - x * tgt + torch.log1p(torch.exp(-torch.abs(x)))
    p_t = p * tgt + (1.0 - p) * (1.0 - tgt)
    a_t = alpha * tgt + (1.0 - alpha) * (1.0 - tgt)
    fg = torch.clamp_min(ctx.in1(op, "FgNum").to(x.dtype).reshape(()), 1.0)
    ctx.set_out(op, "Out", a_t * torch.pow(1.0 - p_t, gamma) * ce / fg)


@register_lower("bpr_loss")
def _bpr_loss(ctx, op):
    x = ctx.in1(op, "X")                       # [N, C]
    label = ctx.in1(op, "Label").reshape(-1, 1).long()   # [N, 1]
    n, c = x.shape
    diff = torch.gather(x, 1, label) - x
    lse = torch.logaddexp(torch.zeros_like(diff), -diff)  # log(1 + e^-diff)
    mask = torch.ones_like(x).scatter(1, label, 0.0)
    ctx.set_out(op, "Y", torch.sum(lse * mask, dim=1, keepdim=True) / (c - 1))


@register_lower("l1_norm")
def _l1_norm(ctx, op):
    ctx.set_out(op, "Out", torch.sum(torch.abs(ctx.in1(op, "X"))))


def ctc_loss(logprobs, logits_len, labels, label_len, blank):
    """``optax.ctc_loss``'s forward recursion over ``logprobs`` [B, T, C]
    (log-softmax'd), ``labels`` [B, N] right-padded, lengths [B]: the
    per-sequence loss [B].  A forbidden transition scores
    ``CTC_LOG_EPSILON`` instead of -inf, and ``repeat`` compares each
    label with the next one of the padded row, pad included, as optax
    does; a label outside [0, C) emits log-probability 0, as optax's
    one-hot does."""
    b, t, c = logprobs.shape
    n = labels.shape[1]
    dev, eps = logprobs.device, CTC_LOG_EPSILON
    labels = labels.long()
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).to(logprobs.dtype),
                   (0, 1))                                   # [B, N]
    valid = (labels >= 0) & (labels < c)
    emit_lp = torch.gather(logprobs, 2, labels.clamp(0, c - 1)[:, None, :]
                           .expand(b, t, n))
    emit_lp = torch.where(valid[:, None, :], emit_lp, 0.0)   # [B, T, N]
    phi_lp = logprobs[:, :, blank:blank + 1]                 # [B, T, 1]
    live = torch.arange(t, device=dev)[None, :] < logits_len.reshape(-1, 1)

    def add_to_phi(phi, score):
        return torch.cat([phi[:, :1], torch.logaddexp(phi[:, 1:], score)],
                         dim=1)

    phi = torch.full((b, n + 1), eps, dtype=logprobs.dtype, device=dev)
    phi[:, 0] = 0.0
    emit = torch.full((b, n), eps, dtype=logprobs.dtype, device=dev)
    for i in range(t):
        # emit-to-blank epsilon transition, except into a repeated label
        phi_in = add_to_phi(phi, emit + eps * repeat)
        e, p = emit_lp[:, i], phi_lp[:, i]
        next_emit = torch.logaddexp(phi_in[:, :-1] + e, emit + e)
        # self loop; the blank after a label only where the next repeats it
        next_phi = add_to_phi(phi_in + p, emit + p + eps * (1.0 - repeat))
        on = live[:, i:i + 1]
        emit = torch.where(on, next_emit, emit)
        phi = torch.where(on, next_phi, phi)
    phi = add_to_phi(phi, emit)
    return -torch.gather(phi, 1, label_len.reshape(-1, 1).long()).squeeze(1)


@register_lower("warpctc")
def _warpctc(ctx, op):
    logits = ctx.in1(op, "Logits")             # [T, B, C]
    logits_len = ctx.in1(op, "LogitsLength")
    label_len = ctx.in1(op, "LabelLength")
    if logits_len is None or label_len is None:
        raise NotImplementedError(
            "warpctc needs LogitsLength and LabelLength (the padded dense "
            "interface); LoD inputs are not supported, as in the JAX "
            "package")
    # one log-softmax: optax's second one over normalised rows is the
    # identity, in value and in gradient
    lp = torch.log_softmax(logits.transpose(0, 1), dim=-1)
    loss = ctc_loss(lp, logits_len.reshape(-1), ctx.in1(op, "Label"),
                    label_len.reshape(-1), int(op.attr("blank", 0)))
    if bool(op.attr("norm_by_times", False)):
        loss = loss / torch.clamp_min(logits_len.reshape(-1).to(loss.dtype),
                                      1.0)
    ctx.set_out(op, "Loss", loss.reshape(-1, 1))
    ctx.set_out(op, "WarpCTCGrad", torch.zeros_like(logits))
