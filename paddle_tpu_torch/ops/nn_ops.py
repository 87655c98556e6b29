"""NN ops: ``softmax_with_cross_entropy`` (+ grad) and ``layer_norm``.

Counterpart of ``paddle_tpu/ops/nn_ops.py``, limited to the op types the
static BERT program emits (the rest come with later slices).  Reference
parity: operators/softmax_with_cross_entropy_op.h (``ignore_index``
positions carry zero loss and zero gradient, whatever its sign) and
layer_norm_op.cc (``begin_norm_axis``; ``Mean``/``Variance`` outputs
flattened to the leading dims).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..framework.lowering import register_lower


def _hard_labels(label, ndim, axis):
    lbl = label
    if lbl.dim() == ndim and lbl.shape[axis] == 1:
        lbl = lbl.squeeze(axis)
    return lbl.long()


@register_lower("softmax_with_cross_entropy")
def _softmax_with_cross_entropy(ctx, op):
    logits = ctx.in1(op, "Logits")
    label = ctx.in1(op, "Label")
    axis = int(op.attr("axis", -1)) % logits.dim()
    ignore_index = int(op.attr("ignore_index", -100))
    logp = torch.log_softmax(logits, dim=axis)
    softmax = torch.exp(logp)
    if bool(op.attr("soft_label", False)):
        loss = -torch.sum(label * logp, dim=axis, keepdim=True)
    else:
        lbl = _hard_labels(label, logits.dim(), axis)
        # clip negative ignore labels (e.g. -1/-100) before the gather;
        # an out-of-range index would otherwise pick a real vocab row
        safe = lbl.clamp(0, logits.shape[axis] - 1)
        picked = torch.gather(logp, axis, safe.unsqueeze(axis))
        mask = lbl.unsqueeze(axis) != ignore_index
        loss = torch.where(mask, -picked, torch.zeros_like(picked))
    ctx.set_out(op, "Softmax", softmax)
    ctx.set_out(op, "Loss", loss)


@register_lower("softmax_with_cross_entropy_grad")
def _softmax_with_cross_entropy_grad(ctx, op):
    softmax = ctx.in1(op, "Softmax")
    label = ctx.in1(op, "Label")
    dloss = ctx.in1(op, "Loss@GRAD")
    axis = int(op.attr("axis", -1)) % softmax.dim()
    ignore_index = int(op.attr("ignore_index", -100))
    if bool(op.attr("soft_label", False)):
        dlogits = (softmax - label) * dloss
    else:
        lbl = _hard_labels(label, softmax.dim(), axis)
        safe = lbl.clamp(0, softmax.shape[axis] - 1)
        onehot = F.one_hot(safe, softmax.shape[axis]).to(softmax.dtype)
        onehot = onehot.movedim(-1, axis)
        dlogits = (softmax - onehot) * dloss
        # ignored positions contribute zero loss -> zero gradient
        mask = (lbl != ignore_index).unsqueeze(axis)
        dlogits = torch.where(mask, dlogits, torch.zeros_like(dlogits))
    ctx.set_out(op, "Logits@GRAD", dlogits)


@register_lower("layer_norm")
def _layer_norm(ctx, op):
    x = ctx.in1(op, "X")
    scale = ctx.get_opt((op.inputs.get("Scale") or [None])[0])
    bias = ctx.get_opt((op.inputs.get("Bias") or [None])[0])
    eps = float(op.attr("epsilon", 1e-5))
    begin = int(op.attr("begin_norm_axis", 1))
    red = tuple(range(begin, x.dim()))
    xf = x.float()
    # one-pass float32 moments, exactly the JAX package's formula (its
    # E[x^2] - E[x]^2 cancellation trade-off included)
    m = xf.mean(dim=red, keepdim=True)
    v = (xf.square().mean(dim=red, keepdim=True) - m.square()).clamp_min(0.0)
    y = (xf - m) * torch.rsqrt(v + eps)
    norm_shape = tuple(x.shape[begin:])
    if scale is not None:
        y = y * scale.reshape(norm_shape).float()
    if bias is not None:
        y = y + bias.reshape(norm_shape).float()
    ctx.set_out(op, "Y", y.to(x.dtype))
    ctx.set_out(op, "Mean", m.reshape(-1))
    ctx.set_out(op, "Variance", v.reshape(-1))
