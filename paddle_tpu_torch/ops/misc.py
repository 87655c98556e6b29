"""Metric ops: ``accuracy``; and ``clip_by_norm``.

Counterpart of ``paddle_tpu/ops/misc.py`` ``_accuracy`` (reference
operators/metrics/accuracy_op.cc): the share of rows whose label is among
the top-k indices, with the count of such rows and of all rows; and of
its ``_clip_by_norm`` (reference clip_by_norm_op.h), which
``layers.clip_by_norm`` builds.  The other ops of that module live in
``math_ops`` (``increment``, ``sum``, ``clip``) or come with later slices
of the port.
"""
from __future__ import annotations

import torch

from ..framework.lowering import register_lower


@register_lower("accuracy")
def _accuracy(ctx, op):
    pred_idx = ctx.in1(op, "Indices")  # [N, k] from top_k
    label = ctx.in1(op, "Label")  # [N, 1]
    if label.dim() == 1:
        label = label[:, None]
    correct = (pred_idx == label.to(pred_idx.dtype)).any(dim=1)
    num_correct = correct.to(torch.float32).sum()
    n = pred_idx.shape[0]
    ctx.set_out(op, "Accuracy", (num_correct / n).reshape(1))
    ctx.set_out(op, "Correct", num_correct.to(torch.int32).reshape(1))
    ctx.set_out(op, "Total", torch.full((1,), n, dtype=torch.int32,
                                        device=pred_idx.device))


@register_lower("clip_by_norm")
def _clip_by_norm(ctx, op):
    """``x`` scaled by ``max_norm / ||x||_2`` when its norm exceeds
    ``max_norm``, else unchanged."""
    x = ctx.in1(op, "X")
    max_norm = float(op.attr("max_norm"))
    norm = torch.sqrt(torch.sum(torch.square(x)))
    factor = torch.where(norm > max_norm,
                         max_norm / torch.clamp(norm, min=1e-12),
                         torch.ones_like(norm))
    ctx.set_out(op, "Out", x * factor.to(x.dtype))
