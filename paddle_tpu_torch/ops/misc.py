"""Metric ops: ``accuracy``.

Counterpart of ``paddle_tpu/ops/misc.py`` ``_accuracy`` (reference
operators/metrics/accuracy_op.cc): the share of rows whose label is among
the top-k indices, with the count of such rows and of all rows.  The
other ops of that module live in ``math_ops`` (``increment``, ``sum``,
``clip``) or come with later slices of the port.
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
