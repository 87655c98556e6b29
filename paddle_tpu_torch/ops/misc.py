"""Metric ops: ``accuracy``, ``auc``; ``clip_by_norm``; ``print``;
``share_data`` and the ``memcpy`` family.

Counterpart of ``paddle_tpu/ops/misc.py`` ``_accuracy`` (reference
operators/metrics/accuracy_op.cc): the share of rows whose label is among
the top-k indices, with the count of such rows and of all rows; of its
``_auc`` (the batch statistic: the rank-sum form of the area under the
ROC curve, ties broken by position; float64 out); of its
``_clip_by_norm`` (reference clip_by_norm_op.h), which
``layers.clip_by_norm`` builds; of ``_print``, which writes ``message =
value`` to the host's stdout at each run (``jax.debug.print`` in the JAX
package; here a host copy, so a program holding it runs eagerly, see
``framework/executor.capture_reason``); and of ``_share_data`` (identity).
The other ops of that module live in ``math_ops`` (``increment``,
``sum``, ``clip``), ``linalg_ops`` and ``tensor_ops``, or come with later
slices of the port.
"""
from __future__ import annotations

import numpy as np
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


@register_lower("auc")
def _auc(ctx, op):
    preds = ctx.in1(op, "Predict")
    label = ctx.in1(op, "Label")
    pos_score = preds[:, 1]
    lbl = label.squeeze(-1) if label.dim() == 2 else label
    n_pos = (lbl == 1).sum().double()
    n_neg = (lbl == 0).sum().double()
    order = torch.argsort(pos_score, stable=True)
    ranks = torch.empty_like(order).scatter_(
        0, order, torch.arange(1, pos_score.shape[0] + 1,
                               device=order.device))
    sum_pos_ranks = torch.where(lbl == 1, ranks,
                                torch.zeros_like(ranks)).sum().double()
    auc = (sum_pos_ranks - n_pos * (n_pos + 1) / 2.0) / torch.clamp_min(
        n_pos * n_neg, 1)
    ctx.set_out(op, "AUC", auc.reshape(1))


@register_lower("print")
def _print(ctx, op):
    x = ctx.in1(op, "In")
    message = op.attr("message", op.input("In")[0])
    host = x.detach().cpu()
    if host.dtype == torch.bfloat16:
        host = host.float()
    print(f"{message} = {np.asarray(host)}", flush=True)
    ctx.set_out(op, "Out", x)


@register_lower("share_data", "memcpy", "memcpy_h2d", "memcpy_d2h")
def _share_data(ctx, op):
    ctx.set_out(op, "Out", ctx.in1(op, "X"))
