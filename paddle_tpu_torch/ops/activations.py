"""Activation ops: ``relu``, ``tanh`` and ``gelu``.

Counterpart of ``paddle_tpu/ops/activations.py``, limited to the op
types the static BERT and ResNet programs emit (the rest come with later
slices).  ``relu_grad`` takes the generic gradient.
``gelu`` takes ``approximate`` from the op's attribute: the tanh form
when set, the exact erf form otherwise (``jax.nn.gelu`` and
``torch.nn.functional.gelu`` agree on both).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..framework.lowering import register_lower


@register_lower("relu")
def _relu(ctx, op):
    ctx.set_out(op, "Out", torch.relu(ctx.in1(op, "X")))


@register_lower("tanh")
def _tanh(ctx, op):
    ctx.set_out(op, "Out", torch.tanh(ctx.in1(op, "X")))


@register_lower("gelu")
def _gelu(ctx, op):
    approx = "tanh" if bool(op.attr("approximate", False)) else "none"
    ctx.set_out(op, "Out", F.gelu(ctx.in1(op, "X"), approximate=approx))
