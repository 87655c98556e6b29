"""Shared helpers for op lowering rules.

Counterpart of ``paddle_tpu/ops/common.py`` (the helpers the ported
lowerings use).  Two differences from the JAX package, both because
torch is not jax:

- ``attr_dtype`` keeps 64-bit types: torch has no x64 switch, so an
  ``int64`` request stays ``int64`` (the JAX package collapses it to
  ``int32``);
- ``promote`` casts both operands of a binary op to the type jax's
  promotion would give.  torch lets a 0-dim tensor's type lose against a
  dimensioned one (``bf16[B,S] + f32[]`` is bf16 in torch, f32 in jax);
  the programs' dtypes were decided under jax's rule.

``adaptive_windows`` is the JAX module's, unchanged (numpy only).
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework import dtypes


def attr_dtype(op, name="dtype", default="float32") -> torch.dtype:
    """Resolve a dtype attribute (IR enum int or string) to a torch dtype."""
    v = op.attr(name, None)
    if v is None or v == 0:
        return dtypes.to_torch(default)
    return dtypes.to_torch(v)


def op_generator(ctx, op) -> torch.Generator:
    """The generator a random op draws from: an explicit nonzero ``seed``
    attr wins (a fresh generator seeded with it, the reference's per-op
    seed semantics), else the program's stream."""
    seed = int(op.attr("seed", 0) or 0)
    if seed:
        return torch.Generator(device=ctx.device).manual_seed(seed)
    return ctx.next_generator()


def promote(x: torch.Tensor, y: torch.Tensor):
    """``x``, ``y`` cast to their common type under jax's promotion."""
    dt = torch.promote_types(x.dtype, y.dtype)
    return x.to(dt), y.to(dt)


def bcast_shapes_elementwise(x, y, axis: int):
    """Reference elementwise broadcast: align y's dims to x starting at
    `axis` (reference operators/elementwise/elementwise_op_function.h trim/
    expand semantics), then rely on numpy-style broadcasting."""
    if x.dim() == y.dim() or y.dim() == 0:
        return x, y
    if y.dim() > x.dim():
        # mirrored case: broadcast x into y (resolve axis against y's rank)
        y2, x2 = bcast_shapes_elementwise(y, x, axis)
        return x2, y2
    if axis == -1:
        axis = x.dim() - y.dim()
    new_shape = [1] * x.dim()
    new_shape[axis: axis + y.dim()] = list(y.shape)
    return x, y.reshape(new_shape)


def as_scalar(x):
    """Ops like adam receive the learning rate as a [1] tensor."""
    return x.reshape(()) if isinstance(x, torch.Tensor) and x.numel() == 1 \
        else x


def adaptive_windows(size: int, out_size: int):
    """Adaptive-pool window indices (reference AdaptiveStartIndex/
    AdaptiveEndIndex: cell i covers [floor(i*S/O), ceil((i+1)*S/O))):
    returns (idx [out, maxw] clipped, valid mask, maxw)."""
    starts = (np.arange(out_size) * size) // out_size
    ends = -(-(np.arange(1, out_size + 1) * size) // out_size)  # ceil
    maxw = int((ends - starts).max())
    idx = starts[:, None] + np.arange(maxw)[None, :]
    valid = idx < ends[:, None]
    return np.minimum(idx, size - 1), valid, maxw
