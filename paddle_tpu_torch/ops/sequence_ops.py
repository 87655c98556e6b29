"""Sequence ops under dense / masked semantics.

Counterpart of ``paddle_tpu/ops/sequence_ops.py``, which keeps its
contract: the reference's LoD (ragged) tensors are padded to ``[B, T,
...]`` or flattened to ``[sum T, D]`` upstream; ops that need real
lengths take them from a ``Length`` input (``sequence_pad`` /
``sequence_unpad``) or treat the time axis uniformly.  Where the JAX
lowering differs from the reference C++, the port follows the JAX
lowering, as each docstring says.

``sequence_slice`` reads its ``Offset`` and ``Length`` on the host, so a
program holding it runs eagerly (``executor.capture_reason``'s
``shape_tensor``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..framework import dtypes
from ..framework.lowering import register_lower
from .common import tdiv


@register_lower("sequence_pool")
def _sequence_pool(ctx, op):
    """[B, T, ...] -> [B, ...] pooled over the time axis, every row over
    all T (no length is read).  ``MAX`` is ``amax``, which splits a tied
    maximum's gradient evenly as ``jnp.max`` does; ``MaxIndex`` is the
    first maximum, int32; ``AVERAGE`` and ``SQRT`` divide by T and
    sqrt(T) as true divisions; ``LAST`` / ``FIRST`` take positions T - 1
    and 0."""
    x = ctx.in1(op, "X")
    ptype = op.attr("pooltype", "AVERAGE").upper()
    t = x.shape[1]
    if ptype == "AVERAGE":
        out = tdiv(x.sum(1), t)
    elif ptype == "SUM":
        out = x.sum(1)
    elif ptype == "SQRT":
        out = tdiv(x.sum(1), float(np.sqrt(t)))
    elif ptype == "MAX":
        out = torch.amax(x, dim=1)
    elif ptype == "LAST":
        out = x[:, -1]
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        raise NotImplementedError(f"sequence_pool {ptype}")
    ctx.set_out(op, "Out", out)
    if op.outputs.get("MaxIndex"):
        ctx.set_out(op, "MaxIndex", torch.argmax(x, dim=1).to(torch.int32))


@register_lower("sequence_softmax")
def _sequence_softmax(ctx, op):
    """Softmax over axis 1 (the time axis of [B, T, ...]), in float32."""
    x = ctx.in1(op, "X")
    ctx.set_out(op, "Out", torch.softmax(x.float(), dim=1).to(x.dtype))


def _time_axis(x):
    # the JAX lowering's rule: axis 1 for [B, T, ...], else axis 0
    return 1 if x.dim() > 2 else 0


@register_lower("sequence_reverse")
def _sequence_reverse(ctx, op):
    """The whole time axis flipped (axis 1 when X has more than 2 dims,
    else axis 0); no length is read."""
    x = ctx.in1(op, "X")
    ctx.set_out(op, "Y", torch.flip(x, dims=[_time_axis(x)]))


@register_lower("sequence_concat")
def _sequence_concat(ctx, op):
    """The inputs joined along axis 1 when they have more than 2 dims,
    else along axis 0."""
    xs = ctx.in_list(op, "X")
    ctx.set_out(op, "Out", torch.cat(xs, dim=_time_axis(xs[0])))


@register_lower("sequence_reshape")
def _sequence_reshape(ctx, op):
    x = ctx.in1(op, "X")
    new_dim = int(op.attr("new_dim", x.shape[-1]))
    ctx.set_out(op, "Out", x.reshape(-1, new_dim))


@register_lower("sequence_expand", "sequence_expand_as")
def _sequence_expand(ctx, op):
    """Dense form (a uniform reference LoD): each row of X repeated in
    place ``Y.shape[0] // X.shape[0]`` times (``jnp.repeat``, not a
    tile)."""
    x = ctx.in1(op, "X")
    y = ctx.in1(op, "Y")
    times = y.shape[0] // x.shape[0]
    ctx.set_out(op, "Out", torch.repeat_interleave(x, times, dim=0))


def _length_mask(length, t, dtype):
    """[B, t] 1 where the position is under the row's length."""
    pos = torch.arange(t, device=length.device)
    return (pos[None, :] < length.reshape(-1, 1)).to(dtype)


@register_lower("sequence_pad")
def _sequence_pad(ctx, op):
    """[sum T, D] + Length -> [B, maxlen, D]: the rows are grouped per
    sequence with a uniform stride T = rows // B, so this is a reshape,
    a zero pad up to ``padded_length`` (a smaller one does not crop) and
    the fill ``x * mask + pad * (1 - mask)`` of the JAX lowering (not a
    select: a NaN in a padded row stays NaN, and ``PadValue``'s gradient
    is the sum over 1 - mask).  Without ``Length`` it raises, as the JAX
    lowering does."""
    x = ctx.in1(op, "X")
    pad_value = ctx.in1(op, "PadValue")
    length = ctx.in1(op, "Length")
    padded_len = int(op.attr("padded_length", -1))
    if length is None:
        raise NotImplementedError("sequence_pad needs the Length input")
    b = length.shape[0]
    t = x.shape[0] // b
    maxlen = padded_len if padded_len > 0 else t
    xr = x.reshape((b, t) + tuple(x.shape[1:]))
    if maxlen > t:
        xr = F.pad(xr, [0, 0] * (x.dim() - 1) + [0, maxlen - t])
    mask = _length_mask(length, xr.shape[1], x.dtype)
    mask = mask.reshape(tuple(mask.shape) + (1,) * (xr.dim() - 2))
    pv = pad_value.reshape(()) if pad_value.numel() == 1 else pad_value
    ctx.set_out(op, "Out", xr * mask + pv * (1 - mask))
    ctx.set_out(op, "Length", length)


@register_lower("sequence_unpad")
def _sequence_unpad(ctx, op):
    """[B, maxlen, D] + Length -> [B * maxlen, D] with the padded rows
    zeroed (a static shape; the consumers mask)."""
    x = ctx.in1(op, "X")
    length = ctx.in1(op, "Length")
    mask = _length_mask(length, x.shape[1], x.dtype)
    out = x * mask.reshape(tuple(mask.shape) + (1,) * (x.dim() - 2))
    ctx.set_out(op, "Out", out.reshape((-1,) + tuple(x.shape[2:])))


@register_lower("sequence_slice")
def _sequence_slice(ctx, op):
    """X[offset : offset + length] along axis 0, both read on the host
    from the first entry of ``Offset`` and ``Length`` (the output's shape
    depends on them): a program holding it runs eagerly."""
    x = ctx.in1(op, "X")
    off = int(ctx.in1(op, "Offset").reshape(-1)[0].item())
    ln = int(ctx.in1(op, "Length").reshape(-1)[0].item())
    ctx.set_out(op, "Out", x[off:off + ln])


@register_lower("sequence_enumerate")
def _sequence_enumerate(ctx, op):
    """[T] or [T, 1] ids -> [T, win_size]: row i holds ids i .. i + win
    - 1, ``pad_value`` past the end; X's type."""
    x = ctx.in1(op, "X")
    win = int(op.attr("win_size", 2))
    pad = int(op.attr("pad_value", 0))
    flat = x.reshape(-1)
    tail = torch.full((win - 1,), pad, dtype=x.dtype, device=x.device)
    ctx.set_out(op, "Out", torch.cat([flat, tail]).unfold(0, win, 1))


@register_lower("sequence_mask")
def _sequence_mask(ctx, op):
    """Y[i, j] = j < X[i] over a static ``maxlen`` (without one it
    raises, as the JAX lowering does).  The type is ``out_dtype``, else
    int64 (the JAX package's int64 is int32, x64 off)."""
    x = ctx.in1(op, "X")
    maxlen = int(op.attr("maxlen", -1))
    if maxlen <= 0:
        raise NotImplementedError(
            "sequence_mask needs a static maxlen attr (a data-dependent "
            "max length gives the output a data-dependent shape)")
    out_dtype = op.attr("out_dtype", None)
    dt = dtypes.to_torch(out_dtype) if out_dtype else torch.int64
    pos = torch.arange(maxlen, device=x.device)
    ctx.set_out(op, "Y", (pos[None, :] < x.reshape(-1, 1)).to(dt))


def _shifted(x, shift):
    """Rows x[i + shift], zero where i + shift is outside [0, T)."""
    t = x.shape[0]
    if shift == 0:
        return x
    if abs(shift) >= t:
        return torch.zeros_like(x)
    if shift > 0:
        return F.pad(x[shift:], [0, 0, 0, shift])
    return F.pad(x[:t + shift], [0, 0, -shift, 0])


@register_lower("sequence_conv")
def _sequence_conv(ctx, op):
    """Context-window convolution over the time axis of a 2-D X [T, D]
    with Filter [contextLength * D, OD]: im2col of the rows
    ``contextStart .. contextStart + contextLength - 1`` away, zero
    outside [0, T), then one matmul.  The JAX lowering ignores
    ``PaddingData`` and ``paddingTrainable`` (always zero padding), and
    so does the port."""
    x = ctx.in1(op, "X")
    f = ctx.in1(op, "Filter")
    ctx_len = int(op.attr("contextLength", 3))
    ctx_start = int(op.attr("contextStart", -1))
    cols = torch.cat([_shifted(x, ctx_start + k) for k in range(ctx_len)],
                     dim=1)
    ctx.set_out(op, "Out", cols @ f)


@register_lower("row_conv")
def _row_conv(ctx, op):
    """Lookahead row convolution of a 2-D X [T, D] with Filter
    [future_context, D]: out[i] = sum_k x[i + k] * f[k] over the whole T
    (no sequence boundary), summed in k's order."""
    x = ctx.in1(op, "X")
    f = ctx.in1(op, "Filter")
    out = torch.zeros_like(x)
    for k in range(f.shape[0]):
        out = out + _shifted(x, k) * f[k][None, :]
    ctx.set_out(op, "Out", out)
