"""Image interpolation ops: ``{nearest,linear,bilinear,bicubic,trilinear}
_interp`` and their ``_v2`` forms.

Counterpart of ``paddle_tpu/ops/interp_ops.py``: separable per-axis
gathers (``index_select``) and weighted sums, one spatial axis at a time,
on the tensor's device.  ``F.interpolate`` is not used: the reference's
coordinate rules (interpolate_op.h) differ from torch's, and the JAX
package keeps them:

- ``align_corners``: source = i * (in - 1) / (out - 1);
- ``align_mode`` 0 without ``align_corners``: half-pixel,
  ratio * (i + 0.5) - 0.5, clamped at 0 by the linear kernels; the
  bicubic keeps the negative coordinate and clamps its four gathers;
- ``align_mode`` 1 without ``align_corners``: ratio * i;
- nearest without ``align_corners``: floor(i * in / out), in float32;
- the cubic is Keys' with a = -0.75.

Source coordinates are computed in float32 from a float32 ratio, as the
JAX package's weakly typed scalars give them.  Sizes resolve as the
``out_*`` attributes, then ``scale`` (a list or a scalar); a dynamic
``OutSize`` / ``SizeTensor`` raises, as in the JAX package.  NHWC and
NDHWC inputs are transposed to channels-first and back.  Gradients come
from the generic ``<type>_grad`` (autograd: the gathers' scatter-add).
"""
from __future__ import annotations

import torch

from ..framework.lowering import register_lower

CUBIC_A = -0.75


def _out_size(op, in_size, nd):
    names = ["out_d", "out_h", "out_w"][-nd:]
    sizes = [int(op.attr(n, -1) or -1) for n in names]
    if all(s > 0 for s in sizes):
        return sizes
    scale = op.attr("scale", None)
    if isinstance(scale, (list, tuple)) and scale:
        return [int(round(s * f)) for s, f in zip(in_size, scale)]
    if isinstance(scale, (int, float)) and scale > 0:
        return [int(round(s * float(scale))) for s in in_size]
    raise NotImplementedError(
        "interpolate needs static out_h/out_w (out_d) or scale attrs: a "
        "dynamic OutSize or SizeTensor is not supported, as in the JAX "
        "package; resolve the size when the program is built")


def _f32(value, dev):
    # a fill on the device, no host copy: a captured step may hold it
    return torch.full((), value, dtype=torch.float32, device=dev)


def _src_index(out_len, in_len, align_corners, align_mode, dev, clip=True):
    i = torch.arange(out_len, dtype=torch.float32, device=dev)
    if align_corners:
        return i * _f32((in_len - 1) / max(out_len - 1, 1), dev)
    ratio = _f32(in_len / out_len, dev)
    if align_mode == 0:
        src = ratio * (i + 0.5) - 0.5
        return torch.clamp_min(src, 0.0) if clip else src
    return ratio * i


def _shape_along(x, axis, v):
    shape = [1] * x.dim()
    shape[axis] = v.numel()
    return v.to(x.dtype).reshape(shape)


def _linear_axis(x, axis, out_len, align_corners, align_mode):
    in_len = x.shape[axis]
    src = _src_index(out_len, in_len, align_corners, align_mode, x.device)
    lo = torch.floor(src).long()
    hi = torch.clamp(lo + 1, 0, in_len - 1)
    lo = torch.clamp(lo, 0, in_len - 1)
    w = _shape_along(x, axis, src - lo)
    return (x.index_select(axis, lo) * (1 - w)
            + x.index_select(axis, hi) * w)


def _nearest_axis(x, axis, out_len, align_corners):
    in_len = x.shape[axis]
    if align_corners:
        src = torch.round(_src_index(out_len, in_len, True, 1, x.device))
    else:
        src = torch.floor(torch.arange(out_len, dtype=torch.float32,
                                       device=x.device)
                          * _f32(in_len / out_len, x.device))
    return x.index_select(axis, torch.clamp(src.long(), 0, in_len - 1))


def _cubic_weight(d):
    a = CUBIC_A
    d = torch.abs(d)
    return torch.where(
        d <= 1, (a + 2) * d ** 3 - (a + 3) * d ** 2 + 1,
        torch.where(d < 2, a * d ** 3 - 5 * a * d ** 2 + 8 * a * d - 4 * a,
                    torch.zeros_like(d)))


def _cubic_axis(x, axis, out_len, align_corners):
    in_len = x.shape[axis]
    src = _src_index(out_len, in_len, align_corners, 0, x.device, clip=False)
    i0 = torch.floor(src).long()
    t = src - i0
    out = 0.0
    for k in range(-1, 3):
        idx = torch.clamp(i0 + k, 0, in_len - 1)
        out = out + x.index_select(axis, idx) * _shape_along(
            x, axis, _cubic_weight(t - k))
    return out


def _interp(ctx, op, method, nd):
    x = ctx.in1(op, "X")                       # NCW / NCHW / NCDHW
    layout = op.attr("data_layout", "NCHW") or "NCHW"
    channel_last = layout.endswith("C") and len(layout) == x.dim()
    if channel_last:
        x = x.permute((0, x.dim() - 1) + tuple(range(1, x.dim() - 1)))
    in_size = tuple(x.shape[2:])
    out_size = _out_size(op, in_size, nd)
    align_corners = bool(op.attr("align_corners", True))
    align_mode = int(op.attr("align_mode", 1))
    y = x
    for i, (o, s) in enumerate(zip(out_size, in_size)):
        if o == s:
            continue
        if method == "nearest":
            y = _nearest_axis(y, 2 + i, o, align_corners)
        elif method == "cubic":
            y = _cubic_axis(y, 2 + i, o, align_corners)
        else:
            y = _linear_axis(y, 2 + i, o, align_corners, align_mode)
    if channel_last:
        y = y.permute((0,) + tuple(range(2, y.dim())) + (1,))
    ctx.set_out(op, "Out", y)


@register_lower("nearest_interp", "nearest_interp_v2")
def _nearest_interp(ctx, op):
    _interp(ctx, op, "nearest", 2)


@register_lower("bilinear_interp", "bilinear_interp_v2")
def _bilinear_interp(ctx, op):
    _interp(ctx, op, "linear", 2)


@register_lower("bicubic_interp", "bicubic_interp_v2")
def _bicubic_interp(ctx, op):
    _interp(ctx, op, "cubic", 2)


@register_lower("trilinear_interp", "trilinear_interp_v2")
def _trilinear_interp(ctx, op):
    _interp(ctx, op, "linear", 3)


@register_lower("linear_interp", "linear_interp_v2")
def _linear_interp(ctx, op):
    _interp(ctx, op, "linear", 1)
