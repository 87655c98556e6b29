"""Deformable convolution v1/v2 via bilinear sampling + one product.

Counterpart of ``paddle_tpu/ops/deformable_ops.py`` (reference
operators/deformable_conv_op.cu, v2 with the modulation ``Mask``, and
deformable_conv_v1_op.cu): the deformable im2col is a bilinear gather
(``bilinear_sample_chw``, zeros outside the image) of every (kernel
position, output location) pair, one deformable group a batch row,
times the mask, then one grouped product with the filter (``einsum``,
as in the JAX package).  Offsets are (dy, dx) pairs laid out as
[N, dg, kh*kw, 2, OH, OW].  Gradients of Input, Offset, Mask and Filter
come from the generic ``<type>_grad`` (the gathers' scatter-add).
"""
from __future__ import annotations

import torch

from ..framework.lowering import register_lower
from .common import bilinear_sample_chw


def _deformable_conv(ctx, op, with_mask):
    x = ctx.in1(op, "Input")  # [N, C, H, W]
    offset = ctx.in1(op, "Offset")  # [N, 2*dg*kh*kw, OH, OW]
    mask = ctx.in1(op, "Mask") if with_mask else None  # [N, dg*kh*kw, OH, OW]
    f = ctx.in1(op, "Filter")  # [O, C/g, kh, kw]
    strides = [int(s) for s in op.attr("strides", [1, 1])]
    paddings = [int(p) for p in op.attr("paddings", [0, 0])]
    dilations = [int(d) for d in op.attr("dilations", [1, 1])]
    groups = int(op.attr("groups", 1) or 1)
    dg = int(op.attr("deformable_groups", 1) or 1)
    n, c, h, w = x.shape
    o, _cg, kh, kw = f.shape
    oh, ow = offset.shape[2], offset.shape[3]
    kk = kh * kw
    dev = x.device

    # base sampling grid per (kernel pos, output loc): [kk, OH, OW]
    ky = (torch.arange(kh, device=dev) * dilations[0])[:, None, None, None]
    kx = (torch.arange(kw, device=dev) * dilations[1])[None, :, None, None]
    oy = (torch.arange(oh, device=dev) * strides[0]
          - paddings[0])[None, None, :, None]
    ox = (torch.arange(ow, device=dev) * strides[1]
          - paddings[1])[None, None, None, :]
    gy = (ky + oy).to(x.dtype).expand(kh, kw, oh, ow).reshape(kk, oh, ow)
    gx = (kx + ox).to(x.dtype).expand(kh, kw, oh, ow).reshape(kk, oh, ow)

    off = offset.reshape(n * dg, kk, 2, oh, ow)
    cpg = c // dg  # channels per deformable group
    cols = bilinear_sample_chw(x.reshape(n * dg, cpg, h, w),
                               gy + off[:, :, 0], gx + off[:, :, 1])
    if mask is not None:  # cols [N*dg, cpg, kk, OH, OW]
        cols = cols * mask.reshape(n * dg, 1, kk, oh, ow)
    # cols [N, C, kk, OH, OW] -> grouped product with the filter
    cg, og = c // groups, o // groups
    out = torch.einsum("ngckl,gock->ngol",
                       cols.reshape(n, groups, cg, kk, oh * ow),
                       f.reshape(groups, og, cg, kk))
    ctx.set_out(op, "Output", out.reshape(n, o, oh, ow))


@register_lower("deformable_conv")
def _deformable_conv_v2(ctx, op):
    _deformable_conv(ctx, op, with_mask=True)


@register_lower("deformable_conv_v1")
def _deformable_conv_v1(ctx, op):
    _deformable_conv(ctx, op, with_mask=False)
