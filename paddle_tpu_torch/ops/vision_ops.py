"""Vision / spatial ops: roi ops, pixel shuffles, grid sampler, 3-D conv
and pool, pools with index, local response norm, unfold, and friends.

Counterpart of ``paddle_tpu/ops/vision_ops.py`` with the pooling and RoI
ops of its ``tail_ops.py`` (``max_pool3d_with_index``, ``psroi_pool``,
``prroi_pool``): plain torch on the tensor's device, every lowering held
to the JAX one where the two packages and the reference C++ differ.
Gradients come from the generic ``<type>_grad`` (autograd), but
``roi_pool``'s, which is its own ``autograd.Function`` (below).

- ``grid_sampler``, ``roi_align``, ``prroi_pool``: the JAX package's
  bilinear taps.  ``roi_align`` takes 2 samples a bin side when
  ``sampling_ratio`` <= 0 (the reference adapts the count to the bin),
  clamps each sample into [0, H-1] (the reference zeroes a sample
  outside), and ``aligned`` gives the -0.5 offset with no minimum size.
  ``prroi_pool`` averages an 8 x 8 grid of bilinear samples a bin, not
  the reference's exact integral.
- The RoI ops never gather a [RoIs, C, H, W] image stack: the bilinear
  ones are separable, one [bin, H] and one [bin, W] weight matrix a
  RoI, contracted with a chunk of RoIs' images at a time; ``roi_pool``
  reads each row's max over a column bin from the images' sparse tables
  (2 entries a window), then maxes over the row bins.  Each
  intermediate stays under ``CHUNK_ELEMS`` elements.
- A RoI's image is ``searchsorted(cumsum(RoisNum), r)``: RoIs past the
  counts' sum go to the last image, counts past R are cut, as
  ``jnp.repeat(..., total_repeat_length=R)`` gives them, on the device.
- Ties in a max's gradient: ``max_pool2d_with_index`` and ``roi_pool``
  reduce with ``jnp.max`` in the JAX package, which splits a tie evenly;
  ``pool3d`` (``reduce_window``) and ``max_pool3d_with_index`` (a strict
  ``>`` chain) give it to the first maximum.
- ``max_pool2d_with_index`` with padding: the JAX lowering takes its
  windows as a convolution with one-hot filters, where the -inf padding
  times 0 turns every window that touches the padding to NaN.  The port
  keeps the lowering's stated rule (padding never wins the max).
- ``crop_tensor`` with an ``Offsets`` input reads it on the host, as the
  JAX lowering does; a program holding one runs eagerly
  (``executor.capture_reason``, kind ``shape_tensor``).
"""
from __future__ import annotations

import itertools

import torch
import torch.nn.functional as F

from ..framework.lowering import register_lower
from .common import (adaptive_max_with_index, bilinear_sample_chw, jclip,
                     jmax, tdiv)
from .nn_ops import _conv_paddings

# elements of the largest intermediate a chunk of RoIs may make (512 MB
# in float32)
CHUNK_ELEMS = 1 << 27


def _pad_last(pads):
    """((lo, hi) per spatial dim, outermost first) as ``F.pad``'s list."""
    out = []
    for lo, hi in reversed(pads):
        out += [lo, hi]
    return out


@register_lower("pixel_shuffle")
def _pixel_shuffle(ctx, op):
    x = ctx.in1(op, "X")  # [N, C*r^2, H, W]
    r = int(op.attr("upscale_factor", 1))
    n, c, h, w = x.shape
    oc = c // (r * r)
    y = x.reshape(n, oc, r, r, h, w).permute(0, 1, 4, 2, 5, 3)
    ctx.set_out(op, "Out", y.reshape(n, oc, h * r, w * r))


@register_lower("space_to_depth")
def _space_to_depth(ctx, op):
    x = ctx.in1(op, "X")
    b = int(op.attr("blocksize", 1))
    n, c, h, w = x.shape
    y = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    ctx.set_out(op, "Out", y.reshape(n, c * b * b, h // b, w // b))


@register_lower("shuffle_channel")
def _shuffle_channel(ctx, op):
    x = ctx.in1(op, "X")
    g = int(op.attr("group", 1))
    n, c, h, w = x.shape
    y = x.reshape(n, g, c // g, h, w).transpose(1, 2)
    ctx.set_out(op, "Out", y.reshape(n, c, h, w))


@register_lower("temporal_shift")
def _temporal_shift(ctx, op):
    x = ctx.in1(op, "X")  # [N*T, C, H, W]
    t = int(op.attr("seg_num", 1))
    ratio = float(op.attr("shift_ratio", 0.25))
    nt, c, h, w = x.shape
    c1 = int(c * ratio)
    c2 = int(c * 2 * ratio)
    y = x.reshape(nt // t, t, c, h, w)
    fwd = torch.cat([y[:, 1:, :c1], torch.zeros_like(y[:, :1, :c1])], 1)
    bwd = torch.cat([torch.zeros_like(y[:, :1, c1:c2]), y[:, :-1, c1:c2]], 1)
    out = torch.cat([fwd, bwd, y[:, :, c2:]], dim=2)
    ctx.set_out(op, "Out", out.reshape(nt, c, h, w))


@register_lower("affine_channel")
def _affine_channel(ctx, op):
    x = ctx.in1(op, "X")
    layout = op.attr("data_layout", "NCHW") or "NCHW"
    caxis = 1 if layout == "NCHW" else x.dim() - 1
    shape = [1] * x.dim()
    shape[caxis] = x.shape[caxis]
    ctx.set_out(op, "Out", x * ctx.in1(op, "Scale").reshape(shape)
                + ctx.in1(op, "Bias").reshape(shape))


@register_lower("label_smooth")
def _label_smooth(ctx, op):
    x = ctx.in1(op, "X")
    dist = ctx.in1(op, "PriorDist")
    eps = float(op.attr("epsilon", 0.0))
    k = x.shape[-1]
    if dist is not None:
        out = (1 - eps) * x + eps * dist.reshape((1,) * (x.dim() - 1) + (k,))
    else:
        out = (1 - eps) * x + eps / k
    ctx.set_out(op, "Out", out)


@register_lower("lrn")
def _lrn(ctx, op):
    x = ctx.in1(op, "X")  # NCHW
    n_size = int(op.attr("n", 5))
    alpha = float(op.attr("alpha", 1e-4))
    beta = float(op.attr("beta", 0.75))
    k = float(op.attr("k", 1.0))
    half = n_size // 2
    pad = F.pad(x * x, [0, 0, 0, 0, half, n_size - 1 - half])
    acc = sum(pad[:, i:i + x.shape[1]] for i in range(n_size))
    mid = k + alpha * acc
    ctx.set_out(op, "MidOut", mid)
    ctx.set_out(op, "Out", x / torch.pow(mid, beta))


@register_lower("pad_constant_like")
def _pad_constant_like(ctx, op):
    x = ctx.in1(op, "X")  # big
    y = ctx.in1(op, "Y")  # small
    pads = [(0, xs - ys) for xs, ys in zip(x.shape, y.shape)]
    ctx.set_out(op, "Out", F.pad(y, _pad_last(pads),
                                 value=float(op.attr("pad_value", 0.0))))


@register_lower("crop", "crop_tensor")
def _crop(ctx, op):
    x = ctx.in1(op, "X")
    offsets = op.attr("offsets", []) or [0] * x.dim()
    shape = op.attr("shape", []) or list(x.shape)
    off_in = ctx.in1(op, "Offsets")
    if off_in is not None:
        # read on the host, as the JAX lowering does: a program holding
        # one runs eagerly (capture_reason "shape_tensor")
        offsets = [int(v) for v in off_in.reshape(-1).tolist()]
    shape = [x.shape[i] if s in (-1, 0) else int(s)
             for i, s in enumerate(shape)]
    sl = tuple(slice(int(o), int(o) + int(s)) for o, s in zip(offsets, shape))
    ctx.set_out(op, "Out", x[sl])


@register_lower("reverse")
def _reverse(ctx, op):
    x = ctx.in1(op, "X")
    axes = [int(a) % x.dim() for a in op.attr("axis", [0])]
    ctx.set_out(op, "Out", torch.flip(x, axes))


def _patches(x, ks, st, pd, dl=(1, 1)):
    """[N, C*kh*kw, OH*OW] windows of NCHW ``x`` (channel-major, as
    ``conv_general_dilated_patches`` orders them), ``pd`` the reference's
    [up, left, down, right]."""
    x = F.pad(x, [pd[1], pd[3], pd[0], pd[2]])
    return F.unfold(x, ks, dilation=list(dl), stride=st)


@register_lower("unfold")
def _unfold(ctx, op):
    """im2col (reference unfold_op.cc): [N,C,H,W] -> [N, C*kh*kw, L]."""
    x = ctx.in1(op, "X")
    pd = [int(p) for p in op.attr("paddings", [0, 0, 0, 0])]
    if len(pd) == 2:
        pd = [pd[0], pd[1], pd[0], pd[1]]
    ctx.set_out(op, "Y", _patches(
        x, [int(k) for k in op.attr("kernel_sizes", [1, 1])],
        [int(s) for s in op.attr("strides", [1, 1])], pd,
        [int(d) for d in op.attr("dilations", [1, 1])]))


@register_lower("im2sequence")
def _im2sequence(ctx, op):
    x = ctx.in1(op, "X")
    p = _patches(x, [int(k) for k in op.attr("kernels", [1, 1])],
                 [int(s) for s in op.attr("strides", [1, 1])],
                 [int(v) for v in op.attr("paddings", [0, 0, 0, 0])])
    # [N, C*kh*kw, OH*OW] -> [N*OH*OW, C*kh*kw]
    ctx.set_out(op, "Out", p.transpose(1, 2).reshape(-1, p.shape[1]))


@register_lower("cvm")
def _cvm(ctx, op):
    x = ctx.in1(op, "X")
    if bool(op.attr("use_cvm", True)):
        # log the first two "show/click" columns (reference cvm_op)
        sc = torch.log1p(jmax(x[:, :2], 0.0))
        ctx.set_out(op, "Y", torch.cat([sc, x[:, 2:]], dim=1))
    else:
        ctx.set_out(op, "Y", x[:, 2:])


# ---------------------------------------------------------------------------
# 3-D convolution and pooling, pools with index
# ---------------------------------------------------------------------------


@register_lower("conv3d")
def _conv3d(ctx, op):
    x = ctx.in1(op, "Input")  # NCDHW
    w = ctx.in1(op, "Filter")  # OIDHW
    strides = [int(s) for s in op.attr("strides", [1, 1, 1])]
    dilations = [int(d) for d in op.attr("dilations", [1, 1, 1])]
    pads = _conv_paddings(
        op.attr("paddings", [0, 0, 0]), op.attr("padding_algorithm", "EXPLICIT"),
        w.shape[2:], strides, dilations, x.shape[2:])
    if any(lo != hi for lo, hi in pads):
        x = F.pad(x, _pad_last(pads))
        pads = [(0, 0)] * 3
    ctx.set_out(op, "Output", F.conv3d(
        x, w, stride=strides, padding=[lo for lo, _ in pads],
        dilation=dilations, groups=int(op.attr("groups", 1) or 1)))


@register_lower("pool3d")
def _pool3d(ctx, op):
    """Max pads with -inf and gives a tie's gradient to the first maximum
    (``F.max_pool3d``, as ``reduce_window``); the average divides by the
    cells inside the input only."""
    x = ctx.in1(op, "X")  # NCDHW
    ptype = op.attr("pooling_type", "max")
    ksize = [int(k) for k in op.attr("ksize", [1, 1, 1])]
    strides = [int(s) for s in op.attr("strides", [1, 1, 1])]
    if bool(op.attr("global_pooling", False)):
        out = x.amax(dim=(2, 3, 4), keepdim=True) if ptype == "max" \
            else x.mean(dim=(2, 3, 4), keepdim=True)
        ctx.set_out(op, "Out", out)
        return
    pads = _pad_last(_conv_paddings(
        op.attr("paddings", [0, 0, 0]), op.attr("padding_algorithm", "EXPLICIT"),
        ksize, strides, [1, 1, 1], x.shape[2:]))
    if ptype == "max":
        out = F.max_pool3d(F.pad(x, pads, value=float("-inf")), ksize,
                           strides)
    else:
        s = F.avg_pool3d(F.pad(x, pads), ksize, strides, divisor_override=1)
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                          device=x.device)
        out = s / F.avg_pool3d(F.pad(ones, pads), ksize, strides,
                               divisor_override=1)
    ctx.set_out(op, "Out", out)


@register_lower("max_pool2d_with_index")
def _max_pool2d_with_index(ctx, op):
    """Max pool returning the flat h*w index of each window's first
    maximum (reference max_pool2d_with_index; the Mask feeds unpool).
    The max is ``amax`` over the window: a tie splits its gradient
    evenly, as ``jnp.max`` does."""
    x = ctx.in1(op, "X")
    ksize = [int(k) for k in op.attr("ksize", [1, 1])]
    strides = [int(s) for s in op.attr("strides", [1, 1])]
    paddings = [int(p) for p in op.attr("paddings", [0, 0])]
    if bool(op.attr("global_pooling", False)):
        ksize = list(x.shape[2:])
        paddings = [0, 0]
    n, c, h, w = x.shape
    if bool(op.attr("adaptive", False)):
        # adaptive bins (AdaptiveMaxPool2D): ksize IS the output size
        oh, ow = ksize
        if h % oh or w % ow:
            out, flat = adaptive_max_with_index(x, (oh, ow))
            ctx.set_out(op, "Out", out)
            ctx.set_out(op, "Mask", flat)
            return
        ksize = [h // oh, w // ow]
        strides = list(ksize)
        paddings = [0, 0]
    kh, kw = ksize
    # pad with -inf so padding never wins the max, then VALID windows
    xp = F.pad(x, [paddings[1]] * 2 + [paddings[0]] * 2,
               value=float("-inf"))
    oh = (h + 2 * paddings[0] - kh) // strides[0] + 1
    ow = (w + 2 * paddings[1] - kw) // strides[1] + 1
    pv = F.unfold(xp, ksize, stride=strides).reshape(n, c, kh * kw, oh, ow)
    arg = pv.argmax(dim=2)  # window-local index, first maximum
    hs = (torch.arange(oh, device=x.device) * strides[0] - paddings[0])
    ws = (torch.arange(ow, device=x.device) * strides[1] - paddings[1])
    flat = (hs[:, None] + torch.div(arg, kw, rounding_mode="floor")) * w \
        + (ws[None, :] + arg % kw)
    ctx.set_out(op, "Out", pv.amax(dim=2))
    ctx.set_out(op, "Mask", flat.to(torch.int32))


@register_lower("max_pool3d_with_index")
def _max_pool3d_with_index(ctx, op):
    """3-D (or any-D) max pooling returning flat argmax positions within
    each image (pool_with_index_op.cc): a strict ``>`` chain over the
    window's offsets, so the first maximum wins and takes the gradient.
    Mask is int32."""
    x = ctx.in1(op, "X")  # [N, C, (D,) H, W]
    spatial = x.dim() - 2
    ksize = [int(k) for k in op.attr("ksize")]
    strides = [int(s) for s in op.attr("strides", [1] * spatial)]
    paddings = [int(p) for p in op.attr("paddings", [0] * spatial)]
    in_sp = list(x.shape[2:])
    if bool(op.attr("global_pooling", False)):
        ksize = list(in_sp)
        paddings = [0] * spatial
    if bool(op.attr("adaptive", False)):
        # adaptive bins: ksize IS the output size
        if any(in_sp[i] % ksize[i] for i in range(spatial)):
            out, flat = adaptive_max_with_index(x, tuple(ksize))
            ctx.set_out(op, "Out", out)
            ctx.set_out(op, "Mask", flat)
            return
        strides = [in_sp[i] // ksize[i] for i in range(spatial)]
        ksize = list(strides)
        paddings = [0] * spatial
    xin = F.pad(x, _pad_last([(p, p) for p in paddings]),
                value=float("-inf"))
    out_sp = [(in_sp[i] + 2 * paddings[i] - ksize[i]) // strides[i] + 1
              for i in range(spatial)]
    # flat index of each padded position inside the ORIGINAL image
    flat = torch.zeros([xin.shape[2 + i] for i in range(spatial)],
                       dtype=torch.int32, device=x.device)
    mult = 1
    for i in reversed(range(spatial)):
        shape = [1] * spatial
        shape[i] = -1
        coord = torch.arange(xin.shape[2 + i], device=x.device) - paddings[i]
        flat = flat + (coord.reshape(shape) * mult).to(torch.int32)
        mult *= in_sp[i]
    best = besti = None
    for offs in itertools.product(*[range(k) for k in ksize]):
        sl = tuple(slice(offs[i], offs[i] + out_sp[i] * strides[i],
                         strides[i]) for i in range(spatial))
        v = xin[(slice(None), slice(None)) + sl]
        idx = flat[sl].expand(v.shape)
        if best is None:
            best, besti = v, idx
        else:
            better = v > best
            best = torch.where(better, v, best)
            besti = torch.where(better, idx, besti)
    ctx.set_out(op, "Out", best)
    ctx.set_out(op, "Mask", besti)


# ---------------------------------------------------------------------------
# grid sampler
# ---------------------------------------------------------------------------


def _reflect(coord, size, align_corners):
    """Reference GridSampler reflection: over [0, S-1] with
    align_corners, [-0.5, S-0.5] without (then clamped into the image)."""
    if align_corners:
        span = size - 1
        if span == 0:
            return torch.zeros_like(coord)
        t = torch.remainder(coord, 2.0 * span)
        return torch.where(t > span, 2.0 * span - t, t)
    t = torch.remainder(coord + 0.5, 2.0 * size)
    t = size - (t - size).abs()
    return jclip(t - 0.5, 0.0, size - 1)


@register_lower("grid_sampler")
def _grid_sampler(ctx, op):
    """Grid sampling (reference grid_sampler_op.cc): bilinear / nearest,
    zeros / border / reflection padding.  ``align_corners`` defaults to
    True (``F.grid_sample``'s to False); zeros padding tests the
    unclipped tap, so a coordinate in (-1, 0) contributes in part;
    reflection reflects the coordinates, then clamps at the border;
    nearest rounds halves to even.  Written as gathers
    (``bilinear_sample_chw``), not ``F.grid_sample``."""
    x = ctx.in1(op, "X")  # [N, C, H, W]
    grid = ctx.in1(op, "Grid")  # [N, Ho, Wo, 2] in [-1, 1]
    mode = op.attr("mode", "bilinear") or "bilinear"
    padding_mode = op.attr("padding_mode", "zeros") or "zeros"
    align_corners = bool(op.attr("align_corners", True))
    if padding_mode not in ("zeros", "border", "reflection"):
        raise NotImplementedError(
            f"grid_sampler padding_mode {padding_mode!r} is not lowered")
    n, c, h, w = x.shape
    if align_corners:
        gx = (grid[..., 0] + 1.0) * (w - 1) / 2.0
        gy = (grid[..., 1] + 1.0) * (h - 1) / 2.0
    else:
        gx = ((grid[..., 0] + 1.0) * w - 1.0) / 2.0
        gy = ((grid[..., 1] + 1.0) * h - 1.0) / 2.0
    if padding_mode == "reflection":
        gx = _reflect(gx, w, align_corners)
        gy = _reflect(gy, h, align_corners)
        padding_mode = "border"
    if mode == "nearest":
        yy, xx = torch.round(gy), torch.round(gx)
        idx = (yy.clamp(0, h - 1).long() * w
               + xx.clamp(0, w - 1).long()).reshape(n, 1, -1)
        out = torch.gather(x.reshape(n, c, h * w), 2,
                           idx.expand(n, c, idx.shape[2]))
        out = out.reshape((n, c) + tuple(gy.shape[1:]))
        if padding_mode == "zeros":
            valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            out = out * valid[:, None].to(x.dtype)
    else:
        out = bilinear_sample_chw(x, gy, gx, padding=padding_mode)
    ctx.set_out(op, "Output", out)


# ---------------------------------------------------------------------------
# RoI ops
# ---------------------------------------------------------------------------


def roi_batch_index(counts, r, n_images):
    """Image of each of ``r`` RoIs from per-image ``counts``, on the
    device: RoIs past the counts' sum go to the last image and counts
    past ``r`` are cut (``jnp.repeat(..., total_repeat_length=r)``);
    an index past the batch reads its last image, as a jax gather
    clamps."""
    cum = torch.cumsum(counts.reshape(-1).long(), 0)
    idx = torch.searchsorted(cum, torch.arange(r, device=counts.device),
                             right=True)
    return idx.clamp(max=min(int(cum.shape[0]), n_images) - 1)


def _roi_boxes(ctx, op, n_images):
    rois = ctx.in1(op, "ROIs")  # [R, 4] (x1, y1, x2, y2)
    slot = next((s for s in ("BatchRoINums", "RoisNum", "RoisLod")
                 if op.inputs.get(s)), None)
    if slot is None:
        # without counts every RoI belongs to image 0 (single image)
        return rois, torch.zeros(rois.shape[0], dtype=torch.long,
                                 device=rois.device)
    return rois, roi_batch_index(ctx.get(op.inputs[slot][0]),
                                 rois.shape[0], n_images)


def _chunks(r, per_roi):
    """Slices of at most ``CHUNK_ELEMS // per_roi`` RoIs covering r."""
    k = max(1, CHUNK_ELEMS // max(per_roi, 1))
    return [slice(s, min(s + k, r)) for s in range(0, r, k)]


def _tap_weights(pos, size, clamp_pos):
    """[..., S] sample positions -> [..., S, size] bilinear weights of
    each row (the two taps at floor(pos) clamped into the image and
    the row after it, also clamped): the JAX lowerings' per-sample
    ``(1 - w) * v[y0] + w * v[y1]`` as a matrix.  ``clamp_pos`` clamps
    the position itself into [0, size - 1] first (``roi_align``)."""
    y0 = torch.floor(pos).clamp(0, size - 1)
    y1 = (y0 + 1).clamp(0, size - 1)
    wy = (jclip(pos, 0, size - 1) if clamp_pos else pos) - y0
    rows = torch.arange(size, device=pos.device, dtype=pos.dtype)
    return ((1 - wy)[..., None] * (rows == y0[..., None]).to(pos.dtype)
            + wy[..., None] * (rows == y1[..., None]).to(pos.dtype))


def _separable_pool(x, batch_idx, wy, wx):
    """out[r, c, p, q] = sum_y sum_x wy[r, p, y] x[b_r, c, y, x] wx[r, q, x],
    a chunk of RoIs' images at a time."""
    _n, c, h, w = x.shape
    outs = []
    for sl in _chunks(wy.shape[0], c * h * w):
        xb = x.index_select(0, batch_idx[sl])
        t = torch.einsum("kchw,kqw->kchq", xb, wx[sl])
        outs.append(torch.einsum("kph,kchq->kcpq", wy[sl], t))
    return torch.cat(outs, 0)


@register_lower("roi_align")
def _roi_align(ctx, op):
    """The JAX lowering's rule: ``sampling_ratio`` <= 0 takes 2 samples a
    bin side, each sample clamped into [0, H-1] before its taps (no zero
    outside), ``aligned`` the -0.5 offset with no minimum size.  The
    bilinear average over a bin's samples is separable: one [bin, H] and
    one [bin, W] weight matrix a RoI."""
    x = ctx.in1(op, "X")  # [N, C, H, W]
    n, c, h, w = x.shape
    rois, batch_idx = _roi_boxes(ctx, op, n)
    ph = int(op.attr("pooled_height", 1))
    pw = int(op.attr("pooled_width", 1))
    scale = float(op.attr("spatial_scale", 1.0))
    ratio = int(op.attr("sampling_ratio", -1))
    ratio = ratio if ratio > 0 else 2
    aligned = bool(op.attr("aligned", False))
    x1, y1, x2, y2 = (rois * scale - (0.5 if aligned else 0.0)).unbind(1)
    if aligned:
        rh, rw = y2 - y1, x2 - x1
    else:
        rh, rw = jmax(y2 - y1, 1.0), jmax(x2 - x1, 1.0)
    dev, dt = rois.device, rois.dtype

    def samples(lo, extent, bins):
        b = tdiv(extent, bins)[:, None, None]
        cell = torch.arange(bins, device=dev, dtype=dt)[None, :, None]
        sub = torch.arange(ratio, device=dev, dtype=dt)[None, None, :]
        return cell * b + lo[:, None, None] + tdiv((sub + 0.5) * b, ratio)

    wy = tdiv(_tap_weights(samples(y1, rh, ph), h, True).sum(2), ratio)
    wx = tdiv(_tap_weights(samples(x1, rw, pw), w, True).sum(2), ratio)
    ctx.set_out(op, "Out", _separable_pool(x, batch_idx, wy, wx))


def _bin_windows(lo, extent, bins, size):
    """Each RoI's ``bins`` windows along one axis, [floor(lo + i b),
    ceil(lo + (i+1) b)) clipped to [0, size), b = extent / bins
    (``tdiv``: an edge on a whole pixel stays there on the card):
    (start, end) [R, bins] each, int64."""
    b = tdiv(extent, bins)[:, None]
    cell = torch.arange(bins, device=lo.device, dtype=lo.dtype)[None]
    start = torch.floor(lo[:, None] + cell * b).clamp(0, size).long()
    end = torch.ceil(lo[:, None] + (cell + 1) * b).clamp(0, size).long()
    return start, torch.maximum(start, end)


def _max_levels(v):
    """Sparse table of ``v`` along its last axis (length L): [..., J+1, L],
    level j holding the max of the 2^j values from each position (fewer
    at the end), 2^J <= L."""
    size = v.shape[-1]
    n = size.bit_length()
    table = v.new_empty(v.shape[:-1] + (n, size))
    table[..., 0, :] = v
    for j in range(1, n):
        s = 1 << (j - 1)
        torch.maximum(table[..., j - 1, :size - s], table[..., j - 1, s:],
                      out=table[..., j, :size - s])
        table[..., j, size - s:] = table[..., j - 1, size - s:]
    return table


def _range_index(start, end, size, n_levels):
    """Where a window's max lies in a flattened ``_max_levels`` table:
    the two level-j entries (2^j <= length < 2^(j+1)) covering it."""
    length = (end - start).clamp(min=1)
    j = sum((length >= (1 << t)).long() for t in range(1, n_levels))
    span = torch.ones_like(j) << j
    return j * size + start, j * size + (end - span).clamp(min=0)


def _roi_col_max(tw, batch_idx, cols, w):
    """M1 [k, C, H, pw]: each row's max over each column bin, from the
    images' sparse tables ``tw`` [N, C, H, (J+1) W]."""
    start, end = cols
    i1, i2 = _range_index(start, end, w, tw.shape[-1] // w)
    b = batch_idx[:, None]
    m = torch.maximum(tw[b, :, :, i1], tw[b, :, :, i2])  # [k, pw, C, H]
    m = m.permute(0, 2, 3, 1)
    return m.masked_fill((end <= start)[:, None, None, :], float("-inf"))


def _roi_row_max(m1, rows):
    """The bins' max [k, C, ph, pw] over each row bin of M1."""
    start, end = rows
    k, c, h, pw = m1.shape
    th = _max_levels(m1.transpose(2, 3)).reshape(k, c, pw, -1)
    i1, i2 = _range_index(start, end, h, th.shape[-1] // h)
    ph = start.shape[1]
    g = [torch.gather(th, 3, i[:, None, None, :].expand(k, c, pw, ph))
         for i in (i1, i2)]
    out = torch.maximum(*g).transpose(2, 3)
    return out.masked_fill((end <= start)[:, None, :, None], float("-inf"))


def _col_slots(cols, w):
    """Every (column bin, column) pair of each RoI, in ``w + pw`` slots:
    consecutive windows overlap by at most one column (or are at most
    two wide), so the pairs never outnumber the slots.  Returns each
    slot's bin, column and whether it holds a pair, [R, w + pw] each."""
    start, end = cols
    pw = start.shape[1]
    width = end - start
    ends = torch.cumsum(width, 1)
    slot = torch.arange(w + pw, device=start.device).expand(
        start.shape[0], w + pw).contiguous()
    which = torch.searchsorted(ends, slot, right=True).clamp(max=pw - 1)
    valid = slot < ends[:, -1:]
    pos = start.gather(1, which) + slot - (ends - width).gather(1, which)
    return which, torch.where(valid, pos, 0), valid


class _RoiMaxPool(torch.autograd.Function):
    """``roi_pool``'s max over each bin: each row's max over each column
    bin from the images' sparse tables (shared by every RoI), then over
    each row bin, a chunk of RoIs at a time.  The gradient is the JAX
    package's (``jnp.max`` over the bin's mask): each of a bin's tied
    maxima gets an even share.  The backward counts ties over each RoI's
    (column bin, column) pairs (``_col_slots``) and gathers again, so no
    [RoIs, C, H, W] tensor outlives a chunk."""

    @staticmethod
    def _chunks(x, cols):
        # the largest intermediate: [k, C, H, W + pw], or the tables
        _n, c, h, w = x.shape
        return _chunks(cols[0].shape[0], c * h * (w + cols[0].shape[1]))

    @staticmethod
    def forward(ctx, x, batch_idx, rows, cols):
        w = x.shape[3]
        tw = _max_levels(x).flatten(3)
        raw = torch.cat([
            _roi_row_max(_roi_col_max(tw, batch_idx[sl],
                                      [t[sl] for t in cols], w),
                         [t[sl] for t in rows])
            for sl in _RoiMaxPool._chunks(x, cols)], 0)
        ctx.save_for_backward(x, batch_idx, raw, *rows, *cols)
        return torch.where(torch.isfinite(raw), raw, torch.zeros_like(raw))

    @staticmethod
    def backward(ctx, g):
        x, batch_idx, raw, *bounds = ctx.saved_tensors
        rows, cols = bounds[:2], bounds[2:]
        _n, c, h, w = x.shape
        tw = _max_levels(x).flatten(3)
        which, pos, valid = _col_slots(cols, w)
        dx = torch.zeros_like(x)
        ys = torch.arange(h, device=x.device)
        for sl in _RoiMaxPool._chunks(x, cols):
            b = batch_idx[sl]
            k, pw = cols[0][sl].shape
            m1 = _roi_col_max(tw, b, [t[sl] for t in cols], w)
            out = raw[sl]
            # rows of each bin whose column max is the bin's max
            in_bin = (ys >= rows[0][sl][..., None]) & \
                (ys < rows[1][sl][..., None])               # [k, ph, H]
            b_eq = in_bin[:, None, :, :, None] & \
                (m1[:, :, None] == out[:, :, :, None, :])   # [k,C,ph,H,pw]
            # each column-bin pair whose column holds that row's max
            q, col, ok = which[sl], pos[sl], valid[sl]
            xs = x[b[:, None], :, :, col].permute(0, 2, 3, 1)  # [k,C,H,S]
            eq = (xs == torch.gather(m1, 3, q[:, None, None, :].expand(
                k, c, h, q.shape[1]))) & ok[:, None, None, :]
            eq = eq.to(x.dtype)
            onehot_q = (q[..., None] == torch.arange(
                pw, device=x.device)).to(x.dtype) * ok[..., None]
            c1 = torch.bmm(eq.reshape(k, c * h, -1), onehot_q).reshape(
                k, c, h, pw)
            n = (b_eq * c1[:, :, None]).sum(3)                  # [k,C,ph,pw]
            share = torch.where(torch.isfinite(out) & (n > 0),
                                g[sl] / n.clamp(min=1), torch.zeros_like(n))
            per_row = (b_eq * share[:, :, :, None, :]).sum(2)   # [k,C,H,pw]
            val = eq * torch.gather(per_row, 3, q[:, None, None, :].expand(
                k, c, h, q.shape[1]))
            onehot_x = (col[..., None] == torch.arange(
                w, device=x.device)).to(x.dtype) * ok[..., None]
            dxb = torch.bmm(val.reshape(k, c * h, -1), onehot_x)
            dx.index_add_(0, b, dxb.reshape(k, c, h, w))
        return dx, None, None, None


@register_lower("roi_pool")
def _roi_pool(ctx, op):
    """Max over each bin of the RoI's rounded box (``jnp.round``: halves
    to even), an empty bin 0; ``Argmax`` is int32 zeros, as in the JAX
    package.  Bins are [floor, ceil) windows; the max is
    ``_RoiMaxPool``."""
    x = ctx.in1(op, "X")
    n, c, h, w = x.shape
    rois, batch_idx = _roi_boxes(ctx, op, n)
    ph = int(op.attr("pooled_height", 1))
    pw = int(op.attr("pooled_width", 1))
    box = torch.round(rois.detach() * float(op.attr("spatial_scale", 1.0)))
    x1, y1, x2, y2 = box.unbind(1)
    rows = _bin_windows(y1, (y2 - y1 + 1).clamp(min=1.0), ph, h)
    cols = _bin_windows(x1, (x2 - x1 + 1).clamp(min=1.0), pw, w)
    out = _RoiMaxPool.apply(x, batch_idx, rows, cols)
    ctx.set_out(op, "Out", out)
    ctx.set_out(op, "Argmax", torch.zeros(out.shape, dtype=torch.int32,
                                          device=out.device))


@register_lower("psroi_pool")
def _psroi_pool(ctx, op):
    """Position-sensitive ROI average pooling (psroi_pool_op.h): output
    channel c at bin (p, q) averages input channel c*ph*pw + p*pw + q over
    that bin.  RoI corners round half away from zero (C++ ``round``),
    the far edge gets +1, then the scale; a channel count that is not
    ``output_channels * ph * pw`` raises."""
    x = ctx.in1(op, "X")          # [N, C_in, H, W]
    out_c = int(op.attr("output_channels"))
    ph_n = int(op.attr("pooled_height"))
    pw_n = int(op.attr("pooled_width"))
    scale = float(op.attr("spatial_scale", 1.0))
    n, c, h, w = x.shape
    if c != out_c * ph_n * pw_n:
        raise ValueError(
            f"psroi_pool input channels {c} != output_channels*ph*pw "
            f"({out_c}*{ph_n}*{pw_n})")
    rois, batch_idx = _roi_boxes(ctx, op, n)
    r = rois.detach()
    r = torch.sign(r) * torch.floor(r.abs() + 0.5)
    x1, y1 = r[:, 0] * scale, r[:, 1] * scale
    x2, y2 = (r[:, 2] + 1.0) * scale, (r[:, 3] + 1.0) * scale

    def masks(lo, hi, bins, size):
        start, end = _bin_windows(lo, (hi - lo).clamp(min=0.1), bins, size)
        pos = torch.arange(size, device=x.device)
        return (pos >= start[..., None]) & (pos < end[..., None])

    # an empty bin (or one outside the image) sums nothing: 0
    my, mx = masks(y1, y2, ph_n, h), masks(x1, x2, pw_n, w)
    area = (my.sum(-1)[:, :, None] * mx.sum(-1)[:, None, :]).clamp(
        min=1).to(x.dtype)
    myf, mxf = my.to(x.dtype), mx.to(x.dtype)
    outs = []
    for sl in _chunks(rois.shape[0], c * h * w):
        xb = x.index_select(0, batch_idx[sl]).reshape(
            -1, out_c, ph_n, pw_n, h, w)
        t = torch.einsum("kcpqhw,kqw->kcpqh", xb, mxf[sl])
        outs.append(torch.einsum("kcpqh,kph->kcpq", t, myf[sl]))
    ctx.set_out(op, "Out", torch.cat(outs, 0) / area[:, None])


@register_lower("prroi_pool")
def _prroi_pool(ctx, op):
    """Precise RoI pooling (prroi_pool_op.h) as the JAX package computes
    it: the average of an 8 x 8 grid of bilinear samples a bin, a sample
    outside [0, H-1] x [0, W-1] counting 0 (not the reference's exact
    integral).  Honours ``BatchRoINums``.  Separable, as ``roi_align``."""
    x = ctx.in1(op, "X")
    n, c, h, w = x.shape
    rois, batch_idx = _roi_boxes(ctx, op, n)
    ph_n = int(op.attr("pooled_height"))
    pw_n = int(op.attr("pooled_width"))
    scale = float(op.attr("spatial_scale", 1.0))
    s = 8  # samples per bin side
    x1, y1, x2, y2 = (rois * scale).unbind(1)
    dev, dt = rois.device, rois.dtype
    off = tdiv(torch.arange(s, device=dev, dtype=dt) + 0.5, s)

    def weights(lo, hi, bins, size):
        b = tdiv(jmax(hi - lo, 0.0), bins)[:, None, None]
        cell = torch.arange(bins, device=dev, dtype=dt)[None, :, None]
        pos = lo[:, None, None] + cell * b + off[None, None, :] * b
        inside = ((pos >= 0) & (pos <= size - 1)).to(dt)
        return tdiv((_tap_weights(pos, size, False)
                     * inside[..., None]).sum(2), s)

    ctx.set_out(op, "Out", _separable_pool(
        x, batch_idx, weights(y1, y2, ph_n, h), weights(x1, x2, pw_n, w)))
