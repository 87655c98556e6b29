"""Detection ops: anchors, box coding, IoU, YOLO decoding.

Counterpart of ``paddle_tpu/ops/detection_ops.py``: the dense,
statically shaped subset of operators/detection/ (``prior_box``,
``anchor_generator``, ``iou_similarity``, ``box_coder``, ``yolo_box``,
``box_clip``), plain torch on the tensor's device.  The NMS-style ops
live in ``nms_ops.py``.  ``prior_box`` and ``anchor_generator`` compute
their boxes' widths and heights from attributes alone, in numpy on the
host as the JAX package does, and build them on the device by fills
(``device_const``): no data is read.  Extremes use jax's tie rule for
the gradient (``jmax`` / ``jclip``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..framework.lowering import register_lower
from .common import device_const, jclip, jmax, jmin, tdiv


def _grid(h, w, cx, cy):
    """Cell centers [H, W, 1] from per-column ``cx`` and per-row ``cy``."""
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    return cxg[..., None], cyg[..., None]


def _variances(op, h, w, p, dev):
    v = [float(x) for x in op.attr("variances", [0.1, 0.1, 0.2, 0.2])]
    return device_const(v, torch.float32, dev).expand(h, w, p, 4).contiguous()


@register_lower("prior_box")
def _prior_box(ctx, op):
    """SSD prior boxes (reference detection/prior_box_op.h): per feature-
    map cell, boxes for each (min_size, aspect_ratio) pair + optional
    max_size geometric means."""
    feat = ctx.in1(op, "Input")  # [N, C, H, W]
    image = ctx.in1(op, "Image")  # [N, C, IH, IW]
    min_sizes = [float(s) for s in op.attr("min_sizes", [])]
    max_sizes = [float(s) for s in op.attr("max_sizes", []) or []]
    ars = [float(a) for a in op.attr("aspect_ratios", [1.0])]
    flip = bool(op.attr("flip", True))
    step_w = float(op.attr("step_w", 0.0))
    step_h = float(op.attr("step_h", 0.0))
    offset = float(op.attr("offset", 0.5))
    min_max_ar_first = bool(op.attr("min_max_aspect_ratios_order", False))
    h, w = feat.shape[2], feat.shape[3]
    ih, iw = image.shape[2], image.shape[3]
    sw = step_w if step_w > 0 else iw / w
    sh = step_h if step_h > 0 else ih / h

    # expanded aspect ratios (reference ExpandAspectRatios: 1.0 first,
    # then each ratio and optionally its flip, deduped)
    out_ars = [1.0]
    for ar in ars:
        if any(abs(ar - e) < 1e-6 for e in out_ars):
            continue
        out_ars.append(ar)
        if flip:
            out_ars.append(1.0 / ar)
    # per-cell (width, height) list in the reference emission order
    whs = []
    for mi, ms in enumerate(min_sizes):
        if min_max_ar_first:
            # [min (ar=1), max, remaining aspect ratios]: the layout
            # SSD-caffe checkpoints expect
            whs.append((ms, ms))
            if max_sizes:
                whs.append((np.sqrt(ms * max_sizes[mi]),) * 2)
            whs += [(ms * np.sqrt(ar), ms / np.sqrt(ar)) for ar in out_ars
                    if abs(ar - 1.0) >= 1e-6]
            continue
        whs += [(ms * np.sqrt(ar), ms / np.sqrt(ar)) for ar in out_ars]
        if max_sizes:
            whs.append((np.sqrt(ms * max_sizes[mi]),) * 2)
    whs = np.asarray(whs, np.float32)  # [P, 2]
    dev = feat.device
    cxg, cyg = _grid(
        h, w, (torch.arange(w, dtype=torch.float32, device=dev) + offset) * sw,
        (torch.arange(h, dtype=torch.float32, device=dev) + offset) * sh)
    bw = device_const(whs[:, 0], torch.float32, dev) / 2.0
    bh = device_const(whs[:, 1], torch.float32, dev) / 2.0
    boxes = torch.stack([tdiv(cxg - bw, iw), tdiv(cyg - bh, ih),
                         tdiv(cxg + bw, iw), tdiv(cyg + bh, ih)], dim=-1)
    if bool(op.attr("clip", True)):
        boxes = boxes.clamp(0.0, 1.0)
    ctx.set_out(op, "Boxes", boxes)
    ctx.set_out(op, "Variances", _variances(op, h, w, whs.shape[0], dev))


@register_lower("anchor_generator")
def _anchor_generator(ctx, op):
    """RCNN anchors — exact reference math (anchor_generator_op.h:53-75):
    rounded base sizes from the stride area, scale by anchor_size/stride,
    -1 half-extents, centers at idx*stride + offset*(stride-1)."""
    feat = ctx.in1(op, "Input")  # [N, C, H, W]
    sizes = [float(s) for s in op.attr("anchor_sizes", [])]
    ars = [float(a) for a in op.attr("aspect_ratios", [])]
    sw, sh = [float(s) for s in op.attr("stride", [16.0, 16.0])]
    offset = float(op.attr("offset", 0.5))
    h, w = feat.shape[2], feat.shape[3]
    whs = []
    for ar in ars:  # ratio-major loop order (reference idx order)
        for size in sizes:
            base_w = np.round(np.sqrt(sw * sh / ar))
            base_h = np.round(base_w * ar)
            whs.append((size / sw * base_w, size / sh * base_h))
    whs = np.asarray(whs, np.float32)
    dev = feat.device
    cxg, cyg = _grid(
        h, w, torch.arange(w, dtype=torch.float32, device=dev) * sw
        + offset * (sw - 1),
        torch.arange(h, dtype=torch.float32, device=dev) * sh
        + offset * (sh - 1))
    bw = 0.5 * (device_const(whs[:, 0], torch.float32, dev) - 1.0)
    bh = 0.5 * (device_const(whs[:, 1], torch.float32, dev) - 1.0)
    ctx.set_out(op, "Anchors", torch.stack(
        [cxg - bw, cyg - bh, cxg + bw, cyg + bh], dim=-1))
    ctx.set_out(op, "Variances", _variances(op, h, w, whs.shape[0], dev))


@register_lower("iou_similarity")
def _iou_similarity(ctx, op):
    """Pairwise IoU (reference detection/iou_similarity_op.h):
    X [N, 4] vs Y [M, 4] -> [N, M]."""
    x = ctx.in1(op, "X")
    y = ctx.in1(op, "Y")
    d = 0.0 if bool(op.attr("box_normalized", True)) else 1.0

    def area(b):
        return (b[..., 2] - b[..., 0] + d) * (b[..., 3] - b[..., 1] + d)

    xi, yi = x[:, None, :], y[None, :, :]
    ix1 = torch.maximum(xi[..., 0], yi[..., 0])
    iy1 = torch.maximum(xi[..., 1], yi[..., 1])
    ix2 = torch.minimum(xi[..., 2], yi[..., 2])
    iy2 = torch.minimum(xi[..., 3], yi[..., 3])
    inter = jmax(ix2 - ix1 + d, 0.0) * jmax(iy2 - iy1 + d, 0.0)
    union = area(x)[:, None] + area(y)[None, :] - inter
    ctx.set_out(op, "Out", inter / jmax(union, 1e-10))


@register_lower("box_coder")
def _box_coder(ctx, op):
    """Encode/decode target boxes against priors (reference
    detection/box_coder_op.h).  The variance is the ``PriorBoxVar``
    tensor, else the 4-float ``variance`` attr, else ones; decode
    broadcasts the priors along ``axis`` 0 or 1; encode takes
    log|tw/pw|; ``box_normalized=False`` adds 1 to extents."""
    prior = ctx.in1(op, "PriorBox")  # [M, 4]
    prior_var = ctx.in1(op, "PriorBoxVar")  # [M, 4] or None
    target = ctx.in1(op, "TargetBox")
    code_type = op.attr("code_type", "encode_center_size")
    axis = int(op.attr("axis", 0))
    d = 0.0 if bool(op.attr("box_normalized", True)) else 1.0
    pw = prior[:, 2] - prior[:, 0] + d
    ph = prior[:, 3] - prior[:, 1] + d
    pcx = prior[:, 0] + pw * 0.5
    pcy = prior[:, 1] + ph * 0.5
    if prior_var is not None:
        pv = prior_var
    else:
        var_attr = [float(v) for v in op.attr("variance", []) or []] \
            or [1.0] * 4
        pv = device_const(var_attr, prior.dtype, prior.device).expand(
            prior.shape[0], 4)
    if "encode" in code_type:
        # target [N, 4] vs priors [M, 4] -> [N, M, 4]
        tw = target[:, 2] - target[:, 0] + d
        th = target[:, 3] - target[:, 1] + d
        tcx = target[:, 0] + tw * 0.5
        tcy = target[:, 1] + th * 0.5
        ox = (tcx[:, None] - pcx[None, :]) / pw[None, :] / pv[None, :, 0]
        oy = (tcy[:, None] - pcy[None, :]) / ph[None, :] / pv[None, :, 1]
        ow = torch.log(torch.abs(tw[:, None] / pw[None, :])) / pv[None, :, 2]
        oh = torch.log(torch.abs(th[:, None] / ph[None, :])) / pv[None, :, 3]
        out = torch.stack([ox, oy, ow, oh], dim=-1)
    else:
        # decode: target [N, M, 4] deltas against priors broadcast on axis
        if axis == 0:
            pcx, pcy, pw, ph = (v[None, :] for v in (pcx, pcy, pw, ph))
            pv = pv[None, :, :]
        else:
            pcx, pcy, pw, ph = (v[:, None] for v in (pcx, pcy, pw, ph))
            pv = pv[:, None, :]
        dcx = pv[..., 0] * target[..., 0] * pw + pcx
        dcy = pv[..., 1] * target[..., 1] * ph + pcy
        dw = torch.exp(pv[..., 2] * target[..., 2]) * pw
        dh = torch.exp(pv[..., 3] * target[..., 3]) * ph
        out = torch.stack([dcx - dw / 2, dcy - dh / 2,
                           dcx + dw / 2 - d, dcy + dh / 2 - d], dim=-1)
    ctx.set_out(op, "OutputBox", out)


@register_lower("yolo_box")
def _yolo_box(ctx, op):
    """YOLOv3 head decoding (reference detection/yolo_box_op.h): the int
    ``ImgSize`` is cast, boxes and scores under ``conf_thresh`` are
    zeroed, ``scale_x_y`` != 1 shifts by -0.5 (s - 1) (PP-YOLO)."""
    x = ctx.in1(op, "X")  # [N, A*(5+C), H, W]
    img_size = ctx.in1(op, "ImgSize")  # [N, 2] (h, w) int
    anchors = [int(a) for a in op.attr("anchors", [])]
    class_num = int(op.attr("class_num", 1))
    conf_thresh = float(op.attr("conf_thresh", 0.01))
    downsample = int(op.attr("downsample_ratio", 32))
    scale = float(op.attr("scale_x_y", 1.0))
    bias = -0.5 * (scale - 1.0)
    n, _c, h, w = x.shape
    a = len(anchors) // 2
    xr = x.reshape(n, a, 5 + class_num, h, w)
    img_h = img_size[:, 0].to(x.dtype)[:, None, None, None]
    img_w = img_size[:, 1].to(x.dtype)[:, None, None, None]
    dev = x.device
    gx = torch.arange(w, dtype=x.dtype, device=dev)[None, None, None, :]
    gy = torch.arange(h, dtype=x.dtype, device=dev)[None, None, :, None]
    aw = device_const(anchors[0::2], x.dtype, dev)[None, :, None, None]
    ah = device_const(anchors[1::2], x.dtype, dev)[None, :, None, None]
    bx = tdiv((gx + torch.sigmoid(xr[:, :, 0]) * scale + bias) * img_w, w)
    by = tdiv((gy + torch.sigmoid(xr[:, :, 1]) * scale + bias) * img_h, h)
    bw = tdiv(torch.exp(xr[:, :, 2]) * aw * img_w, downsample * w)
    bh = tdiv(torch.exp(xr[:, :, 3]) * ah * img_h, downsample * h)
    conf = torch.sigmoid(xr[:, :, 4])
    x1, y1 = bx - bw / 2, by - bh / 2
    x2, y2 = bx + bw / 2, by + bh / 2
    if bool(op.attr("clip_bbox", True)):
        x1, y1 = jmax(x1, 0.0), jmax(y1, 0.0)
        x2, y2 = jmin(x2, img_w - 1), jmin(y2, img_h - 1)
    # the reference zeroes boxes whose conf < thresh
    keep = (conf >= conf_thresh)[..., None].to(x.dtype)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1) * keep  # [N, A, H, W, 4]
    scores = conf[..., None] * torch.sigmoid(xr[:, :, 5:].movedim(2, -1)) \
        * keep
    ctx.set_out(op, "Boxes", boxes.reshape(n, a * h * w, 4))
    ctx.set_out(op, "Scores", scores.reshape(n, a * h * w, class_num))


@register_lower("box_clip")
def _box_clip(ctx, op):
    """Clip to the image, rescaled: round(h / scale) - 1 with halves to
    even (``jnp.round``).  A flat [N, 4] input with several images
    raises."""
    boxes = ctx.in1(op, "Input")  # [N, 4] (single image) or [B, N, 4]
    im_info = ctx.in1(op, "ImInfo")  # [B, 3] (h, w, scale)
    h = torch.round(im_info[:, 0] / im_info[:, 2]) - 1.0
    w = torch.round(im_info[:, 1] / im_info[:, 2]) - 1.0
    if boxes.dim() == 2:
        if im_info.shape[0] != 1:
            raise NotImplementedError(
                "box_clip with a flat [N,4] box tensor and multiple "
                "images needs LoD segments, which dense tensors do not "
                "carry; pass [B,N,4] batched boxes instead")
        hb, wb = h[0], w[0]
    else:
        hb, wb = h[:, None], w[:, None]
    ctx.set_out(op, "Output", torch.stack([
        jclip(boxes[..., 0], 0, wb), jclip(boxes[..., 1], 0, hb),
        jclip(boxes[..., 2], 0, wb), jclip(boxes[..., 3], 0, hb)], dim=-1))
