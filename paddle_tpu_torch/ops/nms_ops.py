"""NMS / proposal / matching ops as masked fixed-size lowerings.

Counterpart of ``paddle_tpu/ops/nms_ops.py`` (reference
operators/detection/multiclass_nms_op.cc, matrix_nms_op.cc,
generate_proposals_op.cc, bipartite_match_op.cc).  As in the JAX
package, every op returns FIXED-size outputs padded at the tail plus an
explicit valid count, so nothing is read on the host and a program
holding them captures like any other:

- multiclass_nms / multiclass_nms2 / multiclass_nms3: Out is
  [B, keep_top_k, 6] with invalid rows marked class = -1 (the
  reference's own no-detection marker), multiclass_nms2/3 add Index
  [B, keep_top_k] (-1 pad) and NmsRoisNum [B] (int32).
- matrix_nms: same contract (Out/Index/RoisNum).
- generate_proposals(_v2): RpnRois [B, post_nms_topN, 4], RpnRoiProbs
  [B, post_nms_topN, 1], RpnRoisNum [B]; pad rows are zero with prob 0.
- bipartite_match: dense [B, rows, cols] (or single [rows, cols])
  DistMat; a 2-D one gives [1, cols] outputs.

``lax.top_k`` puts the lower index first among equal scores; torch's
``topk`` does not promise that, so every top-k here is a stable
descending sort (``_top_k``).  The greedy suppression
(``_greedy_nms_keep``) is one Python loop over the K sorted candidates,
batched over images and classes, a fixed handful of launches a step.
Which boxes survive is decided on detached values; the kept scores and
boxes are gathered from the inputs, so the gradient flows as jax's vjp
gives it (``matrix_nms``'s decayed scores keep their path to the boxes).
The [K, K] IoU matrices are built a block of rows at a time
(``IOU_CHUNK``), never more than one whole copy.
"""
from __future__ import annotations

import math

import torch

from ..framework.lowering import register_lower
from .common import jclip, jmax, jmin

NEG = -1e9
# elements of an IoU block built at once (the K x K matrices of up to
# this many (image, class) rows together)
IOU_CHUNK = 1 << 25


def _top_k(s, k):
    """``lax.top_k`` along the last axis: the k largest, the lower index
    first among equals."""
    v, i = torch.sort(s, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _take_boxes(boxes, idx):
    """boxes [B, M, 4], idx [B, ...] -> [B, ..., 4]."""
    b = boxes.shape[0]
    flat = idx.reshape(b, -1)
    out = torch.gather(boxes, 1, flat[..., None].expand(b, flat.shape[1], 4))
    return out.reshape(tuple(idx.shape) + (4,))


def _pairwise_iou(boxes, normalized):
    """IoU matrix [..., M, M] (reference JaccardOverlap): +1 extent when
    the boxes are in un-normalized pixel coordinates."""
    off = 0.0 if normalized else 1.0
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = jmax(x2 - x1 + off, 0.0) * jmax(y2 - y1 + off, 0.0)
    iw = jmax(torch.minimum(x2[..., :, None], x2[..., None, :])
              - torch.maximum(x1[..., :, None], x1[..., None, :]) + off, 0.0)
    ih = jmax(torch.minimum(y2[..., :, None], y2[..., None, :])
              - torch.maximum(y1[..., :, None], y1[..., None, :]) + off, 0.0)
    inter = iw * ih
    union = area[..., :, None] + area[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def _iou_blocks(boxes, normalized):
    """``_pairwise_iou`` of detached boxes [..., K, 4], built a block of
    leading rows at a time into one tensor."""
    k = boxes.shape[-2]
    flat = boxes.reshape(-1, k, 4)
    iou = torch.empty((flat.shape[0], k, k), dtype=boxes.dtype,
                      device=boxes.device)
    step = max(1, IOU_CHUNK // max(k * k, 1))
    for s in range(0, flat.shape[0], step):
        iou[s:s + step] = _pairwise_iou(flat[s:s + step], normalized)
    return iou.reshape(tuple(boxes.shape[:-2]) + (k, k))


def _greedy_nms_keep(boxes, valid, iou_threshold, eta, normalized):
    """Keep-mask [..., K] over score-desc-sorted boxes [..., K, 4]
    (reference NMSFast): each CANDIDATE is tested against the threshold
    as decayed by all previously KEPT boxes (adaptive eta applies at
    candidate time, not keeper time); after every kept box the
    threshold decays by eta while it stays above 0.5."""
    with torch.no_grad():
        iou = _iou_blocks(boxes.detach(), normalized)
        keep = torch.zeros_like(valid)
        thr = torch.full(valid.shape[:-1], iou_threshold,
                         dtype=torch.float32, device=valid.device)
        zero = torch.zeros((), dtype=iou.dtype, device=iou.device)
        for j in range(valid.shape[-1]):
            # boxes after j are not kept yet: the row's max over the kept
            ov = torch.where(keep, iou[..., j, :], zero).amax(dim=-1)
            kj = valid[..., j] & (ov <= thr)
            keep[..., j] = kj
            if eta < 1.0:
                thr = torch.where(kj & (thr > 0.5), thr * eta, thr)
    return keep


def _merge_keep_top_k(sel, cls, order, boxes, keep_top_k):
    """Cross-class merge (reference keep_top_k stage), per image: sel
    [B, T] (suppressed at NEG), cls [T], order [B, T] box indices ->
    rows [B, keep, 6] = (label, score, box), -1-class padded, the box
    indices [B, keep] and the valid counts [B]."""
    total = sel.shape[1]
    keep = total if keep_top_k <= 0 else min(int(keep_top_k), total)
    top_s, top_i = _top_k(sel, keep)
    valid = top_s > NEG / 2
    label = torch.where(valid, cls[top_i], -1)
    oi = torch.gather(order, 1, top_i)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    b = torch.where(valid[..., None], _take_boxes(boxes, oi), zero)
    score = torch.where(valid, top_s, zero)
    out = torch.cat([label[..., None].to(boxes.dtype), score[..., None], b],
                    dim=-1)
    return (out, torch.where(valid, oi, -1).to(torch.int32),
            valid.sum(1).to(torch.int32))


def _class_candidates(scores, score_thr, nms_top_k):
    """scores [B, C, M] -> the top K of each class above ``score_thr``
    (others at NEG): (top_s, order) [B, C, K]."""
    m = scores.shape[-1]
    k = m if nms_top_k <= 0 else min(int(nms_top_k), m)
    neg = torch.full((), NEG, dtype=scores.dtype, device=scores.device)
    return _top_k(torch.where(scores > score_thr, scores, neg), k)


def _batched(ctx, op):
    boxes = ctx.in1(op, "BBoxes")   # [B, M, 4]
    scores = ctx.in1(op, "Scores")  # [B, C, M]
    return (boxes[None] if boxes.dim() == 2 else boxes,
            scores[None] if scores.dim() == 2 else scores)


def _nms_common(ctx, op, with_index):
    boxes, scores = _batched(ctx, op)
    background = int(op.attr("background_label", 0))
    c = scores.shape[1]
    top_s, order = _class_candidates(
        scores, float(op.attr("score_threshold", 0.0)),
        int(op.attr("nms_top_k", -1)))
    keep = _greedy_nms_keep(
        _take_boxes(boxes, order), top_s > NEG / 2,
        float(op.attr("nms_threshold", 0.3)), float(op.attr("nms_eta", 1.0)),
        bool(op.attr("normalized", True)))
    cls = torch.arange(c, device=scores.device)
    keep = keep & (cls != background)[None, :, None]
    sel = torch.where(keep, top_s, torch.full((), NEG, dtype=top_s.dtype,
                                              device=top_s.device))
    k = order.shape[-1]
    out, index, count = _merge_keep_top_k(
        sel.reshape(sel.shape[0], -1), cls.repeat_interleave(k),
        order.reshape(order.shape[0], -1), boxes,
        int(op.attr("keep_top_k", -1)))
    ctx.set_out(op, "Out", out)
    if with_index:
        ctx.set_out(op, "Index", index)
    ctx.set_out(op, "NmsRoisNum", count)
    ctx.set_out(op, "RoisNum", count)


@register_lower("multiclass_nms")
def _multiclass_nms(ctx, op):
    _nms_common(ctx, op, with_index=False)


@register_lower("multiclass_nms2", "multiclass_nms3")
def _multiclass_nms2(ctx, op):
    _nms_common(ctx, op, with_index=True)


@register_lower("matrix_nms")
def _matrix_nms(ctx, op):
    """Parallel soft-NMS (reference matrix_nms_op.cc): each candidate's
    score decays by the worst-case overlap with any higher-scored
    candidate, compensated by that candidate's own overlap history.
    With ``nms_top_k`` -1, K is the box count and each class holds a
    [M, M] matrix, as in the JAX lowering; classes go a block at a
    time (``IOU_CHUNK``)."""
    boxes, scores = _batched(ctx, op)
    background = int(op.attr("background_label", 0))
    post_thr = float(op.attr("post_threshold", 0.0))
    use_gaussian = bool(op.attr("use_gaussian", False))
    sigma = float(op.attr("gaussian_sigma", 2.0))
    normalized = bool(op.attr("normalized", True))
    b, c, _m = scores.shape
    top_s, order = _class_candidates(
        scores, float(op.attr("score_threshold", 0.0)),
        int(op.attr("nms_top_k", -1)))
    k = order.shape[-1]
    tri = torch.tril(torch.ones((k, k), dtype=torch.bool,
                                device=scores.device), -1)
    one = torch.ones((), dtype=scores.dtype, device=scores.device)
    zero = torch.zeros((), dtype=scores.dtype, device=scores.device)
    neg = torch.full((), NEG, dtype=scores.dtype, device=scores.device)
    sels = []
    step = max(1, IOU_CHUNK // max(b * k * k, 1))
    for c0 in range(0, c, step):
        ts, od = top_s[:, c0:c0 + step], order[:, c0:c0 + step]
        iou = torch.where(tri, _pairwise_iou(_take_boxes(boxes, od),
                                             normalized), zero)
        comp = iou.amax(dim=-1)          # compensate_iou per box
        if use_gaussian:
            decay = torch.exp((comp[..., None, :] ** 2 - iou ** 2) * sigma)
        else:
            decay = (1.0 - iou) / (1.0 - comp[..., None, :])
        ds = ts * torch.where(tri, decay, one).amin(dim=-1)
        cls = torch.arange(c0, c0 + ts.shape[1], device=scores.device)
        ok = (ts > NEG / 2) & (ds > post_thr) & (cls != background)[:, None]
        sels.append(torch.where(ok, ds, neg))
    sel = torch.cat(sels, 1)
    out, index, count = _merge_keep_top_k(
        sel.reshape(b, -1),
        torch.arange(c, device=scores.device).repeat_interleave(k),
        order.reshape(b, -1), boxes, int(op.attr("keep_top_k", -1)))
    ctx.set_out(op, "Out", out)
    ctx.set_out(op, "Index", index)
    ctx.set_out(op, "RoisNum", count)


@register_lower("bipartite_match")
def _bipartite_match(ctx, op):
    """Greedy global-argmax matching (reference bipartite_match_op.cc):
    ``min(rows, cols)`` times, the largest remaining entry binds its row
    to its column, until no positive entry is left; ``per_prediction``
    then fills each unmatched column whose best row is at or above
    ``dist_threshold``."""
    dist = ctx.in1(op, "DistMat")
    if dist.dim() == 2:
        dist = dist[None]            # the reference emits [1, C]
    b, r, c = dist.shape
    dev = dist.device
    rows = torch.arange(r, device=dev)
    cols = torch.arange(c, device=dev)
    with torch.no_grad():
        dm = dist.detach().clone()
        idx = torch.full((b, c), -1, dtype=torch.long, device=dev)
        for _ in range(min(r, c)):
            flat = dm.reshape(b, -1)
            k = flat.argmax(dim=1)
            do = torch.gather(flat, 1, k[:, None])[:, 0] > 0
            hit_c = (cols == (k % c)[:, None]) & do[:, None]
            hit_r = (rows == torch.div(k, c, rounding_mode="floor")[:, None]) \
                & do[:, None]
            idx = torch.where(hit_c, torch.div(k, c, rounding_mode="floor")
                              [:, None], idx)
            dm.masked_fill_(hit_r[:, :, None] | hit_c[:, None, :], NEG)
    matched = idx >= 0
    zero = torch.zeros((), dtype=dist.dtype, device=dev)
    val = torch.where(matched, torch.gather(
        dist, 1, idx.clamp(min=0)[:, None, :])[:, 0], zero)
    if str(op.attr("match_type", "bipartite")) == "per_prediction":
        col_best = dist.argmax(dim=1)
        col_val = dist.amax(dim=1)
        fill = ~matched & (col_val >= float(op.attr("dist_threshold", 0.5)))
        idx = torch.where(fill, col_best, idx)
        val = torch.where(fill, col_val, val)
    ctx.set_out(op, "ColToRowMatchIndices", idx.to(torch.int32))
    ctx.set_out(op, "ColToRowMatchDist", val)


@register_lower("generate_proposals", "generate_proposals_v2")
def _generate_proposals(ctx, op):
    """RPN proposal generation (reference generate_proposals_op.cc): per
    image, the top ``pre_nms_topN`` anchor scores -> delta decode (the
    size deltas clipped at log(1000/16) before exp) -> clip -> min-size
    filter, before NMS -> greedy NMS -> ``post_nms_topN``, zero-padded.
    v1 takes ``ImInfo`` (h, w, scale) and compares the minimum size at
    the original scale; v2 takes ``ImShape`` and ``pixel_offset``."""
    scores = ctx.in1(op, "Scores")        # [B, A, H, W]
    deltas = ctx.in1(op, "BboxDeltas")    # [B, 4A, H, W]
    im_info = ctx.in1(op, "ImInfo")
    v1 = im_info is not None              # v1 carries (h, w, scale)
    if im_info is None:
        im_info = ctx.in1(op, "ImShape")  # v2: [B, 2] (h, w)
    anchors = ctx.in1(op, "Anchors").reshape(-1, 4)    # [H*W*A, 4]
    variances = ctx.in1(op, "Variances").reshape(-1, 4)
    pre_n = int(op.attr("pre_nms_topN", 6000))
    post_n = int(op.attr("post_nms_topN", 1000))
    min_size = float(op.attr("min_size", 0.1))
    pixel_offset = bool(op.attr("pixel_offset", True))
    off = 1.0 if pixel_offset else 0.0
    b, a, h, w = scores.shape
    n = a * h * w
    # reference layout: scores/deltas transposed to (H, W, A[, 4]) to
    # match the anchor tensor's flattening
    sc = scores.permute(0, 2, 3, 1).reshape(b, n)
    dl = deltas.reshape(b, a, 4, h, w).permute(0, 3, 4, 1, 2).reshape(b, n, 4)
    pre_k = min(pre_n, n) if pre_n > 0 else n
    top_s, order = _top_k(sc, pre_k)
    an = anchors[order]                   # [B, pre_k, 4]
    var = variances[order]
    d = _take_boxes(dl, order)
    aw = an[..., 2] - an[..., 0] + off
    ah = an[..., 3] - an[..., 1] + off
    acx = an[..., 0] + 0.5 * aw
    acy = an[..., 1] + 0.5 * ah
    clip = math.log(1000.0 / 16.0)
    cx = var[..., 0] * d[..., 0] * aw + acx
    cy = var[..., 1] * d[..., 1] * ah + acy
    pw = torch.exp(jmin(var[..., 2] * d[..., 2], clip)) * aw
    ph = torch.exp(jmin(var[..., 3] * d[..., 3], clip)) * ah
    ih, iw = im_info[:, 0:1], im_info[:, 1:2]
    props = torch.stack([
        jclip(cx - 0.5 * pw, 0, iw - off), jclip(cy - 0.5 * ph, 0, ih - off),
        jclip(cx + 0.5 * pw - off, 0, iw - off),
        jclip(cy + 0.5 * ph - off, 0, ih - off)], dim=-1)
    # reference FilterBoxes: min_size clamps to >= 1 and v1 compares
    # ORIGIN-scale extents ((x2-x1)/im_scale + 1) using im_info[2]
    ms = max(min_size, 1.0)
    if v1:
        scale = im_info[:, 2:3]
        bw = (props[..., 2] - props[..., 0]) / scale + 1.0
        bh = (props[..., 3] - props[..., 1]) / scale + 1.0
    else:
        bw = props[..., 2] - props[..., 0] + off
        bh = props[..., 3] - props[..., 1] + off
    neg = torch.full((), NEG, dtype=top_s.dtype, device=top_s.device)
    cand = torch.where((bw >= ms) & (bh >= ms), top_s, neg)
    keep = _greedy_nms_keep(props, cand > NEG / 2,
                            float(op.attr("nms_thresh", 0.5)),
                            float(op.attr("eta", 1.0)), not pixel_offset)
    fs, fi = _top_k(torch.where(keep, cand, neg), min(post_n, pre_k))
    ok = fs > NEG / 2
    zero = torch.zeros((), dtype=props.dtype, device=props.device)
    ctx.set_out(op, "RpnRois", torch.where(ok[..., None],
                                           _take_boxes(props, fi), zero))
    ctx.set_out(op, "RpnRoiProbs", torch.where(ok, fs, zero)[..., None])
    ctx.set_out(op, "RpnRoisNum", ok.sum(1).to(torch.int32))
