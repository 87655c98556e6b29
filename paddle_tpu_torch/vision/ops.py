"""``paddle.vision.ops`` functional namespace (reference
python/paddle/vision/ops.py): yolo_box, deform_conv2d, roi_align,
roi_pool over the op lowerings in ops/{detection,deformable,vision}_ops.

Counterpart of ``paddle_tpu/vision/ops.py``, over the port's
``dispatch.op_call``: eager tensors run the lowering now, graph
Variables append the op.
"""
from __future__ import annotations

from ..dispatch import op_call

__all__ = ["yolo_box", "deform_conv2d", "roi_align", "roi_pool"]


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, clip_bbox=True, name=None, scale_x_y=1.0):
    return op_call(
        "yolo_box", {"X": x, "ImgSize": img_size},
        {"anchors": [int(a) for a in anchors], "class_num": int(class_num),
         "conf_thresh": float(conf_thresh),
         "downsample_ratio": int(downsample_ratio),
         "clip_bbox": bool(clip_bbox), "scale_x_y": float(scale_x_y)},
        outs=("Boxes", "Scores"))


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """v1 (``deformable_conv_v1``) without a mask, v2 with one; the bias
    is added after the op."""
    def pair(v):
        return [v, v] if isinstance(v, int) else list(v)

    inputs = {"Input": x, "Offset": offset, "Filter": weight}
    op_type = "deformable_conv_v1"
    if mask is not None:
        inputs["Mask"] = mask
        op_type = "deformable_conv"
    out = op_call(
        op_type, inputs,
        {"strides": pair(stride), "paddings": pair(padding),
         "dilations": pair(dilation), "groups": int(groups),
         "deformable_groups": int(deformable_groups)},
        outs=("Output",))
    if bias is not None:
        from ..tensor.manipulation import reshape

        out = out + reshape(bias, [1, -1, 1, 1])
    return out


def _require_boxes_num(x, boxes_num, name):
    # the op-level fallback maps every roi to image 0 (fine for N==1);
    # for batched inputs that silent default would pool from the wrong
    # image — the reference requires boxes_num in dygraph, so do we
    if boxes_num is None and int(x.shape[0]) > 1:
        raise ValueError(
            f"{name} with a batched input (N={int(x.shape[0])}) requires "
            f"boxes_num to assign each roi to its image")


def _roi_inputs(x, boxes, boxes_num, output_size, name):
    _require_boxes_num(x, boxes_num, name)
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    inputs = {"X": x, "ROIs": boxes}
    if boxes_num is not None:
        inputs["RoisNum"] = boxes_num
    return inputs, {"pooled_height": int(output_size[0]),
                    "pooled_width": int(output_size[1])}


def roi_align(x, boxes, boxes_num=None, output_size=1, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    inputs, attrs = _roi_inputs(x, boxes, boxes_num, output_size,
                                "roi_align")
    return op_call(
        "roi_align", inputs,
        dict(attrs, spatial_scale=float(spatial_scale),
             sampling_ratio=int(sampling_ratio), aligned=bool(aligned)),
        outs=("Out",))


def roi_pool(x, boxes, boxes_num=None, output_size=1, spatial_scale=1.0,
             name=None):
    inputs, attrs = _roi_inputs(x, boxes, boxes_num, output_size,
                                "roi_pool")
    out, _argmax = op_call(
        "roi_pool", inputs, dict(attrs, spatial_scale=float(spatial_scale)),
        outs=("Out", "Argmax"))
    return out
