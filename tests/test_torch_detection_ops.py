"""PyTorch port: the dense detection lowerings of
``ops/detection_ops.py`` (``prior_box``, ``anchor_generator``,
``iou_similarity``, ``box_coder``, ``yolo_box``, ``box_clip``), each
against the JAX lowering.

A one-op program and its gradient op through both packages' executors
on the CPU, every output and every input gradient compared
(``test_torch_lowerings.check_case``).  ``box_coder`` takes its variance
as a tensor, as the attribute and as neither, decodes along axis 0 and
1, and runs unnormalized (+1 extents); ``yolo_box`` takes an int
``ImgSize``, zeroes what falls under ``conf_thresh`` and shifts by
``scale_x_y``; ``box_clip`` rounds h / scale half to even, and its flat
form with several images raises.

Tolerance: 1e-5 absolute plus 1e-5 relative
(``test_torch_lowerings.TOL``): float32 on both sides, the last bits of
``exp``, ``log`` and the sigmoid on values of order 1, where boxes in
pixels (up to 1e2) keep the relative bound.
"""
import numpy as np
import pytest

import test_torch_lowerings as tl
from test_torch_lowerings import _case as case
from test_torch_lowerings import _f as randn
from test_torch_lowerings import check_case


def _boxes(rs, n, lo=0.0, hi=1.0):
    xy = rs.uniform(lo, hi * 0.7, (n, 2))
    wh = rs.uniform(hi * 0.05, hi * 0.3, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype("f4")


def _cases():
    rs = np.random.RandomState(26)
    feat, image = np.zeros((1, 2, 3, 4), "f4"), np.zeros((1, 3, 30, 40), "f4")
    priors = _boxes(rs, 6)
    yolo_x = randn(rs, 2, 2 * (5 + 3), 3, 4)
    img_size = np.array([[96, 128], [120, 90]], "int32")
    yolo = dict(anchors=[10, 13, 16, 30], class_num=3, conf_thresh=0.5,
                downsample_ratio=32)
    return {
        "prior_box": case("prior_box", dict(Input=[feat], Image=[image]),
                          ["Boxes", "Variances"],
                          dict(min_sizes=[4.0, 9.0], max_sizes=[8.0, 15.0],
                               aspect_ratios=[2.0, 3.0], flip=True,
                               clip=True, offset=0.5), grad=[]),
        "prior_box_min_max_order": case(
            "prior_box", dict(Input=[feat], Image=[image]),
            ["Boxes", "Variances"],
            dict(min_sizes=[6.0], max_sizes=[12.0], aspect_ratios=[2.0],
                 flip=False, clip=False, step_w=8.0, step_h=9.0,
                 min_max_aspect_ratios_order=True,
                 variances=[0.1, 0.1, 0.2, 0.3]), grad=[]),
        "anchor_generator": case(
            "anchor_generator", dict(Input=[feat]), ["Anchors", "Variances"],
            dict(anchor_sizes=[32.0, 64.0], aspect_ratios=[0.5, 1.0, 2.0],
                 stride=[16.0, 16.0], offset=0.5), grad=[]),
        "iou_similarity": case("iou_similarity", dict(
            X=[_boxes(rs, 5)], Y=[_boxes(rs, 4)]), ["Out"]),
        "iou_similarity_pixels": case("iou_similarity", dict(
            X=[_boxes(rs, 3, hi=50)], Y=[_boxes(rs, 6, hi=50)]), ["Out"],
            dict(box_normalized=False)),
        "box_coder_encode": case("box_coder", dict(
            PriorBox=[priors], PriorBoxVar=[rs.uniform(0.1, 0.3, (6, 4))
                                            .astype("f4")],
            TargetBox=[_boxes(rs, 3)]), ["OutputBox"],
            dict(code_type="encode_center_size"), grad=["OutputBox"]),
        "box_coder_decode_axis0": case("box_coder", dict(
            PriorBox=[priors], TargetBox=[randn(rs, 2, 6, 4) * 0.5]),
            ["OutputBox"], dict(code_type="decode_center_size",
                                variance=[0.1, 0.1, 0.2, 0.2]),
            grad=["OutputBox"]),
        "box_coder_decode_axis1": case("box_coder", dict(
            PriorBox=[_boxes(rs, 2, hi=40)],
            PriorBoxVar=[rs.uniform(0.1, 0.3, (2, 4)).astype("f4")],
            TargetBox=[randn(rs, 2, 5, 4) * 0.5]), ["OutputBox"],
            dict(code_type="decode_center_size", axis=1,
                 box_normalized=False), grad=["OutputBox"]),
        "box_coder_encode_no_variance": case("box_coder", dict(
            PriorBox=[_boxes(rs, 4, hi=40)], TargetBox=[_boxes(rs, 3, hi=40)]),
            ["OutputBox"], dict(code_type="encode_center_size",
                                box_normalized=False),
            grad=["OutputBox"]),
        "yolo_box": case("yolo_box", dict(X=[yolo_x], ImgSize=[img_size]),
                         ["Boxes", "Scores"], dict(yolo, clip_bbox=True),
                         grad=["Boxes", "Scores"]),
        "yolo_box_scale_x_y": case(
            "yolo_box", dict(X=[yolo_x], ImgSize=[img_size]),
            ["Boxes", "Scores"], dict(yolo, clip_bbox=False, scale_x_y=1.05,
                                      conf_thresh=0.3),
            grad=["Boxes", "Scores"]),
        "box_clip": case("box_clip", dict(
            Input=[_boxes(rs, 6, lo=-20, hi=90).reshape(2, 3, 4)],
            ImInfo=[np.array([[50.0, 60.0, 2.0], [61.0, 45.0, 0.8]], "f4")]),
            ["Output"], grad=["Output"]),
        # h / scale = 12.5: rounds to even (12), then - 1
        "box_clip_flat_half_even": case("box_clip", dict(
            Input=[_boxes(rs, 5, lo=-4, hi=20)],
            ImInfo=[np.array([[25.0, 27.0, 2.0]], "f4")]), ["Output"],
            grad=["Output"]),
    }


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_detection_lowering_matches_jax(name):
    check_case(name, CASES[name])


def test_box_clip_flat_with_several_images_raises():
    c = case("box_clip", dict(Input=[np.zeros((3, 4), "f4")],
                              ImInfo=[np.ones((2, 3), "f4")]), ["Output"],
             grad=[])
    with pytest.raises(NotImplementedError, match="LoD"):
        tl._run("torch", *tl._build("torch", c))
