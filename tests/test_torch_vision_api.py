"""PyTorch port: ``vision.ops`` in dygraph, and YOLOv3's post-process as
a loaded program.

- ``yolo_box``, ``deform_conv2d`` (v1 without a mask, v2 with one, the
  bias added after), ``roi_align`` and ``roi_pool`` of
  ``paddle_tpu_torch.vision.ops`` against the JAX package's on the same
  numpy inputs: outputs and the float inputs' gradients
  (``torch_dygraph_parity.same``), and the error of a batched input
  without ``boxes_num``.
- The JAX package builds YOLOv3's post-process (three ``yolo_box``
  heads, ``concat``, ``transpose2``, ``multiclass_nms3``) with
  ``append_op`` at a small size and serializes it; the port parses the
  bytes with its own wire codec (``framework/ir_wire.py``), runs them on
  the CPU from a scope of the same values, and matches the JAX
  package's fetches.

Tolerance: 1e-5 of each output's largest magnitude
(``torch_dygraph_parity.RTOL``) in dygraph; 1e-5 absolute plus 1e-5
relative for the program's fetches (the detections' indices and counts
equal).  Float32 on both sides.
"""
import numpy as np
import pytest

import paddle_tpu as J
import paddle_tpu_torch as T
from paddle_tpu.framework import program as jprogram
from paddle_tpu_torch.framework import program as tprogram
from paddle_tpu_torch.framework.scope import scope_from_numpy
from torch_dygraph_parity import _jax_eager_keys_kept, same  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
ANCHORS = [[10, 13, 16, 30], [30, 61, 62, 45], [116, 90, 156, 198]]
ROIS = np.array([[1.0, 2.0, 9.5, 12.0], [0.0, 0.0, 19.0, 15.0],
                 [5.5, 3.0, 7.0, 4.5], [2.0, 6.0, 8.0, 14.0]], "f4")


def _f(rs, *shape):
    return rs.randn(*shape).astype("f4")


def test_yolo_box_matches_jax():
    rs = np.random.RandomState(30)
    same("yolo_box", _f(rs, 2, 2 * 8, 3, 4),
         np.array([[96, 128], [120, 90]], "int32"), module="vision.ops",
         anchors=ANCHORS[0], class_num=3, conf_thresh=0.4,
         downsample_ratio=32, clip_bbox=True, scale_x_y=1.05)


@pytest.mark.parametrize("with_mask", [False, True])
def test_deform_conv2d_matches_jax(with_mask):
    rs = np.random.RandomState(31)
    kwargs = dict(stride=1, padding=1, dilation=1, deformable_groups=1,
                  groups=1)
    args = [_f(rs, 2, 3, 5, 6), _f(rs, 2, 18, 5, 6), _f(rs, 4, 3, 3, 3),
            _f(rs, 4)]
    if with_mask:
        kwargs["mask"] = rs.rand(2, 9, 5, 6).astype("f4")
    same("deform_conv2d", *args, module="vision.ops", **kwargs)


def test_roi_align_matches_jax():
    rs = np.random.RandomState(32)
    same("roi_align", _f(rs, 2, 3, 8, 10), ROIS,
         np.array([1, 3], "int32"), module="vision.ops", output_size=(2, 3),
         spatial_scale=0.5, sampling_ratio=2, aligned=True)


def test_roi_pool_matches_jax():
    rs = np.random.RandomState(33)
    same("roi_pool", (rs.randint(0, 3, (2, 3, 8, 10)) / 2).astype("f4"),
         ROIS, np.array([2, 2], "int32"), module="vision.ops",
         output_size=2, spatial_scale=0.5)


@pytest.mark.parametrize("fn", ["roi_align", "roi_pool"])
def test_batched_input_requires_boxes_num(fn):
    x = np.zeros((2, 3, 8, 10), "f4")
    for pkg in (J, T):
        with pytest.raises(ValueError, match="requires boxes_num"):
            getattr(pkg.vision.ops, fn)(pkg.to_tensor(x),
                                        pkg.to_tensor(ROIS))
    one = T.vision.ops.roi_pool(T.to_tensor(x[:1]), T.to_tensor(ROIS))
    assert tuple(one.shape) == (4, 3, 1, 1)


def _yolo_values():
    rs = np.random.RandomState(34)
    values = {"img_size": np.array([[128, 160], [96, 128]], "int32")}
    for i, (h, w) in enumerate(((2, 3), (4, 5), (8, 10))):
        values[f"head{i}"] = _f(rs, 2, 2 * (5 + 4), h, w) * 2
    return values


def _yolo_program(values):
    """Three heads at strides 32, 16, 8 (2 anchors, 4 classes)."""
    prog = jprogram.Program()
    blk = prog.global_block
    for name, a in values.items():
        blk.create_var(name=name, shape=a.shape, dtype=a.dtype.name,
                       persistable=True)
    boxes, scores = [], []
    for i, down in enumerate((32, 16, 8)):
        for n in (f"boxes{i}", f"scores{i}"):
            blk.create_var(name=n)
        blk.append_op("yolo_box", {"X": [f"head{i}"],
                                   "ImgSize": ["img_size"]},
                      {"Boxes": [f"boxes{i}"], "Scores": [f"scores{i}"]},
                      dict(anchors=ANCHORS[2 - i], class_num=4,
                           conf_thresh=0.01, downsample_ratio=down,
                           clip_bbox=True))
        boxes.append(f"boxes{i}")
        scores.append(f"scores{i}")
    for n in ("all_boxes", "all_scores", "scores_t", "dets", "index", "num",
              "xshape"):
        blk.create_var(name=n)
    blk.append_op("concat", {"X": boxes}, {"Out": ["all_boxes"]}, {"axis": 1})
    blk.append_op("concat", {"X": scores}, {"Out": ["all_scores"]},
                  {"axis": 1})
    blk.append_op("transpose2", {"X": ["all_scores"]},
                  {"Out": ["scores_t"], "XShape": ["xshape"]},
                  {"axis": [0, 2, 1]})
    blk.append_op("multiclass_nms3",
                  {"BBoxes": ["all_boxes"], "Scores": ["scores_t"]},
                  {"Out": ["dets"], "Index": ["index"],
                   "NmsRoisNum": ["num"]},
                  dict(score_threshold=0.05, nms_top_k=40, keep_top_k=20,
                       nms_threshold=0.45, background_label=-1,
                       normalized=False))
    return prog


def test_loaded_yolov3_post_process_matches_jax():
    values = _yolo_values()
    fetch = ["all_boxes", "dets", "index", "num"]
    data = _yolo_program(values).serialize_to_string()
    jscope = J.framework.Scope()
    for name, a in values.items():
        jscope.set_var(name, a)
    want = J.Executor(J.CPUPlace()).run(
        J.framework.Program.parse_from_string(data), feed={},
        fetch_list=fetch, scope=jscope)
    tprog = tprogram.Program.parse_from_string(data)
    assert [op.type for op in tprog.global_block.ops] == \
        ["yolo_box"] * 3 + ["concat", "concat", "transpose2",
                            "multiclass_nms3"]
    got = T.Executor(T.CPUPlace()).run(
        tprog, feed={}, fetch_list=fetch,
        scope=scope_from_numpy(values, device="cpu"))
    for name, g, w in zip(fetch, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (name, g.shape, w.shape)
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)
    num = np.asarray(got[3])
    assert num.dtype == np.int32 and 0 < num.min() and num.max() <= 20
