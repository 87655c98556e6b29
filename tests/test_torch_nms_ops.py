"""PyTorch port: the NMS, matching and proposal lowerings of
``ops/nms_ops.py`` (``multiclass_nms``, ``multiclass_nms2`` / ``3``,
``matrix_nms``, ``bipartite_match``, ``generate_proposals`` and its
``_v2``), each against the JAX lowering.

A one-op program through both packages' executors on the CPU, every
output compared (``test_torch_lowerings.check_case``): the fixed-size
rows with their -1 / 0 padding, the kept indices and the counts
exactly, and where the case asks, the gradients of the scores and boxes
through the kept rows.  Scores sit on a coarse grid, so classes and
images hold tied scores: the lower index goes first, as ``lax.top_k``
orders them, in every top-k (per class, the cross-class merge, matrix
NMS, both of the proposals').  Also: adaptive ``nms_eta`` < 1, pixel
boxes (+1 extents), fewer survivors than ``keep_top_k`` and than
``post_nms_topN``, ``nms_top_k`` -1, a 2-D ``DistMat``, ``per_prediction``
matching, proposals v1 (``ImInfo`` with a scale) and v2 (``ImShape``,
``pixel_offset``).

Tolerance: 1e-5 absolute plus 1e-5 relative
(``test_torch_lowerings.TOL``): float32 on both sides; both compute
each IoU with the same operations in the same order, so the kept sets
agree exactly.
"""
import numpy as np
import pytest

import paddle_tpu_torch as tpkg
from paddle_tpu_torch.framework import executor as texecutor
from paddle_tpu_torch.ops import nms_ops
from test_torch_lowerings import _case as case
from test_torch_lowerings import check_case


def _boxes(rs, b, m, scale=1.0):
    # clusters of overlapping boxes, so suppression bites
    centers = rs.uniform(0.2, 0.8, (b, 3, 2))
    c = centers[:, rs.randint(0, 3, m)] + rs.normal(0, 0.05, (b, m, 2))
    wh = rs.uniform(0.1, 0.3, (b, m, 2))
    return (np.concatenate([c - wh / 2, c + wh / 2], -1) * scale).astype("f4")


def _scores(rs, *shape, levels=6):
    return (rs.randint(0, levels, shape) / levels).astype("f4")


def _anchors(h, w, sizes, stride=16.0):
    cy, cx = np.meshgrid(np.arange(h) * stride + 7.5,
                         np.arange(w) * stride + 7.5, indexing="ij")
    half = np.asarray(sizes, "f4") / 2
    a = np.stack([cx[..., None] - half, cy[..., None] - half,
                  cx[..., None] + half, cy[..., None] + half], -1)
    return a.astype("f4")  # [H, W, A, 4]


def _cases():
    rs = np.random.RandomState(27)
    boxes, scores = _boxes(rs, 2, 12), _scores(rs, 2, 3, 12)
    nms = dict(score_threshold=0.1, nms_top_k=8, keep_top_k=10,
               nms_threshold=0.4, background_label=0, normalized=True)
    h, w, sizes = 4, 5, (20.0, 40.0, 64.0)
    anchors = _anchors(h, w, sizes)
    rpn = dict(Scores=[_scores(rs, 2, 3, h, w, levels=10)],
               BboxDeltas=[(rs.randn(2, 12, h, w) * 0.3).astype("f4")],
               Anchors=[anchors],
               Variances=[np.full(anchors.shape, 1.0, "f4")])
    dist = (rs.randint(-2, 6, (2, 4, 6)) / 5).astype("f4")
    return {
        "multiclass_nms": case("multiclass_nms", dict(
            BBoxes=[boxes], Scores=[scores]), ["Out", "NmsRoisNum"], nms),
        "multiclass_nms2": case("multiclass_nms2", dict(
            BBoxes=[boxes], Scores=[scores]),
            ["Out", "Index", "NmsRoisNum"], dict(nms, nms_top_k=-1)),
        "multiclass_nms3_eta_pixels": case("multiclass_nms3", dict(
            BBoxes=[_boxes(rs, 2, 14, scale=60.0)],
            Scores=[_scores(rs, 2, 4, 14)]), ["Out", "Index", "NmsRoisNum"],
            dict(nms, normalized=False, nms_eta=0.8, nms_threshold=0.7,
                 background_label=-1, keep_top_k=-1)),
        # few survivors: most of the 10 rows are padding
        "multiclass_nms3_few": case("multiclass_nms3", dict(
            BBoxes=[boxes[:1]], Scores=[scores[:1]]),
            ["Out", "Index", "NmsRoisNum"],
            dict(nms, score_threshold=0.7, keep_top_k=10)),
        "multiclass_nms_2d": case("multiclass_nms3", dict(
            BBoxes=[boxes[0]], Scores=[scores[0]]),
            ["Out", "Index", "NmsRoisNum"], nms),
        "matrix_nms_linear": case("matrix_nms", dict(
            BBoxes=[boxes], Scores=[scores]), ["Out", "Index", "RoisNum"],
            dict(score_threshold=0.1, post_threshold=0.2, nms_top_k=8,
                 keep_top_k=10, background_label=0)),
        "matrix_nms_gaussian_all": case("matrix_nms", dict(
            BBoxes=[_boxes(rs, 2, 10, scale=50.0)],
            Scores=[_scores(rs, 2, 3, 10)]), ["Out", "Index", "RoisNum"],
            dict(score_threshold=0.05, post_threshold=0.1, nms_top_k=-1,
                 keep_top_k=-1, use_gaussian=True, gaussian_sigma=2.0,
                 background_label=-1, normalized=False)),
        "bipartite_match": case("bipartite_match", dict(DistMat=[dist]),
                                ["ColToRowMatchIndices", "ColToRowMatchDist"],
                                grad=["ColToRowMatchDist"]),
        "bipartite_match_per_prediction": case(
            "bipartite_match", dict(DistMat=[dist]),
            ["ColToRowMatchIndices", "ColToRowMatchDist"],
            dict(match_type="per_prediction", dist_threshold=0.5),
            grad=["ColToRowMatchDist"]),
        "bipartite_match_2d": case(
            "bipartite_match", dict(DistMat=[dist[0, :3, :5]]),
            ["ColToRowMatchIndices", "ColToRowMatchDist"],
            dict(match_type="per_prediction", dist_threshold=0.3),
            grad=["ColToRowMatchDist"]),
        "generate_proposals_v1": case("generate_proposals", dict(
            rpn, ImInfo=[np.array([[64.0, 80.0, 1.5], [60.0, 72.0, 1.0]],
                                  "f4")]),
            ["RpnRois", "RpnRoiProbs", "RpnRoisNum"],
            dict(pre_nms_topN=30, post_nms_topN=12, nms_thresh=0.5,
                 min_size=3.0), grad=["RpnRois", "RpnRoiProbs"]),
        # post_nms_topN past the survivors: zero rows, probability 0
        "generate_proposals_v2": case("generate_proposals_v2", dict(
            rpn, ImShape=[np.array([[64.0, 80.0], [60.0, 72.0]], "f4")]),
            ["RpnRois", "RpnRoiProbs", "RpnRoisNum"],
            dict(pre_nms_topN=40, post_nms_topN=100, nms_thresh=0.6,
                 min_size=8.0, eta=0.9, pixel_offset=False),
            grad=["RpnRois", "RpnRoiProbs"]),
    }


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_nms_lowering_matches_jax(name):
    pairs = check_case(name, CASES[name])
    for n in ("out_index", "out_nmsroisnum", "out_roisnum",
              "out_rpnroisnum", "out_coltorowmatchindices"):
        if n in pairs:
            assert pairs[n][0].dtype == np.int32, n
    counts = [pairs[n][0] for n in ("out_nmsroisnum", "out_roisnum",
                                    "out_rpnroisnum") if n in pairs]
    if counts and name.endswith("few"):
        assert counts[0].max() < 10       # padding rows present


@pytest.mark.parametrize("name", ["multiclass_nms2", "matrix_nms_linear",
                                  "generate_proposals_v1"])
def test_nms_in_iou_blocks_matches_jax(name, monkeypatch):
    """IoU matrices built a (image, class) row at a time (``IOU_CHUNK``
    made small), as the card's widths split them: the same results."""
    monkeypatch.setattr(nms_ops, "IOU_CHUNK", 64)
    check_case(name, CASES[name])


def test_nms_and_proposals_capture():
    """A program of ``multiclass_nms3`` and ``generate_proposals_v2``
    reads nothing on the host: ``capture_reason`` is None."""
    prog = tpkg.framework.Program()
    blk = prog.global_block
    for n in ("boxes", "scores", "s", "d", "a", "v", "shape", "out", "idx",
              "num", "rois", "probs", "rnum"):
        blk.create_var(name=n)
    blk.append_op("multiclass_nms3", {"BBoxes": ["boxes"],
                                      "Scores": ["scores"]},
                  {"Out": ["out"], "Index": ["idx"], "NmsRoisNum": ["num"]},
                  dict(keep_top_k=10))
    blk.append_op("generate_proposals_v2",
                  {"Scores": ["s"], "BboxDeltas": ["d"], "Anchors": ["a"],
                   "Variances": ["v"], "ImShape": ["shape"]},
                  {"RpnRois": ["rois"], "RpnRoiProbs": ["probs"],
                   "RpnRoisNum": ["rnum"]}, {})
    assert texecutor.capture_reason(prog) is None
