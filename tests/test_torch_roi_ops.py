"""PyTorch port: the RoI lowerings (``roi_align``, ``roi_pool``,
``psroi_pool``, ``prroi_pool``), each against the JAX lowering.

A one-op program and its gradient op through both packages' executors
on the CPU, every output and every input gradient (the image's and the
RoIs') compared (``test_torch_lowerings.check_case``).

- ``RoisNum`` that sums to the RoI count, to less (the rest go to the
  last image) and to more (the list is cut), as
  ``jnp.repeat(..., total_repeat_length=R)`` assigns them;
- RoIs partly outside the image, and ``roi_align`` both ``aligned``
  and not, with ``sampling_ratio`` given and adaptive (2 a side);
- ``roi_pool`` on a coarse grid of values, so bins hold tied maxima:
  each takes an even share of the gradient, as ``jnp.max`` gives it;
  ``Argmax`` is int32 zeros, as in the JAX package;
- ``psroi_pool`` rounding its corners half away from zero, and its
  channel check; ``prroi_pool`` with ``BatchRoINums``;
- the same ops a chunk of RoIs at a time (``CHUNK_ELEMS`` made small).

Tolerance: 1e-5 absolute plus 1e-5 relative
(``test_torch_lowerings.TOL``): float32, the bilinear taps summed in
another order (the port's weights are separable matrices); maxima and
masks are equal.
"""
import numpy as np
import pytest

import test_torch_lowerings as tl
from paddle_tpu_torch.ops import vision_ops
from test_torch_lowerings import _case as case
from test_torch_lowerings import _f as randn
from test_torch_lowerings import check_case

ROIS = np.array([[1.0, 2.0, 9.5, 12.0], [0.0, 0.0, 19.0, 15.0],
                 [5.5, 3.0, 7.0, 4.5], [-3.0, 6.0, 8.0, 22.0],
                 [12.0, 1.0, 24.0, 9.0]], "f4")


def _tied(rs, *shape):
    return (rs.randint(0, 3, shape) / 2.0).astype("f4")


def _cases():
    rs = np.random.RandomState(24)
    x = randn(rs, 2, 3, 8, 10)
    align = dict(pooled_height=2, pooled_width=3, spatial_scale=0.5)
    counts = {"": [2, 3], "_counts_short": [1, 2], "_counts_long": [4, 3]}
    cases = {}
    for tag, cnt in counts.items():
        cases["roi_align" + tag] = case(
            "roi_align", dict(X=[x], ROIs=[ROIS],
                              RoisNum=[np.array(cnt, "int32")]), ["Out"],
            dict(align, sampling_ratio=2, aligned=True))
        cases["roi_pool" + tag] = case(
            "roi_pool", dict(X=[_tied(rs, 2, 3, 8, 10)], ROIs=[ROIS],
                             RoisNum=[np.array(cnt, "int32")]),
            ["Out", "Argmax"], dict(pooled_height=3, pooled_width=2,
                                    spatial_scale=0.5))
    cases.update({
        "roi_align_not_aligned_adaptive": case(
            "roi_align", dict(X=[x], ROIs=[ROIS],
                              RoisNum=[np.array([3, 2], "int64")]), ["Out"],
            dict(align, sampling_ratio=-1, aligned=False)),
        "roi_align_one_image": case(
            "roi_align", dict(X=[x[:1]], ROIs=[ROIS[:3]]), ["Out"],
            dict(align, sampling_ratio=3, aligned=False)),
        "roi_pool_one_image_ties": case(
            "roi_pool", dict(X=[np.zeros((1, 2, 6, 7), "f4")],
                             ROIs=[ROIS[:3] / 2]), ["Out", "Argmax"],
            dict(pooled_height=2, pooled_width=2, spatial_scale=1.0)),
        "psroi_pool": case(
            "psroi_pool", dict(X=[randn(rs, 2, 8, 8, 10)],
                               ROIs=[ROIS + 0.5],
                               RoisNum=[np.array([2, 3], "int32")]), ["Out"],
            dict(output_channels=2, pooled_height=2, pooled_width=2,
                 spatial_scale=0.5)),
        "prroi_pool": case(
            "prroi_pool", dict(X=[x], ROIs=[ROIS],
                               BatchRoINums=[np.array([3, 2], "int32")]),
            ["Out"], dict(pooled_height=2, pooled_width=2,
                          spatial_scale=0.5)),
    })
    return cases


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_roi_lowering_matches_jax(name):
    pairs = check_case(name, CASES[name])
    if "Argmax" in CASES[name]["outs"]:
        got = pairs["out_argmax"][0]
        assert got.dtype == np.int32 and not got.any()


@pytest.mark.parametrize("name", ["roi_align_counts_short", "roi_pool",
                                  "psroi_pool", "prroi_pool"])
def test_roi_lowering_in_chunks_matches_jax(name, monkeypatch):
    """A chunk of one or two RoIs at a time (``CHUNK_ELEMS``), as the
    card's widths split them: the same results."""
    monkeypatch.setattr(vision_ops, "CHUNK_ELEMS", 2 * 8 * 10 * 3 * 2)
    check_case(name, CASES[name])


def test_psroi_pool_channel_check_raises():
    c = case("psroi_pool", dict(X=[np.zeros((1, 7, 4, 4), "f4")],
                                ROIs=[ROIS[:1]]), ["Out"],
             dict(output_channels=2, pooled_height=2, pooled_width=2),
             grad=[])
    with pytest.raises(ValueError, match="output_channels"):
        tl._run("torch", *tl._build("torch", c))
