"""PyTorch port: the dense vision lowerings of ``ops/vision_ops.py``
(pixel and channel shuffles, ``temporal_shift``, ``affine_channel``,
``label_smooth``, ``lrn``, ``pad_constant_like``, ``crop`` /
``crop_tensor``, ``reverse``, ``unfold``, ``im2sequence``, ``cvm``), each
against the JAX lowering.  The 3-D conv and pools are in
``test_torch_vision_3d_ops.py``.

A one-op program and its gradient op through both packages' executors
on the CPU, every output and every input gradient compared
(``test_torch_lowerings.check_case``).

Tolerance: 1e-5 absolute plus 1e-5 relative
(``test_torch_lowerings.TOL``): float32 on both sides, differing in
summation order (``lrn``'s window, ``unfold``'s overlapping windows'
gradient) and in the last bits of ``pow`` and ``log1p`` on values of
order 1.  The shuffles, crops and flips are copies: equal.
"""
import numpy as np
import pytest

import test_torch_lowerings as tl
from paddle_tpu_torch.framework import executor as texecutor
from test_torch_lowerings import _case as case
from test_torch_lowerings import _f as randn
from test_torch_lowerings import check_case


def _cases():
    rs = np.random.RandomState(22)
    return {
        "pixel_shuffle": case("pixel_shuffle", dict(X=[randn(rs, 2, 8, 3, 4)]),
                              ["Out"], dict(upscale_factor=2)),
        "space_to_depth": case("space_to_depth",
                               dict(X=[randn(rs, 2, 3, 4, 6)]), ["Out"],
                               dict(blocksize=2)),
        "shuffle_channel": case("shuffle_channel",
                                dict(X=[randn(rs, 2, 6, 3, 3)]), ["Out"],
                                dict(group=3)),
        # 2 clips of 3 segments; a quarter of the channels each way
        "temporal_shift": case("temporal_shift",
                               dict(X=[randn(rs, 6, 8, 3, 3)]), ["Out"],
                               dict(seg_num=3, shift_ratio=0.25)),
        "affine_channel": case("affine_channel", dict(
            X=[randn(rs, 2, 3, 4, 5)], Scale=[randn(rs, 3)],
            Bias=[randn(rs, 3)]), ["Out"]),
        "affine_channel_nhwc": case("affine_channel", dict(
            X=[randn(rs, 2, 4, 5, 3)], Scale=[randn(rs, 3)],
            Bias=[randn(rs, 3)]), ["Out"], dict(data_layout="NHWC")),
        "label_smooth": case("label_smooth", dict(X=[rs.rand(4, 6).astype(
            "f4")]), ["Out"], dict(epsilon=0.1)),
        "label_smooth_prior": case("label_smooth", dict(
            X=[rs.rand(2, 3, 6).astype("f4")],
            PriorDist=[rs.rand(1, 6).astype("f4")]), ["Out"],
            dict(epsilon=0.2)),
        "lrn": case("lrn", dict(X=[randn(rs, 2, 7, 4, 5)]), ["Out", "MidOut"],
                    dict(n=5, alpha=1e-2, beta=0.75, k=2.0),
                    grad=["Out", "MidOut"]),
        "pad_constant_like": case("pad_constant_like", dict(
            X=[randn(rs, 4, 5, 3)], Y=[randn(rs, 2, 3, 3)]), ["Out"],
            dict(pad_value=1.5)),
        "crop": case("crop", dict(X=[randn(rs, 3, 4, 5)]), ["Out"],
                     dict(offsets=[1, 0, 2], shape=[2, -1, 3])),
        "crop_tensor_attrs": case("crop_tensor", dict(X=[randn(rs, 4, 6)]),
                                  ["Out"], dict(offsets=[2, 1],
                                                shape=[2, 4])),
        "reverse": case("reverse", dict(X=[randn(rs, 2, 3, 4)]), ["Out"],
                        dict(axis=[0, -1])),
        "unfold": case("unfold", dict(X=[randn(rs, 2, 3, 6, 7)]), ["Y"],
                       dict(kernel_sizes=[3, 2], strides=[2, 1],
                            paddings=[1, 0, 2, 1], dilations=[1, 2]),
                       grad=["Y"]),
        "unfold_two_paddings": case("unfold", dict(X=[randn(rs, 1, 2, 5, 5)]),
                                    ["Y"], dict(kernel_sizes=[2, 2],
                                                strides=[1, 1],
                                                paddings=[1, 1],
                                                dilations=[1, 1]),
                                    grad=["Y"]),
        "im2sequence": case("im2sequence", dict(X=[randn(rs, 2, 3, 5, 6)]),
                            ["Out"], dict(kernels=[2, 3], strides=[1, 2],
                                          paddings=[0, 1, 1, 0])),
        "cvm": case("cvm", dict(X=[np.concatenate([
            rs.rand(4, 2).astype("f4") * 3, randn(rs, 4, 5)], 1)]), ["Y"],
            dict(use_cvm=True), grad=["Y"]),
        "cvm_off": case("cvm", dict(X=[randn(rs, 4, 7)]), ["Y"],
                        dict(use_cvm=False), grad=["Y"]),
    }


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_vision_lowering_matches_jax(name):
    check_case(name, CASES[name])


def test_crop_tensor_offsets_tensor_is_read_on_the_host():
    """``Offsets`` as a tensor: the JAX lowering reads it with
    ``np.asarray``, which its traced executor cannot run, so the port's
    result is held to the JAX lowering given the same offsets as the
    attribute; the program keeps the port eager (``shape_tensor``)."""
    rs = np.random.RandomState(3)
    x = randn(rs, 3, 4, 5)
    want = check_case("crop_tensor_attr_form", case(
        "crop_tensor", dict(X=[x]), ["Out"],
        dict(offsets=[1, 0, 2], shape=[2, 3, -1])))
    c = case("crop_tensor", dict(X=[x], Offsets=[np.array([1, 0, 2],
                                                          "int32")]),
             ["Out"], dict(shape=[2, 3, -1]))
    prog, feed, fetch = tl._build("torch", c)
    assert texecutor.capture_reason(prog)[0] == "shape_tensor"
    got = tl._run("torch", prog, feed, fetch)[0]
    np.testing.assert_array_equal(got, want["out_out"][1])
    assert got.shape == (2, 3, 3)
