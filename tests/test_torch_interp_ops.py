"""PyTorch port: the ``*_interp`` / ``*_interp_v2`` lowerings against the
JAX lowerings (``ops/interp_ops.py``).

A one-op program and its gradient op through both packages' executors
on the CPU, ``Out`` and the gradient of ``X`` compared
(``test_torch_lowerings.check_case``).  Tolerance: 1e-5 absolute plus
1e-5 relative: both gather the same rows and blend them with the same
float32 weights (the bicubic's four Keys terms, a = -0.75), differing
only in the last bits of the weight polynomial.

Cases: each coordinate rule (``align_corners``; ``align_mode`` 0, the
half-pixel source clamped at 0 by the linear kernels and kept negative
by the bicubic, whose gathers clamp; ``align_mode`` 1, ratio * i;
nearest's floor(i * in / out)), up and down, each size source
(``out_*``, ``scale`` as a list and as a scalar), 1-D, 2-D and 3-D, and
NHWC / NDHWC layouts.  A dynamic ``OutSize`` raises in the port as in
the JAX package.
"""
import numpy as np
import pytest

import paddle_tpu_torch as tpkg
from paddle_tpu_torch.framework import program as tprogram
from test_torch_lowerings import _case as case
from test_torch_lowerings import _f as randn
from test_torch_lowerings import check_case


def _hw(h, w, **kw):
    return dict(out_h=h, out_w=w, **kw)


def _cases():
    rs = np.random.RandomState(0)
    x = randn(rs, 2, 3, 5, 7)
    nhwc = randn(rs, 2, 5, 7, 3)
    vol = randn(rs, 1, 2, 3, 4, 5)
    line = randn(rs, 2, 3, 6)

    def c(op, inp, **attrs):
        return case(op, dict(X=[inp]), ["Out"], attrs)

    return {
        "nearest_align_corners": c("nearest_interp", x,
                                   **_hw(9, 12, align_corners=True)),
        "nearest_v2_floor": c("nearest_interp_v2", x,
                              **_hw(12, 9, align_corners=False)),
        "nearest_v2_down_scale": c("nearest_interp_v2", x, scale=[0.6, 0.5],
                                   align_corners=False),
        "bilinear_align_corners": c("bilinear_interp", x,
                                    **_hw(9, 12, align_corners=True)),
        "bilinear_v2_half_pixel": c("bilinear_interp_v2", x, **_hw(
            11, 16, align_corners=False, align_mode=0)),
        "bilinear_v2_mode1": c("bilinear_interp_v2", x, **_hw(
            11, 16, align_corners=False, align_mode=1)),
        "bilinear_v2_down": c("bilinear_interp_v2", x, **_hw(
            3, 4, align_corners=False, align_mode=0)),
        "bilinear_v2_scale": c("bilinear_interp_v2", x, scale=2.0,
                               align_corners=False, align_mode=0),
        "bilinear_v2_nhwc": c("bilinear_interp_v2", nhwc, **_hw(
            8, 10, align_corners=False, align_mode=0, data_layout="NHWC")),
        "bicubic_v2_half_pixel": c("bicubic_interp_v2", x, **_hw(
            11, 16, align_corners=False)),
        "bicubic_align_corners": c("bicubic_interp", x,
                                   **_hw(9, 12, align_corners=True)),
        "bicubic_v2_down": c("bicubic_interp_v2", x, **_hw(
            3, 4, align_corners=False)),
        "trilinear_v2": c("trilinear_interp_v2", vol, out_d=5, **_hw(
            6, 9, align_corners=False, align_mode=0)),
        "trilinear_ndhwc": c("trilinear_interp", np.ascontiguousarray(
            vol.transpose(0, 2, 3, 4, 1)), out_d=6, **_hw(
            5, 7, align_corners=True, data_layout="NDHWC")),
        "linear_v2": c("linear_interp_v2", line, out_w=10,
                       align_corners=False, align_mode=0),
        "linear_align_corners": c("linear_interp", line, out_w=4,
                                  align_corners=True),
    }


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_interp_lowering_matches_jax(name):
    check_case(name, CASES[name])


def test_dynamic_out_size_raises():
    """A size given only as a tensor (``OutSize``) is refused, as in the
    JAX package: the program must carry the size as attributes."""
    prog = tprogram.Program()
    blk = prog.global_block
    blk.create_var(name="x", shape=(1, 1, 4, 4), dtype="float32")
    blk.create_var(name="size", shape=(2,), dtype="int32")
    blk.create_var(name="out")
    blk.append_op("bilinear_interp_v2", {"X": ["x"], "OutSize": ["size"]},
                  {"Out": ["out"]}, {"align_corners": False})
    with pytest.raises(NotImplementedError, match="OutSize"):
        tpkg.Executor(tpkg.CPUPlace()).run(
            prog, feed={"x": np.zeros((1, 1, 4, 4), "f4"),
                        "size": np.array([8, 8], "int32")},
            fetch_list=["out"], scope=tpkg.framework.Scope())
