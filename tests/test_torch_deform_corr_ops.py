"""PyTorch port: ``deformable_conv`` (v2, with ``Mask``),
``deformable_conv_v1`` and ``correlation``, each against the JAX
lowering.

A one-op program and its gradient op through both packages' executors
on the CPU, the output and the gradients of every input (Input, Offset,
Mask, Filter; both correlation inputs) compared
(``test_torch_lowerings.check_case``).  The offsets move taps out of the
image and into (-1, 0), where zeros padding keeps the in-range part.
``correlation``: a 1-pixel kernel and a 3 x 3 box filter, ``stride2``
2 (displacements multiples of 2), and an even kernel raising.

Tolerance: 1e-5 absolute plus 1e-5 relative
(``test_torch_lowerings.TOL``): float32, the bilinear taps' scatter-add
and the grouped product summed in another order.
"""
import numpy as np
import pytest

import test_torch_lowerings as tl
from test_torch_lowerings import _case as case
from test_torch_lowerings import _f as randn
from test_torch_lowerings import check_case

def _cases():
    rs = np.random.RandomState(28)
    x = randn(rs, 2, 4, 6, 7)
    conv = dict(strides=[1, 2], paddings=[1, 1], dilations=[1, 2],
                groups=2, deformable_groups=2)
    # output 6 x 3 for a 3 x 3 kernel at these strides / dilations
    off = (rs.randn(2, 2 * 2 * 9, 6, 3) * 1.5).astype("f4")
    return {
        "deformable_conv": case("deformable_conv", dict(
            Input=[x], Offset=[off],
            Mask=[rs.rand(2, 2 * 9, 6, 3).astype("f4")],
            Filter=[randn(rs, 6, 2, 3, 3)]), ["Output"], conv,
            grad=["Output"]),
        "deformable_conv_v1": case("deformable_conv_v1", dict(
            Input=[x], Offset=[(rs.randn(2, 2 * 4, 5, 6) * 0.7).astype("f4")],
            Filter=[randn(rs, 3, 4, 2, 2)]), ["Output"],
            dict(strides=[1, 1], paddings=[0, 0], dilations=[1, 1],
                 groups=1, deformable_groups=1), grad=["Output"]),
        "correlation": case("correlation", dict(
            Input1=[randn(rs, 2, 3, 9, 10)], Input2=[randn(rs, 2, 3, 9, 10)]),
            ["Output"], dict(pad_size=4, kernel_size=1, max_displacement=4,
                             stride1=1, stride2=2), grad=["Output"]),
        "correlation_kernel3": case("correlation", dict(
            Input1=[randn(rs, 1, 2, 8, 9)], Input2=[randn(rs, 1, 2, 8, 9)]),
            ["Output"], dict(pad_size=3, kernel_size=3, max_displacement=2,
                             stride1=2, stride2=1), grad=["Output"]),
    }


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_deform_corr_lowering_matches_jax(name):
    check_case(name, CASES[name])


def test_correlation_even_kernel_raises():
    c = case("correlation", dict(Input1=[np.zeros((1, 1, 5, 5), "f4")],
                                 Input2=[np.zeros((1, 1, 5, 5), "f4")]),
             ["Output"], dict(kernel_size=2, max_displacement=1), grad=[])
    with pytest.raises(NotImplementedError, match="odd"):
        tl._run("torch", *tl._build("torch", c))
