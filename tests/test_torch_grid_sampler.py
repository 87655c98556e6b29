"""PyTorch port: ``grid_sampler`` against the JAX lowering, in every
mode: the three paddings (zeros, border, reflection) x both
``align_corners`` x bilinear and nearest.

The grid reaches past [-1, 1] on every side, so taps fall outside the
image, in (-1, 0) (zeros padding still takes their in-range part) and
across several reflections; a third of its entries sit on the half
pixel, where nearest rounds halves to even.  A one-op program and its
gradient op through both packages' executors on the CPU, the output and
the gradients of X and of the grid compared
(``test_torch_lowerings.check_case``).

Tolerance: 1e-5 absolute plus 1e-5 relative
(``test_torch_lowerings.TOL``): float32 on both sides, the four taps of
a sample summed in the same order.
"""
import itertools

import numpy as np
import pytest

from test_torch_lowerings import _case as case
from test_torch_lowerings import _f as randn
from test_torch_lowerings import check_case


def _grid(rs, n, ho, wo, h, w):
    g = rs.uniform(-2.6, 2.6, (n, ho, wo, 2)).astype("f4")
    # a third on the half pixel of the align_corners=False mapping
    half = np.stack([(2 * (rs.randint(-3, w + 3, (n, ho, wo)) + 0.5) + 1) / w
                     - 1, (2 * (rs.randint(-3, h + 3, (n, ho, wo)) + 0.5)
                           + 1) / h - 1], -1).astype("f4")
    pick = rs.rand(n, ho, wo, 1) < 1 / 3
    return np.where(pick, half, g).astype("f4")


def _cases():
    rs = np.random.RandomState(25)
    x = randn(rs, 2, 3, 5, 6)
    grid = _grid(rs, 2, 4, 7, 5, 6)
    return {f"{mode}_{pad}_{'ac' if ac else 'noac'}": case(
        "grid_sampler", dict(X=[x], Grid=[grid]), ["Output"],
        dict(mode=mode, padding_mode=pad, align_corners=ac),
        grad=["Output"])
        for mode, pad, ac in itertools.product(
            ("bilinear", "nearest"), ("zeros", "border", "reflection"),
            (True, False))}


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_grid_sampler_matches_jax(name):
    check_case(name, CASES[name])
