"""PyTorch port: ``conv3d``, ``pool3d`` and the pools with index
(``max_pool2d_with_index``, ``max_pool3d_with_index``), each against the
JAX lowering.

A one-op program and its gradient op through both packages' executors
on the CPU, every output and every input gradient compared
(``test_torch_lowerings.check_case``).  Ties are built in: a window
whose maximum appears twice.  ``jnp.max`` (``max_pool2d_with_index``)
splits a tie's gradient evenly; ``reduce_window`` (``pool3d``) and the
strict ``>`` chain (``max_pool3d_with_index``) give it to the first
maximum, and the port matches each.  ``Mask`` is the first maximum's
flat index into the unpadded volume, int32, equal.

``max_pool2d_with_index`` with padding is held to ``F.max_pool2d``
instead: the JAX lowering's windows are a convolution with one-hot
filters, so the -inf padding times 0 makes every window that touches
the padding NaN (shown below).

Tolerance: 1e-5 absolute plus 1e-5 relative
(``test_torch_lowerings.TOL``): float32, the convolutions' sums in
another order; the pools' maxima and masks are equal.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import test_torch_lowerings as tl
from test_torch_lowerings import _case as case
from test_torch_lowerings import _f as randn
from test_torch_lowerings import check_case


def _tied(rs, *shape):
    """Values on a coarse grid: most windows hold a repeated maximum."""
    return (rs.randint(0, 4, shape) / 4.0).astype("f4")


def _cases():
    rs = np.random.RandomState(23)
    return {
        "conv3d": case("conv3d", dict(Input=[randn(rs, 2, 3, 4, 5, 6)],
                                      Filter=[randn(rs, 4, 3, 2, 3, 3)]),
                       ["Output"], dict(strides=[1, 2, 1], paddings=[1, 1, 0],
                                        dilations=[1, 1, 2]),
                       grad=["Output"]),
        "conv3d_same_groups": case(
            "conv3d", dict(Input=[randn(rs, 1, 4, 5, 6, 6)],
                           Filter=[randn(rs, 6, 2, 3, 3, 2)]), ["Output"],
            dict(strides=[2, 2, 2], groups=2, padding_algorithm="SAME"),
            grad=["Output"]),
        "conv3d_asymmetric": case(
            "conv3d", dict(Input=[randn(rs, 1, 2, 4, 4, 5)],
                           Filter=[randn(rs, 3, 2, 2, 2, 2)]), ["Output"],
            dict(paddings=[0, 1, 1, 0, 2, 1]), grad=["Output"]),
        "pool3d_max_ties": case("pool3d", dict(X=[_tied(rs, 2, 3, 4, 6, 6)]),
                                ["Out"], dict(pooling_type="max",
                                              ksize=[2, 2, 2],
                                              strides=[2, 2, 2])),
        "pool3d_max_padded": case("pool3d", dict(X=[randn(rs, 1, 2, 5, 5, 4)]),
                                  ["Out"], dict(pooling_type="max",
                                                ksize=[3, 3, 3],
                                                strides=[2, 2, 2],
                                                paddings=[1, 1, 1])),
        # the divisor counts only the cells inside the input
        "pool3d_avg_padded_edge": case(
            "pool3d", dict(X=[randn(rs, 2, 2, 5, 4, 5)]), ["Out"],
            dict(pooling_type="avg", ksize=[3, 3, 2], strides=[2, 1, 2],
                 paddings=[1, 1, 1])),
        "pool3d_avg_same": case("pool3d", dict(X=[randn(rs, 1, 2, 5, 5, 5)]),
                                ["Out"], dict(pooling_type="avg",
                                              ksize=[2, 2, 2],
                                              strides=[2, 2, 2],
                                              padding_algorithm="SAME")),
        "pool3d_global_max": case("pool3d", dict(X=[_tied(rs, 2, 3, 2, 3, 3)]),
                                  ["Out"], dict(pooling_type="max",
                                                global_pooling=True)),
        "pool3d_global_avg": case("pool3d", dict(X=[randn(rs, 2, 3, 2, 3, 3)]),
                                  ["Out"], dict(pooling_type="avg",
                                                global_pooling=True)),
        "max_pool2d_with_index_ties": case(
            "max_pool2d_with_index", dict(X=[_tied(rs, 2, 3, 6, 8)]),
            ["Out", "Mask"], dict(ksize=[2, 3], strides=[2, 2],
                                  paddings=[0, 0])),
        "max_pool2d_with_index_adaptive": case(
            "max_pool2d_with_index", dict(X=[_tied(rs, 2, 2, 7, 5)]),
            ["Out", "Mask"], dict(ksize=[3, 2], adaptive=True)),
        "max_pool2d_with_index_adaptive_divisible": case(
            "max_pool2d_with_index", dict(X=[randn(rs, 1, 2, 6, 4)]),
            ["Out", "Mask"], dict(ksize=[3, 2], adaptive=True)),
        "max_pool2d_with_index_global": case(
            "max_pool2d_with_index", dict(X=[_tied(rs, 2, 2, 3, 4)]),
            ["Out", "Mask"], dict(ksize=[1, 1], global_pooling=True)),
        "max_pool3d_with_index_ties": case(
            "max_pool3d_with_index", dict(X=[_tied(rs, 2, 2, 4, 4, 6)]),
            ["Out", "Mask"], dict(ksize=[2, 2, 3], strides=[2, 2, 3])),
        "max_pool3d_with_index_padded": case(
            "max_pool3d_with_index", dict(X=[randn(rs, 1, 2, 5, 4, 4)]),
            ["Out", "Mask"], dict(ksize=[3, 2, 2], strides=[2, 2, 2],
                                  paddings=[1, 1, 0])),
        "max_pool3d_with_index_adaptive": case(
            "max_pool3d_with_index", dict(X=[_tied(rs, 1, 2, 5, 4, 7)]),
            ["Out", "Mask"], dict(ksize=[2, 3, 3], adaptive=True)),
    }


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_3d_and_index_pool_lowering_matches_jax(name):
    pairs = check_case(name, CASES[name])
    if "Mask" in CASES[name]["outs"]:
        assert pairs["out_mask"][0].dtype == np.int32


def test_max_pool2d_with_index_padding_never_wins():
    """With padding, the port's Out and Mask are ``F.max_pool2d``'s (the
    padding never wins; the first maximum's flat index), while the JAX
    lowering gives NaN on every window that touches the padding."""
    rs = np.random.RandomState(5)
    x = randn(rs, 2, 3, 5, 6)
    c = case("max_pool2d_with_index", dict(X=[x]), ["Out", "Mask"],
             dict(ksize=[3, 3], strides=[2, 2], paddings=[1, 1]), grad=[])
    out, mask = tl._run("torch", *tl._build("torch", c))
    want, idx = F.max_pool2d(torch.from_numpy(x), 3, 2, 1,
                             return_indices=True)
    np.testing.assert_array_equal(out, want.numpy())
    np.testing.assert_array_equal(mask, idx.numpy())
    jout = np.asarray(tl._run("jax", *tl._build("jax", c))[0])
    assert np.isnan(jout[:, :, 0, 0]).all()
