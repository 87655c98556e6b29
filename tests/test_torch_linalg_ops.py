"""PyTorch port: the linear-algebra lowerings (``cholesky`` to ``unbind``
of the JAX package's ``ops/linalg_ops.py``), each against the JAX
lowering.

A one-op program and its gradient op through both packages' executors
on the CPU, every output and every input gradient compared
(``test_torch_lowerings.check_case``).  The rest of that file's ops,
with ``maximum`` / ``minimum``, are in ``test_torch_linalg_segment.py``.

Tolerance: 1e-5 absolute plus 1e-5 relative
(``test_torch_lowerings.TOL``): float32 on both sides, differing in
summation order and in the last bits of transcendental functions on
values of order 1.  ``cholesky`` and
``inverse`` run LAPACK in both packages on a well-conditioned matrix
(A Aᵀ/n + I, eigenvalues in [1, 5]), whose factor and inverse are of
order 1, so the same bound holds.
"""
import numpy as np
import pytest

from test_torch_lowerings import _case as case
from test_torch_lowerings import _f as randn
from test_torch_lowerings import check_case

INT_MIN = -2147483648


def _spd(rs, n, batch=()):
    a = rs.randn(*batch, n, n).astype("f8")
    return (a @ np.swapaxes(a, -1, -2) / n + np.eye(n)).astype("f4")


def _cases():
    rs = np.random.RandomState(0)
    tie = np.array([[3.0, 1.0], [0.5, -3.0]], "f4")   # |x - 0|: 3 twice
    lo_tie = np.array([[0.5, 1.0], [-0.5, 2.0]], "f4")  # 0.5 twice
    x3 = randn(rs, 2, 3, 3)
    return {
        "cholesky": case("cholesky", dict(X=[_spd(rs, 5, (2,))]), ["Out"],
                         dict(upper=False)),
        "cholesky_upper": case("cholesky", dict(X=[_spd(rs, 4)]), ["Out"],
                               dict(upper=True)),
        "inverse": case("inverse", dict(Input=[_spd(rs, 4, (3,))]),
                        ["Output"], grad=["Output"]),
        "addmm": case("addmm", dict(Input=[randn(rs, 3, 5)],
                                    X=[randn(rs, 3, 4)], Y=[randn(rs, 4, 5)]),
                      ["Out"], dict(Alpha=0.5, Beta=2.0)),
        "mv": case("mv", dict(X=[randn(rs, 3, 4)], Vec=[randn(rs, 4)]),
                   ["Out"]),
        "kron": case("kron", dict(X=[randn(rs, 2, 3)], Y=[randn(rs, 3, 2)]),
                     ["Out"]),
        # INT_MIN: the first axis of extent 3 (axis 1 here, not 2)
        "cross_int_min": case("cross", dict(X=[x3], Y=[randn(rs, 2, 3, 3)]),
                              ["Out"], dict(dim=INT_MIN)),
        "cross_dim": case("cross", dict(X=[x3], Y=[randn(rs, 2, 3, 3)]),
                          ["Out"], dict(dim=2)),
        "dist_p2": case("dist", dict(X=[randn(rs, 3, 4)],
                                     Y=[randn(rs, 3, 4)]), ["Out"],
                        dict(p=2.0)),
        "dist_p3": case("dist", dict(X=[randn(rs, 3, 4)],
                                     Y=[randn(rs, 3, 4)]), ["Out"],
                        dict(p=3.0)),
        # a tie under +-inf: each tied element takes half the gradient
        "dist_inf_tie": case("dist", dict(X=[tie], Y=[np.zeros_like(tie)]),
                             ["Out"], dict(p=float("inf"))),
        "dist_neg_inf_tie": case("dist", dict(X=[lo_tie],
                                              Y=[np.zeros_like(lo_tie)]),
                                 ["Out"], dict(p=float("-inf"))),
        "dist_p0": case("dist", dict(X=[tie], Y=[np.array(
            [[3.0, 0.0], [0.5, 1.0]], "f4")]), ["Out"], dict(p=0.0)),
        "trace_offset": case("trace", dict(Input=[randn(rs, 2, 4, 5)]),
                             ["Out"], dict(offset=1, axis1=1, axis2=2)),
        # axis defaults to [0]
        "logsumexp_default": case("logsumexp", dict(X=[randn(rs, 3, 4)]),
                                  ["Out"]),
        "logsumexp_axes_keepdim": case(
            "logsumexp", dict(X=[randn(rs, 2, 3, 4)]), ["Out"],
            dict(axis=[1, 2], keepdim=True)),
        "logsumexp_reduce_all": case(
            "logsumexp", dict(X=[randn(rs, 2, 3, 4)]), ["Out"],
            dict(axis=[1], reduce_all=True)),
        "norm": case("norm", dict(X=[randn(rs, 3, 4, 5)]), ["Out", "Norm"],
                     dict(axis=1, epsilon=1e-10), grad=["Out", "Norm"]),
        "multiplex": case("multiplex", dict(
            X=[randn(rs, 4, 3) for _ in range(3)],
            Ids=[np.array([[2], [0], [1], [2]], "int32")]), ["Out"]),
        "unbind": case("unbind", dict(X=[randn(rs, 2, 3, 4)]),
                       [("Out", 3)], dict(axis=1)),
        "minus": case("minus", dict(X=[randn(rs, 3, 4)],
                                    Y=[randn(rs, 3, 4)]), ["Out"]),
    }


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_linalg_lowering_matches_jax(name):
    pairs = check_case(name, CASES[name])
    if name == "dist_inf_tie":
        g = pairs["x_0@GRAD"][0]
        assert g[0, 0] == -g[1, 1] != 0 and g[0, 1] == g[1, 0] == 0
