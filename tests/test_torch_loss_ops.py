"""PyTorch port: the loss lowerings of ``ops/loss_ops.py`` but ``warpctc``
(``test_torch_loss_ctc.py``), each against the JAX lowering.

A one-op program and its gradient op through both packages' executors
on the CPU, every output and every input gradient compared
(``test_torch_lowerings.check_case``), 1e-5 absolute plus 1e-5
relative: float32 on both sides, differing in summation order and in
the last bits of ``log`` / ``exp`` on values of order 1.  Cases cover each reduction
(``nll_loss`` with a class weight and an ignored row, ``kldiv_loss``
with zero targets), ``smooth_l1_loss`` with both weights on a 3-D input
(``Out`` still [N, 1]), ``margin_rank_loss``'s ``Activated`` and
``sigmoid_focal_loss``'s 1-based classes with background rows.
"""
import numpy as np
import pytest

from test_torch_lowerings import _case as case
from test_torch_lowerings import _f as randn
from test_torch_lowerings import check_case


def _prob(rs, *shape):
    return (rs.rand(*shape) * 0.9 + 0.05).astype("f4")


def _logp(rs, n, c):
    z = rs.randn(n, c)
    return (z - np.log(np.exp(z).sum(1, keepdims=True))).astype("f4")


def _cases():
    rs = np.random.RandomState(0)
    labels = np.array([2, 0, 4, 1, 3, 2], "int64")
    labels[3] = -100            # ignore_index: zero weight, zero gradient
    target = _prob(rs, 4, 5)
    target[1, 2] = target[3, 0] = 0.0      # no contribution, no log(0)
    nll = dict(X=[_logp(rs, 6, 5)], Label=[labels],
               Weight=[_prob(rs, 5) + 0.5])
    kl = dict(X=[_logp(rs, 4, 5)], Target=[target])
    binary = (rs.rand(5, 1) > 0.5).astype("f4")
    cases = {
        "bce_loss": case("bce_loss", dict(X=[_prob(rs, 4, 3)],
                                          Label=[(rs.rand(4, 3) > 0.5)
                                                 .astype("f4")]), ["Out"]),
        "log_loss": case("log_loss", dict(Predicted=[_prob(rs, 5, 1)],
                                          Labels=[binary]), ["Loss"],
                         dict(epsilon=1e-4), grad=["Loss"]),
        "hinge_loss": case("hinge_loss", dict(Logits=[randn(rs, 5, 1)],
                                              Labels=[binary]), ["Loss"],
                           grad=["Loss"]),
        "rank_loss": case("rank_loss", dict(
            Label=[binary], Left=[randn(rs, 5, 1)], Right=[randn(rs, 5, 1)]),
            ["Out"]),
        "margin_rank_loss": case("margin_rank_loss", dict(
            Label=[np.where(binary > 0, 1.0, -1.0).astype("f4")],
            X1=[randn(rs, 5, 1)], X2=[randn(rs, 5, 1)]),
            ["Out", "Activated"], dict(margin=0.1)),
        "smooth_l1_loss_weights": case("smooth_l1_loss", dict(
            X=[randn(rs, 3, 2, 4)], Y=[randn(rs, 3, 2, 4)],
            InsideWeight=[_prob(rs, 3, 2, 4) * 2],
            OutsideWeight=[_prob(rs, 3, 2, 4)]),
            ["Diff", "Out"], dict(sigma=2.0)),
        "smooth_l1_loss": case("smooth_l1_loss", dict(
            X=[randn(rs, 4, 3)], Y=[randn(rs, 4, 3)]), ["Diff", "Out"]),
        "sigmoid_focal_loss": case("sigmoid_focal_loss", dict(
            X=[randn(rs, 6, 4)],
            Label=[np.array([[0], [1], [4], [2], [0], [3]], "int32")],
            FgNum=[np.array([4], "int32")]), ["Out"],
            dict(gamma=2.0, alpha=0.25)),
        "bpr_loss": case("bpr_loss", dict(
            X=[randn(rs, 4, 5)],
            Label=[np.array([[1], [0], [4], [2]], "int64")]), ["Y"],
            grad=["Y"]),
        "l1_norm": case("l1_norm", dict(X=[randn(rs, 3, 4)]), ["Out"]),
    }
    for red in ("mean", "sum", "none"):
        cases[f"nll_loss_{red}"] = case(
            "nll_loss", nll, ["Out", "Total_weight"],
            dict(ignore_index=-100, reduction=red))
    for red in ("mean", "sum", "batchmean", "none"):
        cases[f"kldiv_loss_{red}"] = case(
            "kldiv_loss", kl, ["Loss"], dict(reduction=red), grad=["Loss"])
    return cases


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_lowering_matches_jax(name):
    pairs = check_case(name, CASES[name])
    if name == "nll_loss_none":
        assert pairs["out_out"][0][3] == 0          # the ignored row
        assert (pairs["x_0@GRAD"][0][3] == 0).all()
