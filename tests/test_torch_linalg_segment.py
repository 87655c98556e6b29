"""PyTorch port: ``partial_sum``, ``partial_concat`` and ``segment_pool``
(the rest of the JAX package's ``ops/linalg_ops.py``), ``maximum`` /
``minimum`` (its ``math_ops.py``) and ``cholesky`` / ``inverse`` of a bad
matrix, each against the JAX lowering; and the executor's reason to run
a program holding ``inverse`` eagerly.

The check of ``test_torch_linalg_ops.py``
(``test_torch_lowerings.check_case``: every output and every input gradient, 1e-5 absolute plus 1e-5
relative, float32 on both sides).  The edge cases:

- ``segment_pool`` has N output segments for N rows.  The ids below
  leave segments empty: 0 under SUM and MEAN, -inf under MAX and +inf
  under MIN (``jax.ops.segment_max`` / ``segment_min``'s identities).
  A segment whose maximum is tied splits its gradient evenly between
  the tied rows in both packages.
- ``maximum`` / ``minimum`` at ties: each side takes half the gradient.
- ``cholesky`` of a batch holding a matrix that is not positive definite
  and one that is singular (positive semi-definite): their factors are
  NaN on and below the diagonal and 0 above it, their gradients NaN,
  the positive-definite matrix's factor finite.  ``inverse`` of a batch
  holding a singular matrix: that matrix's inverse is the LU solve's
  inf / NaN in both packages.  Its gradient is not finite in either but
  not compared: the product of infs gives +-inf in JAX's ``jax.vjp`` and
  NaN in torch's, by the order of the two products.  The comparison
  takes NaN as equal to NaN and an inf as equal only to the same inf.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as tpkg
from paddle_tpu_torch.framework import program as tprogram
from test_torch_lowerings import _case as case
from test_torch_lowerings import _f as randn
from test_torch_lowerings import check_case


def _segments(rs):
    x = randn(rs, 7, 3)
    x[2] = x[1]            # rows 1 and 2 share segment 0: a tie in each column
    seg = np.array([0, 0, 0, 2, 2, 5, 5], "int32")   # 1, 3, 4, 6 empty
    return x, seg


def _cases():
    rs = np.random.RandomState(0)
    x, seg = _segments(rs)
    pools = {f"segment_pool_{p.lower()}": case(
        "segment_pool", dict(X=[x], SegmentIds=[seg]), ["Out", "SummedIds"],
        dict(pooltype=p)) for p in ("SUM", "MEAN", "MAX", "MIN")}
    a = randn(rs, 3, 4)
    b = randn(rs, 3, 4)
    b[0, :2] = a[0, :2]    # ties
    singular = np.array([[1.0, 2.0], [2.0, 4.0]], "f4")
    not_pd = np.array([[1.0, 2.0], [2.0, 1.0]], "f4")
    spd = np.array([[2.0, 0.5], [0.5, 1.0]], "f4")
    return {
        **pools,
        "cholesky_not_pd": case("cholesky", dict(
            X=[np.stack([spd, not_pd, singular])]), ["Out"]),
        "inverse_singular": case("inverse", dict(
            Input=[np.stack([singular, spd])]), ["Output"], grad=()),
        "partial_sum": case("partial_sum", dict(
            X=[randn(rs, 3, 6) for _ in range(3)]), ["Out"],
            dict(start_index=1, length=3)),
        "partial_sum_to_end": case("partial_sum", dict(
            X=[randn(rs, 3, 6) for _ in range(2)]), ["Out"],
            dict(start_index=2, length=-1)),
        "partial_concat": case("partial_concat", dict(
            X=[randn(rs, 3, 6) for _ in range(3)]), ["Out"],
            dict(start_index=2, length=2)),
        "maximum_ties": case("maximum", dict(X=[a], Y=[b]), ["Out"]),
        "minimum_ties": case("minimum", dict(X=[a], Y=[b]), ["Out"]),
        "maximum_broadcast": case("maximum", dict(X=[randn(rs, 3, 4)],
                                                  Y=[randn(rs, 4)]), ["Out"]),
    }


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_segment_lowering_matches_jax(name):
    pairs = check_case(name, CASES[name])
    if name.startswith("segment_pool"):
        out = pairs["out_out"][0]
        empty = {"sum": 0.0, "mean": 0.0, "max": -np.inf, "min": np.inf}[
            name.rsplit("_", 1)[1]]
        assert (out[[1, 3, 4, 6]] == empty).all()
        np.testing.assert_array_equal(pairs["out_summedids"][0][:, 0],
                                      [3, 0, 2, 0, 0, 2, 0])
    if name == "cholesky_not_pd":
        out, g = pairs["out_out"][0], pairs["x_0@GRAD"][0]
        assert np.isfinite(out[0]).all() and np.isfinite(g[0]).all()
        for m in (1, 2):
            assert np.isnan(out[m][np.tril_indices(2)]).all()
            assert out[m][0, 1] == 0 and np.isnan(g[m]).all()
    if name == "inverse_singular":
        out = pairs["out_output"][0]
        assert not np.isfinite(out[0]).any() and np.isfinite(out[1]).all()
    if name == "segment_pool_max":
        g = pairs["x_0@GRAD"][0]
        np.testing.assert_array_equal(g[1], g[2])      # the tie, halved
    if name == "maximum_ties":
        gx, gy = pairs["x_0@GRAD"][0], pairs["y_0@GRAD"][0]
        np.testing.assert_array_equal(gx[0, :2], gy[0, :2])


def test_logsumexp_empty_axis_is_every_axis():
    """``axis=[]`` reduces over every axis, as ``reduce_all`` does (the
    JAX rule reaches that only through ``reduce_all``; its parity is
    ``logsumexp_reduce_all`` in ``test_torch_linalg_ops.py``)."""
    x = randn(np.random.RandomState(2), 2, 3, 4)
    prog = tprogram.Program()
    blk = prog.global_block
    blk.create_var(name="x", shape=x.shape, dtype="float32")
    blk.create_var(name="out")
    blk.append_op("logsumexp", {"X": ["x"]}, {"Out": ["out"]}, {"axis": []})
    got = tpkg.Executor(tpkg.CPUPlace()).run(
        prog, feed={"x": x}, fetch_list=["out"],
        scope=tpkg.framework.Scope())[0]
    want = torch.logsumexp(torch.from_numpy(x.astype("f8")).reshape(-1), 0)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-6)


def test_a_program_holding_inverse_runs_eagerly():
    """``inverse`` (and its gradient) run torch.linalg's batched LU, which
    synchronizes with the host inside the library on the card: a program
    holding it is not captured (kind ``host_sync``); ``cholesky`` is."""
    from paddle_tpu_torch.framework.executor import capture_reason

    def prog(op_type, slot, out):
        p = tprogram.Program()
        blk = p.global_block
        blk.create_var(name="a", shape=(2, 3, 3), dtype="float32")
        blk.create_var(name="b")
        blk.append_op(op_type, {slot: ["a"]}, {out: ["b"]}, {})
        return p

    kind, why = capture_reason(prog("inverse", "Input", "Output"))
    assert kind == "host_sync" and "'inverse'" in why
    assert capture_reason(prog("inverse_grad", "Input", "Input@GRAD"))[0] \
        == "host_sync"
    assert capture_reason(prog("cholesky", "X", "Out")) is None
