"""PyTorch port: the padded select and scatter family (``index_sample``,
``masked_select``, ``sequence_scatter`` of ``ops/tail_ops.py``;
``put_along_axis``, ``allclose``, ``histogram``, ``bincount`` of
``ops/misc_ops.py``), each against the JAX lowering.

A one-op program and its gradient op through both packages' executors
on the CPU, every output and every float input gradient compared
(``test_torch_lowerings.check_case``); each op's cases run in one test.
The edge cases are jax's index rules, which the port keeps on the device
(a bad index must never reach a torch gather or scatter, which asserts
on the card): ``take_along_axis`` wraps an index from -N and fills NaN
(an integer's minimum) outside [-N, N); a scatter (``.at[].add`` /
``.set`` / ``.multiply``) wraps a negative index once and drops the rest;
``jnp.bincount`` counts negatives in bin 0 and drops values past its
length; ``jnp.histogram`` puts a value on an inner edge in the upper bin,
the top edge in the last bin, and drops values outside the range.
Duplicates in the scatters add (or multiply); ``assign`` is tested with
distinct indices, since which duplicate wins is unspecified in both.
``mul`` is compared forward only: jax's ``.at[].multiply`` has no
gradient (``scatter_mul`` differentiates only with ``unique_indices``,
which ``.at`` never sets); the port's is ``scatter_reduce``'s.

Tolerance: 1e-5 absolute plus 1e-5 relative (``test_torch_lowerings.TOL``):
float32 on both sides; the gathers, counts and masks are equal.
"""
import numpy as np
import pytest

import test_torch_lowerings as tl
from paddle_tpu_torch.ops import misc_ops as tmisc
from test_torch_lowerings import _case as case
from test_torch_lowerings import _f as randn
from test_torch_lowerings import check_case


def _i64(*rows):
    return np.array(rows, "int64")


def _edges(lo, hi, bins):
    return tmisc._hist_edges(lo, hi, bins, "cpu").numpy()


def _on_edges(lo, hi, bins):
    """Every edge, the middle of every bin, and values outside."""
    e = _edges(lo, hi, bins)
    mid = (e[:-1] + e[1:]) / 2
    span = hi - lo
    return np.concatenate([e, mid, [lo - span, hi + span, np.nan]]).astype(
        "f4")


def _cases():
    rs = np.random.RandomState(233)
    mask = rs.rand(4, 5) < 0.4
    mask[0, 0] = True
    return {
        "index_sample": [
            case("index_sample", dict(
                X=[randn(rs, 3, 5)],
                Index=[_i64([0, 4, -1], [-5, 5, 2], [-6, 1, 1])]), ["Out"]),
            case("index_sample", dict(
                X=[rs.randint(-9, 9, (2, 3)).astype("int32")],
                Index=[_i64([0, 3], [-1, -4])]), ["Out"], grad=[])],
        "masked_select": [
            case("masked_select", dict(X=[randn(rs, 4, 5)], Mask=[mask]),
                 ["Y", "Count"], grad=["Y"]),
            case("masked_select", dict(X=[randn(rs, 6)],
                                       Mask=[np.zeros(6, bool)]),
                 ["Y", "Count"], grad=["Y"])],
        "sequence_scatter": [case("sequence_scatter", dict(
            X=[randn(rs, 6, 3)], Ids=[_i64([1], [5], [-1], [1], [7], [-7])],
            Updates=[randn(rs, 6, 3)]), ["Out"])],
        "put_along_axis": [
            case("put_along_axis", dict(
                Input=[randn(rs, 3, 4)], Index=[_i64([2, 0, 1], [3, -3, 0])],
                Value=[randn(rs, 2, 3)]), ["Result"],
                dict(Axis=1, Reduce="assign"), grad=["Result"]),
            case("put_along_axis", dict(
                Input=[randn(rs, 4, 3)], Index=[_i64([1, 1, 0], [1, 3, 0],
                                                     [5, -1, -9])],
                Value=[randn(rs, 3, 3)]), ["Result"],
                dict(Axis=0, Reduce="add"), grad=["Result"]),
            case("put_along_axis", dict(
                Input=[randn(rs, 4, 3)], Index=[_i64([1, 1, 0], [1, 3, 0],
                                                     [5, -1, 2])],
                Value=[randn(rs, 3, 3)]), ["Result"],
                dict(Axis=0, Reduce="mul"), grad=[]),
            case("put_along_axis", dict(
                Input=[randn(rs, 2, 5)], Index=[_i64([4], [-2])],
                Value=[np.array(1.5, "f4")]), ["Result"],
                dict(Axis=-1, Reduce="multiply"), grad=[])],
        "allclose": [
            case("allclose", dict(Input=[np.array([1.0, np.nan, 3.0], "f4")],
                                  Other=[np.array([1.0 + 1e-6, np.nan, 3.0],
                                                  "f4")]), ["Out"],
                 dict(equal_nan=eq), grad=[]) for eq in (True, False)] + [
            case("allclose", dict(Input=[np.array([1.0, 2.0], "f4")],
                                  Other=[np.array([1.001, 2.0], "f4")]),
                 ["Out"], dict(rtol=1e-2, atol=0.0), grad=[])],
        "histogram": [
            case("histogram", dict(X=[_on_edges(0.0, 1.0, 10)]), ["Out"],
                 dict(bins=10, min=0, max=1), grad=[]),
            case("histogram", dict(X=[_on_edges(-5.0, -2.0, 64).reshape(
                -1, 2)[:, :1]]), ["Out"], dict(bins=64, min=-5, max=-2),
                grad=[]),
            case("histogram", dict(X=[rs.randint(0, 12, (40,)).astype(
                "int64")]), ["Out"], dict(bins=5, min=1, max=11), grad=[]),
            # min == max widens the range by 0.5 each way
            case("histogram", dict(X=[np.array([2.0, 2.4, 2.5, 1.5, 1.4],
                                               "f4")]), ["Out"],
                 dict(bins=4, min=2, max=2), grad=[])],
        "bincount": [
            case("bincount", dict(X=[_i64(-2, 0, 1, 5, 7, 1, 3)]), ["Out"],
                 dict(minlength=6), grad=[]),
            case("bincount", dict(X=[_i64(-1, 0, 2, 2, 9, 4)],
                                  Weights=[randn(rs, 6)]), ["Out"],
                 dict(minlength=5))],
    }


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_select_lowering_matches_jax(name):
    for i, c in enumerate(CASES[name]):
        check_case(f"{name}_{i}", c)


def test_out_of_range_fill_and_drop():
    """The port's values at the bad indices: NaN and the int32 minimum
    from ``index_sample``; ``sequence_scatter`` keeps the dropped rows'
    X; ``bincount`` of [-2, 0, 1, 5, 7, 1, 3] over 6 bins."""
    out = tl._run("torch", *tl._build("torch", CASES["index_sample"][0]))[0]
    assert np.isnan(out[1, 1]) and np.isnan(out[2, 0])
    assert np.isnan(out).sum() == 2
    iout = tl._run("torch", *tl._build("torch", CASES["index_sample"][1]))[0]
    assert iout[0, 1] == iout[1, 1] == np.iinfo(np.int32).min
    counts = tl._run("torch", *tl._build("torch", CASES["bincount"][0]))[0]
    np.testing.assert_array_equal(counts, [2, 2, 0, 1, 0, 1])


def test_histogram_edges_are_jax_edges():
    """The port's float32 edges equal ``jnp.histogram``'s for the float
    ranges above (for [0, 1] in 10 bins the edge under 1 is
    0.90000004).  For [1, 11] in 5 bins XLA's CPU code fuses a product
    into the sum and one edge is a float32 step apart; the integer
    values there lie away from it."""
    import jax.numpy as jnp

    for lo, hi, bins in ((0.0, 1.0, 10), (-5.0, -2.0, 64)):
        want = np.asarray(jnp.histogram(jnp.zeros(1), bins=bins,
                                        range=(lo, hi))[1])
        np.testing.assert_array_equal(_edges(lo, hi, bins), want)
    assert _edges(0.0, 1.0, 10)[9] == np.float32(0.90000004)


@pytest.mark.parametrize("op_type,attrs,message", [
    ("histogram", dict(bins=4), "min/max"),
    ("bincount", dict(minlength=0), "minlength"),
])
def test_refusals_match_jax(op_type, attrs, message):
    c = case(op_type, dict(X=[np.array([1, 2], "int64")]), ["Out"], attrs,
             grad=[])
    for which in ("jax", "torch"):
        with pytest.raises(NotImplementedError, match=message):
            tl._run(which, *tl._build(which, c))
