"""PyTorch port: the tensor API's math functions (``tensor/math.py``) in
dygraph, forward and gradient, against the JAX package's on the same
seeded inputs (``torch_dygraph_parity.check``: outputs and input
gradients within 1e-5 of the JAX result's largest magnitude, integers
and booleans exactly).  Each case is one family of functions.
"""
import numpy as np
import pytest

from torch_dygraph_parity import (  # noqa: F401
    _jax_eager_keys_kept, J, T, check, same)

rs = np.random.RandomState(0)
X = rs.randn(3, 4).astype("f4")
Y = rs.randn(3, 4).astype("f4")
POS = np.abs(X) + 0.5
UNIT = np.tanh(X) * 0.9
ROW = rs.randn(4).astype("f4")
INT = rs.randint(-5, 6, (3, 4)).astype("int32")
INT2 = rs.randint(1, 4, (3, 4)).astype("int32")

UNARY = [("exp", X), ("expm1", X), ("log", POS), ("log2", POS),
         ("log10", POS), ("log1p", POS), ("sqrt", POS), ("rsqrt", POS),
         ("abs", X), ("ceil", X), ("floor", X), ("round", X * 3),
         ("reciprocal", POS), ("sign", X), ("sin", X), ("sinh", X),
         ("asin", UNIT), ("asinh", X), ("cos", X), ("cosh", X),
         ("acos", UNIT), ("acosh", POS + 1), ("tan", UNIT), ("atan", X),
         ("atanh", UNIT), ("tanh", X), ("erf", X), ("square", X),
         ("neg", X)]


@pytest.mark.parametrize("part", range(3))
def test_unary(part):
    for name, x in UNARY[part::3]:
        same(name, x, module="tensor")


def test_binary_float_broadcast():
    for name in ("add", "subtract", "multiply", "divide", "maximum",
                 "minimum", "pow"):
        a, b = (POS, POS[0]) if name == "pow" else (X, ROW)
        same(name, a, b, module="tensor")
        same(name, a, a[::-1].copy() + 1.0, module="tensor")


def test_binary_integer_and_scalar_forms():
    for name in ("add", "subtract", "multiply", "remainder", "floor_divide",
                 "maximum", "minimum"):
        same(name, INT, INT2, module="tensor")
    for name in ("remainder", "floor_divide"):
        same(name, X * 4, POS, module="tensor")
    same("pow", POS, 3.0, module="tensor")
    same("pow", INT2, 2, module="tensor")
    # Tensor operators with python scalars take the tensor's dtype
    check(lambda x: [x + 2, 3 - x, x * 0.5, x / 4, -x, x ** 2],
          lambda x: [x + 2, 3 - x, x * 0.5, x / 4, -x, x ** 2], X)
    check(lambda x: [x % 3, x // 2], lambda x: [x % 3, x // 2], INT)


@pytest.mark.parametrize("name", ["sum", "mean", "max", "min", "prod"])
def test_reductions(name):
    for kw in ({}, {"axis": 1}, {"axis": [0, 1], "keepdim": True},
               {"axis": -1, "keepdim": True}):
        same(name, X, module="tensor", **kw)
    # the Tensor methods
    check(lambda x: getattr(x, name)(axis=0), lambda x: getattr(x, name)(
        axis=0), X)


def test_reductions_of_integers_and_bools():
    for name in ("sum", "max", "min", "prod"):
        same(name, INT, module="tensor", axis=0)
    same("mean", INT2.astype("f4"), module="tensor")
    for name in ("all", "any"):
        same(name, X > 0, module="tensor")
        same(name, X > 0, module="tensor", axis=1, keepdim=True)


def test_logsumexp_cumsum_trace_kron():
    for kw in ({}, {"axis": 1}, {"axis": [0, 1], "keepdim": True}):
        same("logsumexp", X, module="tensor", **kw)
    same("cumsum", X, module="tensor", axis=1)
    same("cumsum", X, module="tensor")
    same("cumsum", INT, module="tensor", axis=0)
    sq = rs.randn(4, 4).astype("f4")
    same("trace", sq, module="tensor")
    same("trace", sq, module="tensor", offset=1)
    same("kron", X[:2, :2], Y[:2, :3], module="tensor")


def test_scale_clip_stanh_increment_add_n():
    same("scale", X, module="tensor", scale=2.5, bias=1.0)
    same("scale", X, module="tensor", scale=2.5, bias=1.0,
         bias_after_scale=False)
    same("clip", X, module="tensor", min=-0.5, max=0.7)
    same("clip", X, module="tensor", min=-0.5)
    same("stanh", X, module="tensor.math")
    same("increment", X[:1, :1].reshape(1), module="tensor", value=2.0)
    check(lambda *xs: J.tensor.add_n(list(xs)),
          lambda *xs: T.tensor.add_n(list(xs)), X, Y, X * 2)


def test_cast_and_finiteness():
    odd = np.array([1.0, np.inf, -np.inf, np.nan, -2.5], "f4")
    for name in ("isnan", "isinf", "isfinite"):
        same(name, odd, module="tensor", grad=False)
    for dt in ("int32", "float32", "bool"):
        same("cast", X * 3, dt, module="tensor")
    check(lambda x: x.astype("int64"), lambda x: x.astype("int64"), X * 3)
