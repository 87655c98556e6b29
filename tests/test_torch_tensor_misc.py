"""PyTorch port: the tensor API's creation, linear algebra, logic,
search, statistics and random functions in dygraph, against the JAX
package's on the same seeded inputs (``torch_dygraph_parity``: floats
and gradients within 1e-5 of the JAX result's largest magnitude,
integers and booleans exactly).  Random draws come from other generators
than the JAX package's (threefry), so they are held to their
distributions' statistics instead: means and standard deviations within
5 standard errors, ranges and permutations exactly.
"""
import numpy as np
import pytest

from torch_dygraph_parity import (  # noqa: F401
    _jax_eager_keys_kept, J, T, check, same, to_numpy)

rs = np.random.RandomState(2)
X = rs.randn(3, 4).astype("f4")
Y = rs.randn(3, 4).astype("f4")
SQ = rs.randn(4, 4).astype("f4")


def _none(*_):
    return []


def test_creation_constants():
    for pkg in (J, T):
        pkg.seed(0)
    check(lambda: [J.full([2, 3], 1.5), J.zeros([2]), J.ones([1, 2],
                                                            "int32"),
                   J.eye(3), J.eye(2, 4), J.tensor.empty([2, 2]),
                   J.arange(5), J.arange(1, 7, 2), J.arange(0.0, 1.0, 0.25),
                   J.linspace(0, 1, 5)],
          lambda: [T.full([2, 3], 1.5), T.zeros([2]), T.ones([1, 2],
                                                            "int32"),
                   T.eye(3), T.eye(2, 4), T.tensor.empty([2, 2]),
                   T.arange(5), T.arange(1, 7, 2), T.arange(0.0, 1.0, 0.25),
                   T.linspace(0, 1, 5)])


def test_creation_like_assign_diag_tri_meshgrid():
    for name in ("zeros_like", "ones_like"):
        same(name, X, module="tensor")
    same("full_like", X, 2.5, module="tensor")
    same("assign", X, module="tensor")
    same("diag", X[0], module="tensor")
    same("diag", X[0], module="tensor", offset=1, padding_value=7.0)
    same("diag", SQ, module="tensor", offset=-1)
    same("tril", SQ, module="tensor")
    same("triu", SQ, 1, module="tensor")
    same("meshgrid", X[0], Y[1, :3], module="tensor")


def test_to_tensor_dtypes():
    ints = np.arange(6).reshape(2, 3)
    t = T.to_tensor(ints)
    assert t.dtype == T.Tensor(np.zeros(1, "int64"))._value.dtype  # 64-bit kept
    assert str(T.to_tensor(np.zeros(2)).dtype) == "torch.float32"
    assert str(T.to_tensor([1.0, 2.0], dtype="bfloat16").dtype) == \
        "torch.bfloat16"
    assert T.to_tensor(X).stop_gradient
    assert not T.to_tensor(X, stop_gradient=False).stop_gradient
    np.testing.assert_array_equal(T.to_tensor(ints).numpy(), ints)


def test_matmul_family():
    same("matmul", X, Y.T.copy(), module="tensor")
    same("matmul", X, X, module="tensor", transpose_y=True)
    same("matmul", X, X, module="tensor", transpose_x=True)
    b3 = rs.randn(2, 3, 4).astype("f4")
    same("matmul", b3, Y.T.copy(), module="tensor")
    same("bmm", b3, rs.randn(2, 4, 5).astype("f4"), module="tensor")
    same("mm", X, Y.T.copy(), module="tensor")
    same("dot", X[0], Y[0], module="tensor")
    same("dot", X, Y, module="tensor")
    check(lambda a, b: a @ b, lambda a, b: a @ b, X, Y.T.copy())


def test_norms_and_dist():
    same("norm", X, module="tensor")
    same("norm", X, module="tensor", p=2, axis=1)
    same("norm", X, module="tensor", p=1, axis=0, keepdim=True)
    same("norm", X, module="tensor", p="fro", axis=[0, 1])
    same("norm", X, module="tensor", p=np.inf, axis=1)
    same("dist", X, Y, module="tensor")


def test_cross_cholesky():
    same("cross", X[:, :3].copy(), Y[:, :3].copy(), module="tensor",
         axis=1)
    spd = SQ @ SQ.T + 4 * np.eye(4, dtype="f4")
    same("cholesky", spd, module="tensor", rtol=1e-4)
    same("cholesky", spd, module="tensor", upper=True, rtol=1e-4)


def test_logic():
    for name in ("equal", "not_equal", "less_than", "less_equal",
                 "greater_than", "greater_equal"):
        same(name, np.round(X), np.round(Y), module="tensor")
    a, b = X > 0, Y > 0
    for name in ("logical_and", "logical_or", "logical_xor"):
        same(name, a, b, module="tensor")
    same("logical_not", a, module="tensor")
    same("equal_all", X, X, module="tensor")
    same("allclose", X, X + 1e-9, module="tensor")
    assert J.tensor.is_empty(J.zeros([0, 2])) == \
        T.tensor.is_empty(T.zeros([0, 2]))
    check(lambda a, b: [a == b, a != b, a < b, a >= b],
          lambda a, b: [a == b, a != b, a < b, a >= b], X, Y)


def test_search_arg_and_sort():
    same("argmax", X, module="tensor")
    same("argmax", X, module="tensor", axis=1, keepdim=True)
    same("argmin", X, module="tensor", axis=0)
    same("argsort", X, module="tensor", axis=1)
    same("argsort", X, module="tensor", axis=0, descending=True)
    same("sort", X, module="tensor", axis=1)
    same("sort", X, module="tensor", axis=1, descending=True)


def test_search_topk_where_nonzero_masked_select():
    same("topk", X, 2, module="tensor")
    same("topk", X, 2, module="tensor", axis=0, largest=False)
    same("where", X > 0, X, Y, module="tensor")
    same("nonzero", X > 0, module="tensor")
    same("masked_select", X, X > 0, module="tensor")


def test_statistics():
    for name in ("mean", "var", "std"):
        same(name, X, module="tensor.stat")
        same(name, X, module="tensor.stat", axis=1, keepdim=True)
    same("var", X, module="tensor.stat", axis=0, unbiased=False)
    same("median", X, module="tensor.stat")
    same("median", X, module="tensor.stat", axis=1)
    assert J.numel(J.to_tensor(X)) == T.numel(T.to_tensor(X)) == 12


N = 20000


def _mean_std(t):
    a = to_numpy(t).astype(np.float64)
    return a.mean(), a.std()


@pytest.mark.parametrize("draw,mean,std", [
    (lambda p: p.uniform([N], min=-1.0, max=3.0), 1.0, 4 / np.sqrt(12)),
    (lambda p: p.rand([N]), 0.5, 1 / np.sqrt(12)),
    (lambda p: p.randn([N]), 0.0, 1.0),
    (lambda p: p.normal(2.0, 0.5, [N]), 2.0, 0.5),
], ids=["uniform", "rand", "randn", "normal"])
def test_random_statistics(draw, mean, std):
    T.seed(3)
    m, s = _mean_std(draw(T))
    jm, js = _mean_std(draw(J))
    se = std / np.sqrt(N)
    assert abs(m - mean) < 5 * se and abs(jm - mean) < 5 * se
    assert abs(s - std) < 5 * std / np.sqrt(2 * N) + 1e-3


def test_random_integers_and_multinomial():
    T.seed(4)
    r = to_numpy(T.randint(2, 9, [N]))
    assert r.min() == 2 and r.max() == 8
    assert abs(r.mean() - 5.0) < 5 * np.sqrt((49 - 1) / 12 / N)
    np.testing.assert_array_equal(np.sort(to_numpy(T.randperm(50))),
                                  np.arange(50))
    probs = np.array([[0.1, 0.2, 0.7], [0.5, 0.5, 0.0]], "f4")
    draws = to_numpy(T.multinomial(T.to_tensor(probs), 4000,
                                   replacement=True))
    for row, p in zip(draws, probs):
        share = np.bincount(row, minlength=3) / 4000.0
        assert np.all(np.abs(share - p) < 5 * np.sqrt(p * (1 - p) / 4000)
                      + 1e-9)
    once = to_numpy(T.multinomial(T.to_tensor(probs[:1]), 3))
    np.testing.assert_array_equal(np.sort(once[0]), [0, 1, 2])
    # one seed, one stream: the same draws again
    T.seed(4)
    np.testing.assert_array_equal(to_numpy(T.randint(2, 9, [N])), r)
