"""PyTorch port: the tensor API's manipulation functions
(``tensor/manipulation.py``) in dygraph, forward and gradient, against
the JAX package's on the same seeded inputs (``torch_dygraph_parity``:
floats within 1e-5 of the JAX result's largest magnitude, integers
exactly).  Each case is one family of functions.
"""
import numpy as np

from torch_dygraph_parity import (  # noqa: F401
    _jax_eager_keys_kept, J, T, check, same)

rs = np.random.RandomState(1)
X = rs.randn(2, 3, 4).astype("f4")
M = rs.randn(4, 5).astype("f4")


def test_reshape_transpose_t_flatten():
    same("reshape", X, [3, -1], module="tensor")
    same("reshape", X, [0, 12], module="tensor")
    same("transpose", X, [2, 0, 1], module="tensor")
    same("t", M, module="tensor")
    same("flatten", X, module="tensor")
    same("flatten", X, module="tensor", start_axis=1)
    same("flatten", X, module="tensor", start_axis=0, stop_axis=1)
    check(lambda x: [x.reshape([4, 6]), x.transpose([1, 0, 2])],
          lambda x: [x.reshape([4, 6]), x.transpose([1, 0, 2])], X)


def test_squeeze_unsqueeze():
    a = X[:, :1, :, None]
    same("squeeze", a, module="tensor")
    same("squeeze", a, module="tensor", axis=1)
    same("squeeze", a, module="tensor", axis=[1, -1])
    same("unsqueeze", X, 0, module="tensor")
    same("unsqueeze", X, [0, -1], module="tensor")


def test_concat_stack_unstack():
    check(lambda a, b: J.concat([a, b], axis=1),
          lambda a, b: T.concat([a, b], axis=1), X, X * 2)
    check(lambda a, b: J.stack([a, b], axis=-1),
          lambda a, b: T.stack([a, b], axis=-1), X, X + 1)
    same("unstack", X, module="tensor", axis=1)


def test_split_chunk():
    same("split", X, 2, module="tensor", axis=2)
    same("split", X, [1, -1, 1], module="tensor", axis=1)
    same("split", X, [3, 1], module="tensor", axis=-1)
    same("chunk", X, 3, module="tensor", axis=1)


def test_tile_expand_broadcast():
    same("tile", X[:, :1], [1, 2, 1], module="tensor")
    same("tile", M, [2, 3], module="tensor")
    same("expand", X[:, :1], [2, 3, 4], module="tensor")
    same("expand", M[:1], [3, 4, 5], module="tensor")
    same("broadcast_to", M[:1], [4, 5], module="tensor")
    check(lambda a, b: J.expand_as(a, b), lambda a, b: T.expand_as(a, b),
          X[:1], X)


def test_flip_roll():
    same("flip", X, [0, 2], module="tensor")
    same("roll", X, 2, module="tensor", axis=1)
    same("roll", X, [1, -1], module="tensor", axis=[0, 2])
    same("roll", X, 5, module="tensor")


def test_gather_index_select_take_along_axis():
    idx = np.array([2, 0, 1, 2], "int64")
    same("gather", M, idx, module="tensor")
    same("gather", M, idx, module="tensor", axis=1)
    same("index_select", M, idx, module="tensor", axis=1)
    nd = np.array([[0, 1], [3, 4], [2, 2]], "int64")
    same("gather_nd", M, nd, module="tensor")
    along = rs.randint(0, 5, (4, 2)).astype("int64")
    same("take_along_axis", M, along, 1, module="tensor")
    same("index_sample", M, along, module="tensor.search")


def test_scatter():
    idx = np.array([3, 1], "int64")
    upd = rs.randn(2, 5).astype("f4")
    same("scatter", M, idx, upd, module="tensor")
    same("scatter", M, np.array([1, 1, 2], "int64"),
         rs.randn(3, 5).astype("f4"), module="tensor", overwrite=False)
    nd = np.array([[0, 1], [3, 4], [0, 1]], "int64")
    same("scatter_nd_add", M, nd, rs.randn(3).astype("f4"),
         module="tensor")


def test_slice_strided_slice_getitem():
    same("slice", X, [1, 2], [0, 1], [2, 3], module="tensor")
    same("slice", X, [2], [-3], [100], module="tensor")
    same("strided_slice", X, [1, 2], [0, 3], [3, 0], [2, -1],
         module="tensor.manipulation")
    check(lambda x: [x[0], x[:, 1:], x[..., ::2], x[1, :, -1]],
          lambda x: [x[0], x[:, 1:], x[..., ::2], x[1, :, -1]], X)
    check(lambda x: list(iter(x)), lambda x: list(iter(x)), M)


def test_shard_index_and_empty_like():
    ids = np.array([[1], [6], [11], [14]], "int64")
    same("shard_index", ids, 16, 4, 1, module="tensor.manipulation")
    same("shard_index", ids, 16, 2, 0, module="tensor.manipulation",
         ignore_value=-5)
    assert J.tensor.empty_like(J.to_tensor(X)).shape == \
        T.tensor.empty_like(T.to_tensor(X)).shape == list(X.shape)
