"""Random tensor API (reference python/paddle/tensor/random.py).

Counterpart of ``paddle_tpu/tensor/random.py``.  Eager draws come from
the place's generator (``dygraph/base.py``); they agree with the JAX
package's in distribution, not in bits."""
from __future__ import annotations

from ..dispatch import op_call
from ..framework import dtypes


def _shape_list(shape):
    if isinstance(shape, int):
        return [shape]
    return [int(s) for s in shape]


def uniform(shape, dtype="float32", min=-1.0, max=1.0, seed=0, name=None):
    return op_call("uniform_random", {},
                   {"shape": _shape_list(shape), "dtype": dtypes.to_enum(dtype),
                    "min": float(min), "max": float(max), "seed": int(seed)},
                   dtype=dtype, name=name)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    return op_call("gaussian_random", {},
                   {"shape": _shape_list(shape), "dtype": dtypes.to_enum("float32"),
                    "mean": float(mean), "std": float(std), "seed": 0},
                   dtype="float32", name=name)


def randn(shape, dtype="float32", name=None):
    return op_call("gaussian_random", {},
                   {"shape": _shape_list(shape), "dtype": dtypes.to_enum(dtype),
                    "mean": 0.0, "std": 1.0, "seed": 0}, dtype=dtype, name=name)


def rand(shape, dtype="float32", name=None):
    return uniform(shape, dtype, 0.0, 1.0, name=name)


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    if high is None:
        low, high = 0, low
    return op_call("randint", {},
                   {"shape": _shape_list(shape), "dtype": dtypes.to_enum(dtype),
                    "low": int(low), "high": int(high), "seed": 0},
                   dtype=dtype, name=name)


def randperm(n, dtype="int64", name=None):
    return op_call("randperm", {}, {"n": int(n), "dtype": dtypes.to_enum(dtype),
                                    "seed": 0}, dtype=dtype, name=name)


def multinomial(x, num_samples=1, replacement=False, name=None):
    from ..dygraph.eager import apply_torch
    from ..dygraph import base
    import torch

    def fn(probs):
        flat = probs.reshape(-1, probs.shape[-1])
        idx = torch.multinomial(flat, num_samples, replacement,
                                generator=base.generator(probs.device))
        return idx.reshape(probs.shape[:-1] + (num_samples,))

    return apply_torch(fn, x)
