"""Statistics API (reference python/paddle/tensor/stat.py).

Counterpart of ``paddle_tpu/tensor/stat.py``.  ``median`` is the mean of
the two middle values for an even count (the JAX package's, where
``torch.median`` takes the lower one), so it is the 0.5 quantile."""
from __future__ import annotations

from . import math as _math


def mean(x, axis=None, keepdim=False, name=None):
    return _math.mean(x, axis, keepdim, name)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    m = _math.mean(x, axis, True)
    sq = _math.mean(_math.square(_math.subtract(x, m)), axis, keepdim)
    if unbiased:
        import numpy as np

        if axis is None:
            n = int(np.prod(x.shape))
        else:
            axes = [axis] if isinstance(axis, int) else list(axis)
            n = int(np.prod([x.shape[a] for a in axes]))
        if n > 1:
            sq = _math.scale(sq, n / (n - 1))
    return sq


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return _math.sqrt(var(x, axis, unbiased, keepdim))


def numel(x, name=None):
    import numpy as np

    return int(np.prod(x.shape))


def median(x, axis=None, keepdim=False, name=None):
    from ..dygraph.eager import apply_torch
    import torch

    def fn(v):
        if axis is None:
            out = torch.quantile(v.reshape(-1), 0.5)
            return out.reshape([1] * v.dim()) if keepdim else out
        return torch.quantile(v, 0.5, dim=axis, keepdim=keepdim)

    return apply_torch(fn, x)
