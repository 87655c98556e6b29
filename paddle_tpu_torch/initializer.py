"""Parameter initializers — append init ops to the startup program.

Copy of ``paddle_tpu/initializer.py`` without the ``eager_value``
rules, which drew dygraph parameters with ``jax.random``.

Role parity: reference python/paddle/fluid/initializer.py (Constant, Uniform,
Normal, TruncatedNormal, Xavier, MSRA, NumpyArrayInitializer).
"""
from __future__ import annotations

import math

import numpy as np

from .framework import dtypes


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError

    def eager_value(self, shape, dtype, key):
        """Produce the initial value directly (dygraph parameter
        creation): dygraph mode is a later slice of the port."""
        raise NotImplementedError(
            f"{type(self).__name__}.eager_value: dygraph parameter "
            f"creation comes with the dygraph slice, a later slice of the "
            f"port; static programs initialize through the startup program")


class ConstantInitializer(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, var, block):
        block.append_op(
            "fill_constant",
            {},
            {"Out": var.name},
            {"shape": list(var.shape), "dtype": var.dtype, "value": float(self.value)},
        )


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op(
            "uniform_random",
            {},
            {"Out": var.name},
            {
                "shape": list(var.shape),
                "dtype": var.dtype,
                "min": float(self.low),
                "max": float(self.high),
                "seed": self.seed,
            },
        )


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(
            "gaussian_random",
            {},
            {"Out": var.name},
            {
                "shape": list(var.shape),
                "dtype": var.dtype,
                "mean": float(self.loc),
                "std": float(self.scale),
                "seed": self.seed,
            },
        )


class TruncatedNormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(
            "truncated_gaussian_random",
            {},
            {"Out": var.name},
            {
                "shape": list(var.shape),
                "dtype": var.dtype,
                "mean": float(self.loc),
                "std": float(self.scale),
                "seed": self.seed,
            },
        )


def _shape_fans(shape):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    rs = 1
    for s in shape[2:]:
        rs *= s
    return shape[1] * rs, shape[0] * rs


def _fans(var):
    return _shape_fans(var.shape)


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = uniform, fan_in, fan_out, seed

    def __call__(self, var, block):
        fi, fo = _fans(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / (fi + fo))
            NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block):
        fi, _ = _fans(var)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / fi)
            NormalInitializer(0.0, std, self.seed)(var, block)


class NumpyArrayInitializer(Initializer):
    def __init__(self, value: np.ndarray):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        vals = self.value.ravel().tolist()
        key = {
            "float32": "fp32_values",
            "float64": "fp32_values",
            "int32": "int32_values",
            "int64": "int64_values",
            "bool": "bool_values",
        }.get(dtypes.to_str(var.dtype), "fp32_values")
        block.append_op(
            "assign_value",
            {},
            {"Out": var.name},
            {"shape": list(self.value.shape), "dtype": var.dtype, key: vals},
        )


# reference-compatible aliases
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer


def _global_weight_initializer():
    return XavierInitializer()


def _global_bias_initializer():
    return ConstantInitializer(0.0)
