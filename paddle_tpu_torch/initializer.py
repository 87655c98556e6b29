"""Parameter initializers — append init ops to the startup program, or
make a dygraph parameter's value directly (``eager_value``).

Counterpart of ``paddle_tpu/initializer.py``.  ``eager_value(shape,
dtype, generator)`` draws from the ``torch.Generator`` it is given (the
place's, ``dygraph/base.py``) on that generator's device, where the JAX
package's drew from a threefry key: the two agree in distribution, not
in bits.  The truncated normal draws by inverting the normal's CDF over
[-2, 2] standard deviations (``jax.random.truncated_normal``'s support).

Role parity: reference python/paddle/fluid/initializer.py (Constant, Uniform,
Normal, TruncatedNormal, Xavier, MSRA, NumpyArrayInitializer).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .framework import dtypes


def _uniform(gen, shape, lo, hi):
    u = torch.rand(tuple(shape), generator=gen, dtype=torch.float32,
                   device=gen.device)
    return lo + (hi - lo) * u


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError

    def eager_value(self, shape, dtype, generator):
        """Produce the initial value directly (dygraph parameter
        creation), on ``generator``'s device."""
        raise NotImplementedError(
            f"{type(self).__name__} has no eager-mode value rule")


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

    def eager_value(self, shape, dtype, generator):
        return torch.full(tuple(shape), float(self.value),
                          dtype=dtypes.to_torch(dtype),
                          device=generator.device)


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

    def eager_value(self, shape, dtype, generator):
        return _uniform(generator, shape, float(self.low),
                        float(self.high)).to(dtypes.to_torch(dtype))


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

    def eager_value(self, shape, dtype, generator):
        z = torch.randn(tuple(shape), generator=generator,
                        dtype=torch.float32, device=generator.device)
        return (self.loc + self.scale * z).to(dtypes.to_torch(dtype))


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

    def eager_value(self, shape, dtype, generator):
        return (self.loc + self.scale * truncated_normal(
            generator, shape)).to(dtypes.to_torch(dtype))


def truncated_normal(generator, shape):
    """Standard normal draws restricted to [-2, 2], by inverting the
    CDF of uniform draws between Phi(-2) and Phi(2)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = _uniform(generator, shape, lo, 1.0 - lo)
    return (math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).clamp(-2.0, 2.0)


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

    def eager_value(self, shape, dtype, generator):
        fi, fo = _shape_fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            return UniformInitializer(-limit, limit, self.seed).eager_value(
                shape, dtype, generator)
        std = math.sqrt(2.0 / (fi + fo))
        return NormalInitializer(0.0, std, self.seed).eager_value(
            shape, dtype, generator)


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

    def eager_value(self, shape, dtype, generator):
        fi, _ = _shape_fans(shape)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            return UniformInitializer(-limit, limit, self.seed).eager_value(
                shape, dtype, generator)
        std = math.sqrt(2.0 / fi)
        return NormalInitializer(0.0, std, self.seed).eager_value(
            shape, dtype, generator)


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

    def eager_value(self, shape, dtype, generator):
        return torch.as_tensor(
            self.value.reshape(tuple(shape)), device=generator.device).to(
                dtypes.to_torch(dtype))


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
