"""``paddle.distribution``: Uniform / Normal / Categorical.

Counterpart of ``paddle_tpu/distribution.py`` (reference
python/paddle/distribution.py: :41 Distribution, :168 Uniform, :393
Normal, :646 Categorical).  Parameters and results are dygraph Tensors
on the tensor's device; the math is torch.  A draw takes an explicit
``torch.Generator`` on the parameters' device: a fresh one seeded with
``seed`` when it is nonzero, else the device's eager stream
(``dygraph.base.generator``, seeded by ``paddle.seed``).  The JAX
package draws from its threefry keys, so the two packages' samples
agree in distribution, not value.  ``Categorical.sample`` takes the
Gumbel-max argmax over the last axis, as ``jax.random.categorical``
does.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .dygraph import base as _base
from .dygraph.tensor import Tensor

__all__ = ["Distribution", "Uniform", "Normal", "Categorical"]


def _as_value(x):
    if isinstance(x, Tensor):
        return x._value
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x, dtype="float32"),
                           device=_base.current_device())


def _generator(device, seed):
    if seed:
        return torch.Generator(device=device).manual_seed(int(seed))
    return _base.generator(device)


def _out(value):
    return Tensor(value, stop_gradient=True)


class Distribution:
    """Abstract base (reference distribution.py:41)."""

    def sample(self, shape=()):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def probs(self, value):
        raise NotImplementedError

    def kl_divergence(self, other):
        raise NotImplementedError


class Uniform(Distribution):
    def __init__(self, low, high, name=None):
        self.low = _as_value(low)
        self.high = _as_value(high)

    def sample(self, shape=(), seed=0):
        dev = self.low.device
        shape = tuple(shape) + torch.broadcast_shapes(self.low.shape,
                                                      self.high.shape)
        u = torch.rand(shape, generator=_generator(dev, seed), device=dev)
        return _out(self.low + u * (self.high - self.low))

    def entropy(self):
        return _out(torch.log(self.high - self.low))

    def log_prob(self, value):
        v = _as_value(value)
        inside = (v >= self.low) & (v < self.high)
        lp = -torch.log(self.high - self.low)
        return _out(torch.where(inside, lp, torch.full_like(lp, -math.inf)))

    def probs(self, value):
        return _out(torch.exp(self.log_prob(value)._value))


class Normal(Distribution):
    def __init__(self, loc, scale, name=None):
        self.loc = _as_value(loc)
        self.scale = _as_value(scale)

    def sample(self, shape=(), seed=0):
        dev = self.loc.device
        shape = tuple(shape) + torch.broadcast_shapes(self.loc.shape,
                                                      self.scale.shape)
        z = torch.randn(shape, generator=_generator(dev, seed), device=dev)
        return _out(self.loc + z * self.scale)

    def entropy(self):
        return _out(0.5 + 0.5 * math.log(2 * math.pi)
                    + torch.log(self.scale))

    def log_prob(self, value):
        v = _as_value(value)
        var = self.scale * self.scale
        return _out(-torch.square(v - self.loc) / (2 * var)
                    - torch.log(self.scale) - 0.5 * math.log(2 * math.pi))

    def probs(self, value):
        return _out(torch.exp(self.log_prob(value)._value))

    def kl_divergence(self, other):
        if not isinstance(other, Normal):
            raise NotImplementedError("KL(Normal || non-Normal)")
        var_ratio = torch.square(self.scale / other.scale)
        t1 = torch.square((self.loc - other.loc) / other.scale)
        return _out(0.5 * (var_ratio + t1 - 1 - torch.log(var_ratio)))


class Categorical(Distribution):
    def __init__(self, logits, name=None):
        self.logits = _as_value(logits)

    def _logp(self):
        return torch.log_softmax(self.logits, dim=-1)

    def sample(self, shape=(), seed=0):
        dev = self.logits.device
        shape = tuple(shape) + tuple(self.logits.shape)
        u = torch.rand(shape, generator=_generator(dev, seed), device=dev)
        u = torch.clamp_min(u, torch.finfo(u.dtype).tiny)
        gumbel = -torch.log(-torch.log(u))
        return _out(torch.argmax(gumbel + self.logits, dim=-1))

    def entropy(self):
        logp = self._logp()
        return _out(-torch.sum(torch.exp(logp) * logp, dim=-1))

    def log_prob(self, value):
        idx = _as_value(value).long()
        logp = self._logp()
        if logp.dim() == 1:
            return _out(logp[idx])
        return _out(torch.gather(logp, -1, idx.unsqueeze(-1)).squeeze(-1))

    def probs(self, value):
        return _out(torch.exp(self.log_prob(value)._value))

    def kl_divergence(self, other):
        if not isinstance(other, Categorical):
            raise NotImplementedError("KL(Categorical || non-Categorical)")
        logp = self._logp()
        return _out(torch.sum(torch.exp(logp) * (logp - other._logp()),
                              dim=-1))
