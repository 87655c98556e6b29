"""`paddle.nn.utils` (reference python/paddle/nn/utils/):
weight_norm / remove_weight_norm / spectral_norm reparameterizations
over dygraph Layers, plus parameter<->vector helpers.

Counterpart of ``paddle_tpu/nn/utils/__init__.py``, on torch tensors:
the reparameterized weight is recomputed from its factors in a forward
pre-hook, where autograd records it.  The factors keep the JAX package's
names (``{name}_g`` / ``{name}_v``; ``{name}_orig`` and the persistent
buffer ``{name}_u``), so a state dict crosses between the packages by
key.  ``spectral_norm`` draws its start vector from
``np.random.RandomState(0)``, as the JAX package does, so both start
the power iteration from the same ``u``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["weight_norm", "remove_weight_norm", "spectral_norm",
           "parameters_to_vector", "vector_to_parameters"]


def _norm_except(t, dim):
    """||t|| over every axis except ``dim`` (keepdims); ``dim=None``
    means the whole-tensor norm (scalar, reference norm_except_dim with
    dim=-1), eager tensors."""
    from ...dygraph.eager import apply_torch

    axes = tuple(i for i in range(len(t.shape)) if i != dim)
    keep = dim is not None
    return apply_torch(
        lambda v: torch.sqrt(torch.sum(v * v, dim=axes, keepdim=keep)
                             + 1e-12), t)


def _wn_dim(t, dim):
    """Reference norm_except_dim convention: dim in (None, -1) selects
    the whole-tensor norm (g is scalar); other negative dims count from
    the back (dim % ndim)."""
    if dim is None or dim == -1:
        return None
    return dim % len(t.shape) if dim < 0 else dim


def weight_norm(layer, name="weight", dim=0):
    """Reference nn/utils/weight_norm_hook.py: w = g * v / ||v||, with
    g (per-``dim`` magnitude) and v (direction) as the trainable
    parameters; recomputed on every forward.  ``dim in (None, -1)``
    normalizes the whole tensor (scalar g)."""
    from ...dygraph.layers import Parameter

    w = layer._parameters.get(name)
    if w is None:
        raise ValueError(f"layer has no parameter {name!r}")
    dim = _wn_dim(w, dim)
    g0 = _norm_except(w, dim)
    v = Parameter(w._value.detach().clone(), name=w.name + "_v",
                  trainable=True)
    g = Parameter(g0._value, name=w.name + "_g", trainable=True)
    del layer._parameters[name]
    layer._parameters[name + "_v"] = v
    layer._parameters[name + "_g"] = g

    def compute(lyr):
        vv = lyr._parameters[name + "_v"]
        gg = lyr._parameters[name + "_g"]
        object.__setattr__(lyr, name, gg * (vv / _norm_except(vv, dim)))

    def pre_hook(lyr, inputs):
        compute(lyr)
        return None

    handle = layer.register_forward_pre_hook(pre_hook)
    layer.__dict__.setdefault("_weight_norm_state", {})[name] = (
        handle, dim, compute)
    compute(layer)  # usable before the first forward too
    return layer


def remove_weight_norm(layer, name="weight"):
    """Bake the current w back into a plain parameter and drop the
    reparameterization."""
    from ...dygraph.layers import Parameter

    state = layer.__dict__.get("_weight_norm_state", {}).pop(name, None)
    if state is None:
        raise ValueError(f"{name!r} is not weight-normed on this layer")
    handle, _dim, compute = state
    compute(layer)  # final value from the factors
    w_val = getattr(layer, name)._value.detach()
    handle.remove()
    del layer._parameters[name + "_v"]
    del layer._parameters[name + "_g"]
    if name in layer.__dict__:
        del layer.__dict__[name]
    layer._parameters[name] = Parameter(w_val, name=name, trainable=True)
    return layer


def spectral_norm(layer, name="weight", n_power_iterations=1, eps=1e-12,
                  dim=0):
    """Reference nn/utils/spectral_norm_hook.py: w / sigma_max(w), with
    sigma estimated by power iteration on a persistent u buffer.

    The power-iteration vectors are detached before sigma = u^T W v, so
    gradients flow only through W: the reference treats u/v as constants
    per step.  u is a persistent layer buffer (``{name}_u``), so it rides
    state_dict and survives save/load."""
    from ...dygraph.eager import apply_torch
    from ...dygraph.tensor import Tensor

    w = layer._parameters.get(name)
    if w is None:
        raise ValueError(f"layer has no parameter {name!r}")
    h = int(w.shape[dim])
    rs = np.random.RandomState(0)
    layer.register_buffer(name + "_u",
                          Tensor(rs.randn(h).astype("float32")),
                          persistable=True)

    def sn(wv, uv):
        mat = torch.movedim(wv, dim, 0).reshape(h, -1)
        # the iteration runs on the detached weight: u/v are plain
        # estimates, not part of the differentiated graph
        mat_c = mat.detach()
        u = uv
        for _ in range(n_power_iterations):
            v = mat_c.T @ u
            v = v / (torch.linalg.norm(v) + eps)
            u = mat_c @ v
            u = u / (torch.linalg.norm(u) + eps)
        if n_power_iterations == 0:
            # no update: sigma from the stored u and its derived v
            v = mat_c.T @ u
            v = v / (torch.linalg.norm(v) + eps)
        u, v = u.detach(), v.detach()
        return wv / (u @ (mat @ v)), u

    def pre_hook(lyr, inputs):
        w_new, u_new = apply_torch(sn, lyr._parameters[name + "_orig"],
                                   lyr._buffers[name + "_u"], n_out=2)
        lyr._buffers[name + "_u"] = Tensor(u_new._value.detach())
        object.__setattr__(lyr, name, w_new)
        return None

    del layer._parameters[name]
    layer._parameters[name + "_orig"] = w
    layer.register_forward_pre_hook(pre_hook)
    return layer


def parameters_to_vector(parameters, name=None):
    """Flatten + concat parameters (reference
    nn/utils/transform_parameters.py)."""
    from ...dygraph.eager import apply_torch

    return apply_torch(lambda *vs: torch.cat([v.reshape(-1) for v in vs]),
                       *parameters)


def vector_to_parameters(vec, parameters):
    ofs = 0
    for p in parameters:
        n = int(np.prod(p.shape))
        p.set_value(vec._value[ofs:ofs + n].detach().reshape(tuple(p.shape)))
        ofs += n
