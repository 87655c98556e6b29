"""Dygraph autograd entry points over ``torch.autograd``.

Counterpart of ``paddle_tpu/dygraph/backward.py``, whose engine walks
its own tape in reverse topological order and runs each node's
``jax.vjp``.  Here the tape is autograd's graph (every eager op was
recorded as it ran, ``eager.py``), so:

- ``run_backward`` (``Tensor.backward``, ``autograd.backward``) is
  ``torch.autograd.backward``: leaf gradients accumulate into ``.grad``
  across calls, as in the reference, until ``clear_grad``;
- ``grad`` (``paddle.grad``) is ``torch.autograd.grad`` (nothing
  accumulates), ``create_graph=True`` giving gradients that are
  themselves differentiable (double grad);
- gradient hooks are autograd's tensor hooks (``Tensor.register_hook``).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from .tensor import Tensor, _as_torch, _unwrap, _wrap


def _seed(t: Tensor, s) -> Optional[torch.Tensor]:
    if s is None:
        if t.size != 1:
            raise RuntimeError(
                f"grad can be implicitly created only for scalar outputs; "
                f"got shape {t.shape} (pass grad_tensor)")
        return None
    return _unwrap(s) if isinstance(s, Tensor) else _as_torch(
        s, t._value.device)


def run_backward(roots: List[Tensor], seeds: Optional[List] = None,
                 retain_graph: bool = False) -> None:
    """Backward from ``roots``; ``seeds[i]`` is the cotangent of
    ``roots[i]`` (ones for a one-element root).  A root that does not
    require grad contributes nothing, as in the JAX package."""
    seeds = seeds or [None] * len(roots)
    pairs = [(t._value, _seed(t, s)) for t, s in zip(roots, seeds)
             if t._value.requires_grad]
    if pairs:
        torch.autograd.backward([v for v, _ in pairs],
                                [s for _, s in pairs],
                                retain_graph=retain_graph)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """`paddle.grad` (reference partial_grad_engine.cc / dygraph
    base.grad).  ``create_graph=True`` records the backward on the tape so
    the returned grads are themselves differentiable (double grad)."""
    outputs = outputs if isinstance(outputs, (list, tuple)) else [outputs]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    if grad_outputs is not None:
        grad_outputs = grad_outputs if isinstance(
            grad_outputs, (list, tuple)) else [grad_outputs]
    else:
        grad_outputs = [None] * len(outputs)
    pairs = [(o._value, _seed(o, s)) for o, s in zip(outputs, grad_outputs)
             if o._value.requires_grad]
    wanted = [i for i, t in enumerate(inputs) if t._value.requires_grad]
    got = {}
    if pairs and wanted:
        retain = True if retain_graph is None else retain_graph
        gs = torch.autograd.grad(
            [v for v, _ in pairs], [inputs[i]._value for i in wanted],
            grad_outputs=[s for _, s in pairs],
            retain_graph=retain or create_graph, create_graph=create_graph,
            allow_unused=True)
        got = dict(zip(wanted, gs))
    result = []
    for i, t in enumerate(inputs):
        g = got.get(i)
        if g is None:
            if not allow_unused:
                raise RuntimeError(
                    f"input {t.name} is unreachable from outputs "
                    "(set allow_unused=True to get None)")
            result.append(None)
        else:
            result.append(_wrap(g))
    return result
