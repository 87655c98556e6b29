"""`paddle.autograd`: user-defined differentiable ops (PyLayer) and the
functional backward entry.

Counterpart of ``paddle_tpu/autograd.py`` (reference
python/paddle/autograd/py_layer.py).  There a PyLayer becomes a
``jax.custom_vjp`` function recorded on the JAX package's tape, and its
forward runs again at every backward replay.  Here it is a
``torch.autograd.Function``: ``forward`` runs once, under no grad, on
``Tensor``s over the inputs' values, and autograd calls the user's
``backward`` with one cotangent per tensor output (``None`` for a
non-floating one); it must return one gradient per TENSOR input, in
order (``None`` for non-differentiable inputs).
"""
from __future__ import annotations

import warnings

import torch

__all__ = ["PyLayer", "PyLayerContext", "backward"]


class PyLayerContext:
    """Reference py_layer.py PyLayerContext: carries state from forward
    to backward (``save_for_backward``/``saved_tensor`` plus arbitrary
    python attributes)."""

    def __init__(self):
        self._saved: tuple = ()

    def save_for_backward(self, *tensors):
        self._saved = tuple(tensors)

    def saved_tensor(self):
        return self._saved


def _floating(v) -> bool:
    return v.is_floating_point() or v.is_complex()


class _Function(torch.autograd.Function):
    """One PyLayer application: ``spec`` holds the PyLayer class, its
    context, the non-tensor arguments and where the tensors go."""

    @staticmethod
    def forward(fctx, spec, *vals):
        from .dygraph.tensor import Tensor, _wrap

        cls, ctx, args, kwargs, tensor_pos = spec
        args = list(args)
        for i, v in zip(tensor_pos, vals):
            args[i] = _wrap(v)
        outs = cls.forward(ctx, *args, **kwargs)
        spec.append(isinstance(outs, (list, tuple)))
        outs = list(outs) if spec[-1] else [outs]
        raw = tuple(o._value if isinstance(o, Tensor) else o for o in outs)
        fctx.mark_non_differentiable(*(v for v in raw if not _floating(v)))
        fctx.spec, fctx.in_floating = spec, [_floating(v) for v in vals]
        return raw

    @staticmethod
    def backward(fctx, *cots):
        from .dygraph.tensor import Tensor, _wrap

        cls, ctx = fctx.spec[0], fctx.spec[1]
        gs = cls.backward(ctx, *(None if c is None else _wrap(c)
                                 for c in cots))
        gs = list(gs) if isinstance(gs, (list, tuple)) else [gs]
        if len(gs) != len(fctx.in_floating):
            raise RuntimeError(
                f"{cls.__name__}.backward returned {len(gs)} "
                f"gradient(s) for {len(fctx.in_floating)} tensor input(s)")
        out = [None if g is None or not fl else
               (g._value if isinstance(g, Tensor) else torch.as_tensor(g))
               for g, fl in zip(gs, fctx.in_floating)]
        return (None, *out)


class PyLayer:
    """Custom differentiable operation.

    Subclass with two staticmethods::

        class Exp(PyLayer):
            @staticmethod
            def forward(ctx, x):
                y = paddle.exp(x)
                ctx.save_for_backward(y)
                return y

            @staticmethod
            def backward(ctx, dy):
                (y,) = ctx.saved_tensor()
                return dy * y

        y = Exp.apply(x)
    """

    @classmethod
    def apply(cls, *args, **kwargs):
        from .dygraph.tensor import Tensor, _wrap

        tensor_pos = [i for i, a in enumerate(args) if isinstance(a, Tensor)]
        if not tensor_pos:
            raise ValueError(
                f"{cls.__name__}.apply needs at least one Tensor input")
        kw_tensors = [k for k, v in kwargs.items() if isinstance(v, Tensor)]
        if kw_tensors:
            # reference PyLayer semantics: keyword tensors are legal but
            # NON-DIFFERENTIABLE -- say so loudly instead of silently
            warnings.warn(
                f"{cls.__name__}.apply: keyword tensor(s) {kw_tensors} "
                f"are treated as non-differentiable constants (pass "
                f"positionally to get gradients)", RuntimeWarning,
                stacklevel=2)
        spec = [cls, PyLayerContext(), args, kwargs, tensor_pos]
        outs = _Function.apply(spec, *(args[i]._value for i in tensor_pos))
        outs = [_wrap(o) for o in outs]
        return tuple(outs) if spec[-1] else outs[0]


def backward(tensors, grad_tensors=None, retain_graph=False):
    """Reference paddle.autograd.backward: run the tape from ``tensors``
    with optional explicit cotangents."""
    from .dygraph.backward import run_backward

    tensors = list(tensors) if isinstance(tensors, (list, tuple)) \
        else [tensors]
    seeds = None
    if grad_tensors is not None:
        seeds = list(grad_tensors) if isinstance(
            grad_tensors, (list, tuple)) else [grad_tensors]
        if len(seeds) != len(tensors):
            raise ValueError(
                f"backward: grad_tensors has {len(seeds)} entries for "
                f"{len(tensors)} tensors (a shorter list would silently "
                f"zero the cotangents of the extra tensors)")
    run_backward(tensors, seeds=seeds, retain_graph=retain_graph)
