"""Weight-decay regularizers (reference python/paddle/fluid/regularizer.py).

Copy of ``paddle_tpu/regularizer.py`` (the JAX package's module imports no
JAX); the program it builds is the same, op for op.
"""
from __future__ import annotations

from .framework.program import default_main_program
from .framework import unique_name


class WeightDecayRegularizer:
    def __init__(self, regularization_coeff=0.0):
        self._coeff = regularization_coeff

    def _append(self, block, param, grad):
        raise NotImplementedError


class L2Decay(WeightDecayRegularizer):
    def _append(self, block, param, grad):
        out = block.create_var(
            name=unique_name.generate(grad.name + "_l2"), shape=grad.shape, dtype=grad.dtype
        )
        scaled = block.create_var(
            name=unique_name.generate(param.name + "_scaled"), shape=param.shape, dtype=param.dtype
        )
        block.append_op("scale", {"X": param}, {"Out": scaled}, {"scale": self._coeff})
        block.append_op("sum", {"X": [grad.name, scaled.name]}, {"Out": out})
        return out


class L1Decay(WeightDecayRegularizer):
    def _append(self, block, param, grad):
        sign = block.create_var(
            name=unique_name.generate(param.name + "_sign"), shape=param.shape, dtype=param.dtype
        )
        scaled = block.create_var(
            name=unique_name.generate(param.name + "_l1"), shape=param.shape, dtype=param.dtype
        )
        out = block.create_var(
            name=unique_name.generate(grad.name + "_l1out"), shape=grad.shape, dtype=grad.dtype
        )
        block.append_op("sign", {"X": param}, {"Out": sign})
        block.append_op("scale", {"X": sign}, {"Out": scaled}, {"scale": self._coeff})
        block.append_op("sum", {"X": [grad.name, scaled.name]}, {"Out": out})
        return out


# reference spelling aliases
L2DecayRegularizer = L2Decay
L1DecayRegularizer = L1Decay


def append_regularization_ops(params_grads, regularization=None):
    """Add decay terms to gradients (per-param regularizer overrides global)."""
    out = []
    block = default_main_program().global_block
    for p, g in params_grads:
        reg = getattr(p, "regularizer", None) or regularization
        if reg is None or g is None:
            out.append((p, g))
        else:
            out.append((p, reg._append(block, p, g)))
    return out
