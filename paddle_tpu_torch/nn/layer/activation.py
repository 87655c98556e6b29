"""Activation layers (reference python/paddle/nn/layer/activation.py);
counterpart of ``paddle_tpu/nn/layer/activation.py``."""
from __future__ import annotations

from ...dygraph.layers import Layer
from .. import functional as F


def _mk(name, fn, **fixed):
    class _Act(Layer):
        def __init__(self, *a, **kw):
            super().__init__()
            self._kw = {**fixed}
            # positional args map onto the functional's keyword order
            self._args = a
            self._kw.update(kw)
            self._kw.pop("name", None)

        def forward(self, x):
            return fn(x, *self._args, **self._kw)

    _Act.__name__ = name
    _Act.__qualname__ = name
    return _Act


ReLU = _mk("ReLU", F.relu)
ReLU6 = _mk("ReLU6", F.relu6)
GELU = _mk("GELU", F.gelu)
Sigmoid = _mk("Sigmoid", F.sigmoid)
Tanh = _mk("Tanh", F.tanh)
LeakyReLU = _mk("LeakyReLU", F.leaky_relu)
ELU = _mk("ELU", F.elu)
SELU = _mk("SELU", F.selu)
CELU = _mk("CELU", F.celu)
Hardswish = _mk("Hardswish", F.hardswish)
Hardsigmoid = _mk("Hardsigmoid", F.hardsigmoid)
Hardtanh = _mk("Hardtanh", F.hardtanh)
Hardshrink = _mk("Hardshrink", F.hardshrink)
Softshrink = _mk("Softshrink", F.softshrink)
Softplus = _mk("Softplus", F.softplus)
Softsign = _mk("Softsign", F.softsign)
Swish = _mk("Swish", F.swish)
Silu = _mk("Silu", F.silu)
Mish = _mk("Mish", F.mish)
Tanhshrink = _mk("Tanhshrink", F.tanhshrink)
ThresholdedReLU = _mk("ThresholdedReLU", F.thresholded_relu)
LogSigmoid = _mk("LogSigmoid", F.log_sigmoid)
LogSoftmax = _mk("LogSoftmax", F.log_softmax)
Softmax = _mk("Softmax", F.softmax)
Maxout = _mk("Maxout", F.maxout)


class PReLU(Layer):
    def __init__(self, num_parameters=1, init=0.25, weight_attr=None, name=None):
        super().__init__()
        from ...initializer import ConstantInitializer

        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=ConstantInitializer(init))

    def forward(self, x):
        return F.prelu(x, self.weight)
