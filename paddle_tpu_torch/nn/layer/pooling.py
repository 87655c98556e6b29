"""Pooling layers (reference python/paddle/nn/layer/pooling.py);
counterpart of ``paddle_tpu/nn/layer/pooling.py``."""
from __future__ import annotations

from ...dygraph.layers import Layer
from .. import functional as F


class MaxPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 return_mask=False, data_format="NCHW", name=None):
        super().__init__()
        self.k, self.s, self.p, self.ceil = kernel_size, stride, padding, ceil_mode

    def forward(self, x):
        return F.max_pool2d(x, self.k, self.s, self.p, self.ceil)


class AvgPool2D(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW", name=None):
        super().__init__()
        self.k, self.s, self.p, self.ceil = kernel_size, stride, padding, ceil_mode
        self.exclusive = exclusive

    def forward(self, x):
        return F.avg_pool2d(x, self.k, self.s, self.p, self.ceil, self.exclusive)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size)


class AdaptiveMaxPool2D(Layer):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size)
