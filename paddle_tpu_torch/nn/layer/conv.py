"""Convolution layers (reference python/paddle/nn/layer/conv.py);
counterpart of ``paddle_tpu/nn/layer/conv.py``."""
from __future__ import annotations

from ...dygraph.layers import Layer
from .. import functional as F


class Conv2D(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCHW"):
        super().__init__()
        ks = [kernel_size] * 2 if isinstance(kernel_size, int) else list(kernel_size)
        self._stride, self._padding, self._dilation = stride, padding, dilation
        self._groups, self._data_format = groups, data_format
        from ...initializer import MSRAInitializer

        self.weight = self.create_parameter(
            [out_channels, in_channels // groups] + ks, attr=weight_attr,
            default_initializer=MSRAInitializer(uniform=True))
        self.bias = (self.create_parameter([out_channels], attr=bias_attr, is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)


class Conv2DTranspose(Layer):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, dilation=1, groups=1, weight_attr=None,
                 bias_attr=None, data_format="NCHW"):
        super().__init__()
        ks = [kernel_size] * 2 if isinstance(kernel_size, int) else list(kernel_size)
        self._stride, self._padding, self._dilation = stride, padding, dilation
        self._groups, self._output_padding = groups, output_padding
        self._data_format = data_format
        self.weight = self.create_parameter(
            [in_channels, out_channels // groups] + ks, attr=weight_attr)
        self.bias = (self.create_parameter([out_channels], attr=bias_attr, is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding,
                                  self._dilation, self._groups, output_size,
                                  self._data_format)
