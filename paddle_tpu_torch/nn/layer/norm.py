"""Normalization layers (reference python/paddle/nn/layer/norm.py);
counterpart of ``paddle_tpu/nn/layer/norm.py``.  The batch norms' running
statistics are float32 buffers on the place."""
from __future__ import annotations

import torch

from ...dygraph import base
from ...dygraph.layers import Layer
from ...dygraph.tensor import Tensor
from .. import functional as F


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, data_format="NCHW", use_global_stats=None, name=None):
        super().__init__()
        from ...initializer import ConstantInitializer

        self._momentum, self._epsilon = momentum, epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=ConstantInitializer(1.0))
        self.bias = self.create_parameter([num_features], attr=bias_attr, is_bias=True)
        dev = base.current_device()
        self.register_buffer("_mean", Tensor(torch.zeros(num_features,
                                                         device=dev)))
        self.register_buffer("_variance", Tensor(torch.ones(num_features,
                                                            device=dev)))

    def forward(self, x):
        training = self.training if self._use_global_stats is None else (
            not self._use_global_stats)
        return F.batch_norm(x, self._mean, self._variance, self.weight, self.bias,
                            training=training, momentum=self._momentum,
                            epsilon=self._epsilon, data_format=self._data_format)


class BatchNorm(_BatchNormBase):
    """Compat alias for fluid-era BatchNorm."""


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    """Cross-replica BN (reference sync_batch_norm op).  The port runs one
    process, where its lowering is plain batch norm; the collective over
    the data-parallel group comes with the distributed slices."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        for name, sub in list(layer._sub_layers.items()):
            if isinstance(sub, _BatchNormBase) and not isinstance(sub, SyncBatchNorm):
                sb = SyncBatchNorm(sub.weight.shape[0], sub._momentum, sub._epsilon)
                sb.weight, sb.bias = sub.weight, sub.bias
                sb._mean, sb._variance = sub._mean, sub._variance
                layer._sub_layers[name] = sb
            else:
                cls.convert_sync_batchnorm(sub)
        return layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        from ...initializer import ConstantInitializer

        ns = ([normalized_shape] if isinstance(normalized_shape, int)
              else list(normalized_shape))
        self._normalized_shape = ns
        self._epsilon = epsilon
        self.weight = (self.create_parameter(
            ns, attr=weight_attr, default_initializer=ConstantInitializer(1.0))
            if weight_attr is not False else None)
        self.bias = (self.create_parameter(ns, attr=bias_attr, is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, x):
        return F.layer_norm(x, self._normalized_shape, self.weight, self.bias,
                            self._epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, data_format="NCHW", name=None):
        super().__init__()
        from ...initializer import ConstantInitializer

        self._num_groups, self._epsilon = num_groups, epsilon
        self.weight = self.create_parameter(
            [num_channels], attr=weight_attr,
            default_initializer=ConstantInitializer(1.0))
        self.bias = self.create_parameter([num_channels], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight, self.bias)


class InstanceNorm2D(Layer):
    def __init__(self, num_features, epsilon=1e-05, momentum=0.9, weight_attr=None,
                 bias_attr=None, data_format="NCHW", name=None):
        super().__init__()
        from ...initializer import ConstantInitializer

        self._epsilon = epsilon
        self.weight = self.create_parameter(
            [num_features], attr=weight_attr,
            default_initializer=ConstantInitializer(1.0))
        self.bias = self.create_parameter([num_features], attr=bias_attr, is_bias=True)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias, eps=self._epsilon)
