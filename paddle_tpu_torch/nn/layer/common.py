"""Common layers (reference python/paddle/nn/layer/common.py).

Counterpart of ``paddle_tpu/nn/layer/common.py``; ``Dropout2D`` draws its
channel mask from the place's generator."""
from __future__ import annotations

from ...dygraph.layers import Layer
from .. import functional as F


class Linear(Layer):
    def __init__(self, in_features, out_features, weight_attr=None, bias_attr=None,
                 name=None):
        super().__init__()
        self.weight = self.create_parameter([in_features, out_features], attr=weight_attr)
        self.bias = (self.create_parameter([out_features], attr=bias_attr, is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def extra_repr(self):
        return f"in={self.weight.shape[0]}, out={self.weight.shape[1]}"


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.mode = mode

    def forward(self, x):
        return F.dropout(x, self.p, training=self.training, mode=self.mode)


class Dropout2D(Layer):
    """Zeroes whole channels of NCHW maps (reference nn.Dropout2D)."""

    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p = p
        self.data_format = data_format

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        from ...dygraph import base
        from ...dygraph.eager import apply_torch
        import torch

        p = self.p
        ch_axis = 1 if self.data_format == "NCHW" else -1

        def fn(v):
            shape = [1] * v.dim()
            shape[0] = v.shape[0]
            shape[ch_axis] = v.shape[ch_axis]
            keep = torch.rand(shape, generator=base.generator(v.device),
                              device=v.device) < 1.0 - p
            return torch.where(keep, v / (1.0 - p),
                               torch.zeros((), dtype=v.dtype,
                                           device=v.device)).to(v.dtype)

        return apply_torch(fn, x)


class Embedding(Layer):
    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None,
                 is_sparse=None):
        super().__init__()
        from ...initializer import NormalInitializer

        self.padding_idx = padding_idx
        # 2.x spells it `sparse`, the 1.x dygraph layer `is_sparse`;
        # accept both (explicit is_sparse wins)
        self.sparse = bool(sparse if is_sparse is None else is_sparse)
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=NormalInitializer(0.0, 1.0))
        if padding_idx is not None:
            import torch

            with torch.no_grad():
                self.weight._value[padding_idx] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, padding_idx=self.padding_idx,
                           sparse=self.sparse)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        from ...tensor.manipulation import flatten

        return flatten(x, self.start_axis, self.stop_axis)


class Pad2D(Layer):
    def __init__(self, padding, mode="constant", value=0.0, data_format="NCHW"):
        super().__init__()
        self.padding = padding if isinstance(padding, (list, tuple)) else [padding] * 4
        self.mode, self.value, self.data_format = mode, value, data_format

    def forward(self, x):
        return F.pad(x, list(self.padding), self.mode, self.value, self.data_format)


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW"):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners, self.align_mode = mode, align_corners, align_mode

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        from ...tensor import math as m

        a = F.normalize(x1, axis=self.axis, epsilon=self.eps)
        b = F.normalize(x2, axis=self.axis, epsilon=self.eps)
        return m.sum(m.multiply(a, b), axis=self.axis)
