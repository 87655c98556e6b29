"""Vision transforms (reference python/paddle/vision/transforms/).

Counterpart of ``paddle_tpu/vision/transforms.py``: numpy on the host
(HWC uint8/float in, CHW float out via ``ToTensor``), as there.  They run
inside the loader's worker processes, which see no card, so none of them
touches CUDA or torch.  The random ones (``RandomHorizontalFlip``,
``RandomCrop``) draw from numpy's global stream, as in the JAX package,
so a seeded run flips and crops the same samples in both packages.
``Resize`` is the JAX package's ``jax.image.resize`` written out in
numpy (``_resize``): the same sample positions, kernels (triangle, Keys
cubic with a = -0.5, nearest by ``floor``) and antialiasing when
shrinking (the kernel widened by the scale, weights renormalized).
"""
from __future__ import annotations

import numbers

import numpy as np


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class BaseTransform:
    def __call__(self, img):
        return self._apply_image(img)


class ToTensor(BaseTransform):
    """HWC [0,255] -> CHW float32 [0,1]."""

    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def _apply_image(self, img):
        arr = np.asarray(img)
        if arr.dtype == np.uint8:
            arr = arr.astype("float32") / 255.0
        else:
            arr = arr.astype("float32")
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if self.data_format == "CHW":
            arr = arr.transpose(2, 0, 1)
        return arr


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        # scalars stay scalar so the channel count comes from the image
        self.mean = (float(mean) if isinstance(mean, numbers.Number)
                     else np.asarray(mean, dtype="float32"))
        self.std = (float(std) if isinstance(std, numbers.Number)
                    else np.asarray(std, dtype="float32"))
        self.data_format = data_format

    def _apply_image(self, img):
        img = np.asarray(img, dtype="float32")
        shape = (-1, 1, 1) if self.data_format == "CHW" else (1, 1, -1)
        mean = (self.mean if isinstance(self.mean, float)
                else self.mean.reshape(shape))
        std = (self.std if isinstance(self.std, float)
               else self.std.reshape(shape))
        return (img - mean) / std


def _triangle(x):
    return np.maximum(0.0, 1.0 - np.abs(x))


def _keys_cubic(x):
    x = np.abs(x)
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _weight_mat(in_size, out_size, kernel):
    """[in, out] interpolation weights of one axis (jax.image's
    ``compute_weight_mat`` with no translation, antialiased)."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(out_size, dtype=np.float32) + 0.5) * \
        np.float32(inv_scale) - 0.5
    w = kernel(np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)
                      [:, None]) / np.float32(kernel_scale))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def _resize(arr, out_shape, method):
    """``arr`` (float32) resized to ``out_shape`` along every axis whose
    size changes, one axis at a time."""
    for d, (m, n) in enumerate(zip(arr.shape, out_shape)):
        if m == n:
            continue
        if method == "nearest":
            idx = np.floor((np.arange(n, dtype=np.float32) + 0.5)
                           * np.float32(m) / np.float32(n)).astype(np.int64)
            arr = np.take(arr, idx, axis=d)
            continue
        w = _weight_mat(m, n, _triangle if method == "bilinear"
                        else _keys_cubic)
        arr = np.moveaxis(np.tensordot(arr, w, axes=([d], [0])), -1, d)
    return arr.astype(np.float32)


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        if interpolation not in ("bilinear", "nearest", "bicubic"):
            raise ValueError(f"unknown interpolation {interpolation!r}")
        self.interpolation = interpolation

    def _apply_image(self, img):
        arr = np.asarray(img, dtype="float32")
        chw = arr.ndim == 3 and arr.shape[0] in (1, 3) and arr.shape[0] < arr.shape[-1]
        if chw:
            out_shape = (arr.shape[0],) + self.size
        elif arr.ndim == 3:
            out_shape = self.size + (arr.shape[2],)
        else:
            out_shape = self.size
        return _resize(arr, out_shape, self.interpolation)


class CenterCrop(BaseTransform):
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def _apply_image(self, img):
        arr = np.asarray(img)
        h, w = arr.shape[-3:-1] if arr.ndim == 3 and arr.shape[-1] <= 4 else arr.shape[-2:]
        th, tw = self.size
        i, j = max((h - th) // 2, 0), max((w - tw) // 2, 0)
        if arr.ndim == 3 and arr.shape[-1] <= 4:  # HWC
            return arr[i:i + th, j:j + tw]
        if arr.ndim == 3:  # CHW
            return arr[:, i:i + th, j:j + tw]
        return arr[i:i + th, j:j + tw]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def _apply_image(self, img):
        if np.random.rand() < self.prob:
            arr = np.asarray(img)
            return arr[..., ::-1].copy() if arr.ndim == 3 and arr.shape[0] <= 4 \
                else arr[:, ::-1].copy() if arr.ndim == 2 else arr[:, ::-1, :].copy()
        return img


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=0):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def _apply_image(self, img):
        arr = np.asarray(img)
        hwc = arr.ndim == 2 or arr.shape[-1] <= 4
        if self.padding:
            p = self.padding
            pads = ((p, p), (p, p), (0, 0)) if (arr.ndim == 3 and hwc) else \
                   ((0, 0), (p, p), (p, p)) if arr.ndim == 3 else ((p, p), (p, p))
            arr = np.pad(arr, pads)
        h, w = (arr.shape[0], arr.shape[1]) if hwc else (arr.shape[1], arr.shape[2])
        th, tw = self.size
        i = np.random.randint(0, h - th + 1)
        j = np.random.randint(0, w - tw + 1)
        if arr.ndim == 2:
            return arr[i:i + th, j:j + tw]
        if hwc:
            return arr[i:i + th, j:j + tw]
        return arr[:, i:i + th, j:j + tw]


def to_tensor(img, data_format="CHW"):
    return ToTensor(data_format)(img)


def normalize(img, mean, std, data_format="CHW"):
    return Normalize(mean, std, data_format)(img)


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(img)
