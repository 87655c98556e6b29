"""Vision datasets (reference python/paddle/vision/datasets/).

Counterpart of ``paddle_tpu/vision/datasets.py``, numpy on the host as
there (datasets run inside the loader's worker processes, which see no
card): ``FakeData`` draws the same arrays for the same ``seed`` and index
(numpy ``RandomState``).  No downloaders: each other dataset loads from a
local ``data_file``/``image_path`` the user provides (the reference's
file formats) and raises otherwise.  ``DatasetFolder``'s default loader
reads ``.npy`` files with numpy and other images with PIL where PIL is
installed.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ..io import Dataset


class FakeData(Dataset):
    """Deterministic synthetic image classification data."""

    def __init__(self, num_samples=512, image_shape=(1, 28, 28), num_classes=10,
                 transform=None, seed=0):
        self.num_samples = num_samples
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.transform = transform
        rs = np.random.RandomState(seed)
        self._protos = rs.randn(num_classes, *self.image_shape).astype("f4")
        self._seed = seed

    def __getitem__(self, idx):
        label = idx % self.num_classes
        rs = np.random.RandomState(self._seed + idx)
        img = self._protos[label] + 0.3 * rs.randn(*self.image_shape).astype("f4")
        if self.transform:
            img = self.transform(img)
        return img, np.asarray([label], dtype="int64")

    def __len__(self):
        return self.num_samples


class MNIST(Dataset):
    """MNIST from local idx/gz files (reference vision/datasets/mnist.py
    format; no download path)."""

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=False, backend=None):
        if download and not (image_path and label_path):
            raise RuntimeError(
                "MNIST has no download path; pass image_path=/label_path= "
                "pointing at local train-images-idx3-ubyte.gz / "
                "train-labels-idx1-ubyte.gz")
        if not image_path or not os.path.exists(image_path):
            raise FileNotFoundError(f"MNIST image file not found: {image_path}")
        self.transform = transform
        self.images = self._read_images(image_path)
        self.labels = self._read_labels(label_path)

    @staticmethod
    def _open(path):
        return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")

    def _read_images(self, path):
        with self._open(path) as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.reshape(n, rows, cols)

    def _read_labels(self, path):
        with self._open(path) as f:
            magic, n = struct.unpack(">II", f.read(8))
            data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.astype("int64")

    def __getitem__(self, idx):
        img = self.images[idx].astype("float32")[None, :, :] / 255.0
        if self.transform:
            img = self.transform(img)
        return img, np.asarray([self.labels[idx]], dtype="int64")

    def __len__(self):
        return len(self.images)


class Cifar10(Dataset):
    """CIFAR-10 from a local python-version tar/pickle directory."""

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=False, backend=None):
        if not data_file or not os.path.exists(data_file):
            raise FileNotFoundError(
                "Cifar10 needs data_file= pointing at the local "
                "cifar-10-batches-py directory (no download path)")
        import pickle

        self.transform = transform
        batches = ([f"data_batch_{i}" for i in range(1, 6)]
                   if mode == "train" else ["test_batch"])
        xs, ys = [], []
        for b in batches:
            with open(os.path.join(data_file, b), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(d[b"data"])
            ys.extend(d[b"labels"])
        self.images = np.concatenate(xs).reshape(-1, 3, 32, 32)
        self.labels = np.asarray(ys, dtype="int64")

    def __getitem__(self, idx):
        img = self.images[idx].astype("float32") / 255.0
        if self.transform:
            img = self.transform(img)
        return img, np.asarray([self.labels[idx]], dtype="int64")

    def __len__(self):
        return len(self.images)


class DatasetFolder(Dataset):
    """Image-folder dataset (reference vision/datasets/folder.py); images
    are loaded with numpy (npy) or PIL when available."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        if not os.path.isdir(root):
            raise FileNotFoundError(root)
        self.root = root
        self.transform = transform
        self.loader = loader or _default_loader
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        exts = extensions or (".npy", ".png", ".jpg", ".jpeg", ".bmp")
        for c in classes:
            cdir = os.path.join(root, c)
            for fname in sorted(os.listdir(cdir)):
                if fname.lower().endswith(exts):
                    self.samples.append((os.path.join(cdir, fname),
                                         self.class_to_idx[c]))

    def __getitem__(self, idx):
        path, label = self.samples[idx]
        img = self.loader(path)
        if self.transform:
            img = self.transform(img)
        return img, np.asarray([label], dtype="int64")

    def __len__(self):
        return len(self.samples)


ImageFolder = DatasetFolder


def _default_loader(path):
    if path.endswith(".npy"):
        return np.load(path)
    try:
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"))
    except ImportError as e:
        raise RuntimeError(
            f"cannot load {path}: PIL is unavailable; use .npy files") from e
