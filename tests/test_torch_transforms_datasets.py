"""PyTorch port: ``vision/transforms.py`` and ``vision/datasets.py``
against the JAX package's, on the CPU.

- ``FakeData`` gives the JAX package's arrays for the same seed and
  index, exactly (numpy ``RandomState`` on both sides).
- ``Resize`` is numpy on the host; the JAX package's calls
  ``jax.image.resize`` (antialiased when shrinking).  They agree within
  1e-5 of the reference's largest magnitude at bilinear, nearest
  (exactly) and bicubic, shrinking and growing, CHW, HWC and 2-D: both
  are float32 weight matrices over the same sample positions, summed in
  other orders (measured about 2e-6).
- The random transforms draw from numpy's global stream in both
  packages: under one ``np.random.seed`` they flip and crop the same
  samples.  The others agree exactly.
- ``MNIST``, ``Cifar10`` and ``DatasetFolder`` read the same local files
  to the same arrays (PNG through PIL, which this host has and the
  card's machine may not); a download request raises.
"""
import gzip
import os
import pickle
import struct

import numpy as np
import pytest

from paddle_tpu.vision import datasets as jds
from paddle_tpu.vision import transforms as jtf
from paddle_tpu_torch.vision import datasets as tds
from paddle_tpu_torch.vision import transforms as ttf

RESIZE_RTOL = 1e-5


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_fake_data_is_the_jax_packages():
    kw = dict(num_samples=9, image_shape=(3, 5, 4), num_classes=4, seed=3)
    j, t = jds.FakeData(**kw), tds.FakeData(**kw)
    assert len(t) == len(j) == 9
    for i in (0, 4, 8):
        for a, b in zip(j[i], t[i]):
            _eq(a, b)


@pytest.mark.parametrize("method", ["bilinear", "nearest", "bicubic"])
@pytest.mark.parametrize("shape,size", [
    ((3, 20, 24), (9, 13)),      # CHW, shrinking (antialiased)
    ((3, 8, 6), (17, 21)),       # CHW, growing
    ((12, 10, 3), (5, 22)),      # HWC, one axis each way
    ((16, 16), (7, 7)),          # 2-D
])
def test_resize_matches_jax_image_resize(method, shape, size):
    x = np.random.RandomState(0).randn(*shape).astype("f4")
    want = jtf.Resize(size, method)(x)
    got = ttf.Resize(size, method)(x)
    assert got.shape == want.shape and got.dtype == np.float32
    err = np.abs(got - np.asarray(want)).max()
    if method == "nearest":
        assert err == 0.0
    assert err <= RESIZE_RTOL * np.abs(want).max(), err


def test_random_transforms_draw_like_jax():
    img = np.random.RandomState(1).randn(3, 12, 10).astype("f4")
    for make in (lambda p: p.RandomHorizontalFlip(0.5),
                 lambda p: p.RandomCrop(8, padding=2)):
        for seed in range(6):
            np.random.seed(seed)
            a = make(jtf)(img)
            np.random.seed(seed)
            b = make(ttf)(img)
            _eq(a, b)


def test_deterministic_transforms_equal_jax():
    rs = np.random.RandomState(2)
    u8 = (rs.rand(10, 12, 3) * 255).astype("uint8")
    chw = rs.randn(3, 11, 13).astype("f4")
    for make, x in (
            (lambda p: p.Compose([p.ToTensor(),
                                  p.Normalize([0.5] * 3, [0.25] * 3)]), u8),
            (lambda p: p.ToTensor("HWC"), u8),
            (lambda p: p.Normalize(mean=[0.485, 0.456, 0.406],
                                   std=[0.229, 0.224, 0.225],
                                   data_format="CHW"), chw),
            (lambda p: p.Normalize(0.5, 2.0), chw),
            (lambda p: p.CenterCrop(8), chw),
            (lambda p: p.CenterCrop((6, 4)), u8)):
        _eq(make(jtf)(x), make(ttf)(x))


def test_transforms_never_import_torch():
    assert "torch" not in vars(ttf) and "torch" not in vars(tds)


def _write_mnist(tmp_path, n=5):
    rs = np.random.RandomState(4)
    imgs = rs.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rs.randint(0, 10, n).astype(np.uint8)
    ip, lp = str(tmp_path / "img.gz"), str(tmp_path / "lbl.gz")
    with gzip.open(ip, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with gzip.open(lp, "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return ip, lp


def test_mnist_and_cifar10_read_local_files_like_jax(tmp_path):
    ip, lp = _write_mnist(tmp_path)
    j, t = jds.MNIST(ip, lp), tds.MNIST(ip, lp)
    assert len(t) == len(j) == 5
    for i in range(5):
        for a, b in zip(j[i], t[i]):
            _eq(a, b)
    rs = np.random.RandomState(5)
    cdir = tmp_path / "cifar"
    cdir.mkdir()
    for name in ["test_batch"] + [f"data_batch_{i}" for i in range(1, 6)]:
        with open(cdir / name, "wb") as f:
            pickle.dump({b"data": rs.randint(0, 256, (2, 3072)).astype(
                np.uint8), b"labels": [1, 7]}, f)
    for mode in ("train", "test"):
        j = jds.Cifar10(str(cdir), mode=mode)
        t = tds.Cifar10(str(cdir), mode=mode)
        assert len(t) == len(j)
        for a, b in zip(j[len(j) - 1], t[len(t) - 1]):
            _eq(a, b)
    with pytest.raises(RuntimeError, match="download"):
        tds.MNIST(download=True)
    with pytest.raises(FileNotFoundError):
        tds.Cifar10(str(tmp_path / "missing"))


def test_dataset_folder_reads_npy_and_png_like_jax(tmp_path):
    from PIL import Image

    rs = np.random.RandomState(6)
    for c in ("cat", "dog"):
        os.makedirs(tmp_path / c)
        np.save(tmp_path / c / "a.npy", rs.randn(3, 4, 4).astype("f4"))
        Image.fromarray((rs.rand(5, 6, 3) * 255).astype(np.uint8)).save(
            tmp_path / c / "b.png")
    j = jds.DatasetFolder(str(tmp_path))
    t = tds.DatasetFolder(str(tmp_path), transform=None)
    assert t.class_to_idx == j.class_to_idx == {"cat": 0, "dog": 1}
    assert len(t) == len(j) == 4
    for i in range(4):
        for a, b in zip(j[i], t[i]):
            _eq(a, b)
    assert tds.ImageFolder is tds.DatasetFolder
