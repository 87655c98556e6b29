"""PyTorch port: the MultiSlot data feed (``native.parse_multislot`` on
``csrc/data_feed.cc``, ``io.MultiSlotDataFeed``) and the filesystem
clients (``distributed.fleet.utils.fs``), against the JAX package.

- The native parser (a plain-C library built with the host's g++),
  the port's Python fallback and the JAX package's parser give the same
  values, LoD offsets and dtypes on seeded Criteo-layout text (13 dense
  floats, 26 ids, blank and CRLF lines), and the same errors on
  malformed lines; a host without the library counts each fallback
  parse.
- ``MultiSlotDataFeed`` yields the JAX package's batches (dense slots
  as [batch, dim], LoD slots as values + offsets), the last partial
  batch included, over several files; a dense slot of the wrong width
  is refused.
- ``LocalFS`` in a temporary directory; ``HDFSClient`` builds the
  ``hadoop fs`` command line and raises ``ExecuteError`` without a
  hadoop install.
"""
import os

import numpy as np
import pytest

import paddle_tpu.io as jio
import paddle_tpu.native as jnative
import paddle_tpu_torch.io as tio
import paddle_tpu_torch.native as tnative
from paddle_tpu_torch.distributed.fleet.utils import (ExecuteError,
                                                      HDFSClient, LocalFS)
from paddle_tpu_torch.monitor import stat_get, stat_reset

SLOTS = [("dense", "f", 13), ("ids", "u"), ("clicks", "u", 1)]
TYPES = "fuu"


def criteo_text(n, seed=0, crlf=False):
    """``n`` instances: 13 dense floats, a variable number (1-26) of
    uint64 ids, one click label; a blank line every 7 instances."""
    rs = np.random.RandomState(seed)
    lines = []
    for i in range(n):
        dense = " ".join(f"{v:.6g}" for v in rs.randn(13) * 10)
        k = rs.randint(1, 27)
        ids = " ".join(str(v) for v in rs.randint(0, 2 ** 62, k,
                                                  dtype=np.int64))
        lines.append(f"13 {dense} {k} {ids} 1 {rs.randint(0, 2)}")
        if i % 7 == 6:
            lines.append("  ")
    end = "\r\n" if crlf else "\n"
    return (end.join(lines) + end).encode()


def _same(a, b):
    assert a[0] == b[0]
    assert len(a[1]) == len(b[1])
    for (va, la), (vb, lb) in zip(a[1], b[1]):
        assert va.dtype == vb.dtype and la.dtype == lb.dtype
        np.testing.assert_array_equal(va, vb)
        np.testing.assert_array_equal(la, lb)


@pytest.mark.parametrize("crlf", [False, True])
def test_native_fallback_and_jax_parse_alike(crlf):
    assert tnative.has_native()
    data = criteo_text(50, crlf=crlf)
    got = tnative.parse_multislot(data, TYPES)
    assert got[0] == 50
    _same(got, tnative._parse_multislot_py(data, TYPES))
    _same(got, jnative.parse_multislot(data, TYPES))
    _same(got, tnative.parse_multislot(data.decode(), TYPES))


@pytest.mark.parametrize("bad", [
    b"13 1 2\n",                   # fewer dense values than counted
    b"x 1\n",                      # a count that is not a number
    b"-1\n",                       # a negative count
    b"1 1.5 1 7 1 0 9\n",          # a trailing token
    b"1 1.5 1 zz 1 0\n",           # an id that is not a number
    b"1 1.5 1 99999999999999999999999 1 0\n",   # an id out of range
    b"1 0x10 1 7 1 0\n",           # a hex float
    b"1 3.5.1 1 7 1 0\n",          # a float cut mid-token
    b"1 1_0 1 7 1 0\n",            # a Python-only literal
])
def test_malformed_lines_raise_alike(bad):
    errs = []
    for parse in (tnative.parse_multislot, tnative._parse_multislot_py,
                  jnative.parse_multislot):
        with pytest.raises(ValueError) as e:
            parse(b"1 2.0 1 3 1 1\n" + bad, TYPES)
        errs.append(str(e.value))
    assert errs[0] == errs[1] == errs[2] and "at line 1" in errs[0]


def test_bad_slot_type_refused():
    with pytest.raises(ValueError, match="slot type must be 'f' or 'u'"):
        tnative.parse_multislot(b"1 1\n", "fx")


def test_fallback_counted_without_the_library(monkeypatch):
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_lib_tried", True)
    stat_reset("data_feed_parse_fallback")
    data = criteo_text(5)
    _same(tnative.parse_multislot(data, TYPES),
          jnative.parse_multislot(data, TYPES))
    assert stat_get("data_feed_parse_fallback") == 1


def test_feed_batches_equal_jax_over_files(tmp_path):
    paths = []
    for i, n in enumerate((23, 9)):
        p = tmp_path / f"part-{i}"
        p.write_bytes(criteo_text(n, seed=i))
        paths.append(str(p))
    got = list(tio.MultiSlotDataFeed(SLOTS, 8).read_files(paths))
    want = list(jio.MultiSlotDataFeed(SLOTS, 8).read_files(paths))
    assert [len(b["clicks"][1]) - 1 for b in got] == [8, 8, 7, 8, 1]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            for a, b in zip(g[k], w[k]):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
    assert got[0]["dense"][0].shape == (8, 13)
    assert got[-1]["clicks"][0].shape == (1, 1)


def test_dense_slot_of_wrong_width_refused():
    feed = tio.MultiSlotDataFeed([("dense", "f", 2), ("ids", "u")], 4)
    with pytest.raises(ValueError, match="declared dim 2"):
        list(feed._batches(*feed.parse(b"2 1 2 1 5\n3 1 2 3 1 6\n")))


def test_local_fs(tmp_path):
    fs = LocalFS()
    root = str(tmp_path / "a")
    fs.mkdirs(os.path.join(root, "d"))
    f = os.path.join(root, "f.txt")
    fs.touch(f)
    with pytest.raises(ExecuteError, match="already exists"):
        fs.touch(f, exist_ok=False)
    assert fs.is_exist(f) and fs.is_file(f) and fs.is_dir(root)
    assert fs.ls_dir(root) == (["d"], ["f.txt"])
    assert fs.ls_dir(str(tmp_path / "missing")) == ([], [])
    g = os.path.join(root, "g.txt")
    fs.upload(f, g)
    fs.mv(g, os.path.join(root, "h.txt"))
    with pytest.raises(ExecuteError):
        fs.mv(f, os.path.join(root, "h.txt"))
    fs.mv(f, os.path.join(root, "h.txt"), overwrite=True)
    fs.download(os.path.join(root, "h.txt"), str(tmp_path / "back.txt"))
    assert os.path.exists(tmp_path / "back.txt")
    fs.delete(root)
    assert not fs.is_exist(root)


def test_hdfs_client_without_hadoop(tmp_path):
    client = HDFSClient(str(tmp_path / "hadoop"),
                        configs={"fs.default.name": "hdfs://nn:9000"})
    assert client.command("-ls", "/data") == [
        str(tmp_path / "hadoop" / "bin" / "hadoop"), "fs", "-D",
        "fs.default.name=hdfs://nn:9000", "-ls", "/data"]
    with pytest.raises(ExecuteError, match="hadoop binary not found"):
        client.ls_dir("/data")
    with pytest.raises(ExecuteError, match="hadoop binary not found"):
        client.mkdirs("/data")
    assert client.is_exist("/data") is False
    assert client.is_dir("/data") is False
