#!/usr/bin/env python3
"""How fast a spawned ``DataLoader`` worker can hand a batch to its
parent on this host, beside how fast it makes one.

Three numbers for a batch of the hapi path's size (128 x 3 x 224 x 224
float32, 77 MB):

- ``queue``: a ``multiprocessing`` queue (the loader's transport: the
  batch pickled through a pipe), MB/s into the parent;
- ``shared_memory``: the worker writes the batch into a
  ``multiprocessing.shared_memory`` segment and sends its name, the
  parent copies it out, MB/s;
- ``make``: ms per sample of ``chip_smoke``'s training ``FakeData`` (1000
  classes, flip, normalization) in the parent and in a spawned worker.

    python3 tools/loader_ipc.py [--batches 4] [--side 224]

Prints one JSON line.  Touches no card.
"""
import argparse
import json
import multiprocessing as mp
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _fake(side, classes=1000):
    from paddle_tpu_torch.vision import datasets, transforms as tf

    return datasets.FakeData(
        num_samples=128, image_shape=(3, side, side), num_classes=classes,
        transform=tf.Compose([tf.RandomHorizontalFlip(), tf.Normalize(
            mean=[0.485, 0.456, 0.406], std=[0.229, 0.224, 0.225],
            data_format="CHW")]))


def _make_ms(ds, n=32):
    t0 = time.perf_counter()
    for i in range(n):
        ds[i]
    return (time.perf_counter() - t0) / n * 1e3


def _sender(q, shape, batches, use_shm, side):
    from multiprocessing import shared_memory

    q.put(("make_ms", _make_ms(_fake(side, classes=10))))
    arr = np.random.RandomState(0).randn(*shape).astype("float32")
    for _ in range(batches):
        if use_shm:
            shm = shared_memory.SharedMemory(create=True, size=arr.nbytes)
            np.ndarray(arr.shape, arr.dtype, buffer=shm.buf)[...] = arr
            q.put(("shm", shm.name))
            shm.close()
        else:
            q.put(("array", arr))


def _receive(batches, use_shm, side, shape):
    from multiprocessing import shared_memory

    ctx = mp.get_context("spawn")
    q = ctx.Queue(maxsize=2)
    p = ctx.Process(target=_sender, args=(q, shape, batches, use_shm, side))
    p.start()
    _, worker_make_ms = q.get()
    got, t0 = 0, None
    for _ in range(batches):
        kind, val = q.get()
        if kind == "shm":
            shm = shared_memory.SharedMemory(name=val)
            out = np.ndarray(shape, np.float32, buffer=shm.buf).copy()
            shm.close()
            shm.unlink()
        else:
            out = val
        if t0 is None:      # timed from the first batch's arrival
            t0 = time.perf_counter()
        else:
            got += out.nbytes
    mbs = got / 1e6 / (time.perf_counter() - t0)
    p.join(timeout=60)
    return mbs, worker_make_ms


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--side", type=int, default=224)
    a = ap.parse_args()
    shape = (128, 3, a.side, a.side)
    queue_mbs, worker_ms = _receive(a.batches + 1, False, a.side, shape)
    shm_mbs, _ = _receive(a.batches + 1, True, a.side, shape)
    print(json.dumps({
        "tool": "loader_ipc", "batch_mb": int(np.prod(shape)) * 4 / 1e6,
        "queue_mb_per_s": queue_mbs, "shared_memory_mb_per_s": shm_mbs,
        "make_ms_per_sample_parent": _make_ms(_fake(a.side, classes=10)),
        "make_ms_per_sample_worker": worker_ms, "cpus": os.cpu_count()}),
        flush=True)


if __name__ == "__main__":
    main()
