"""PyTorch port: ``paddle_tpu_torch.io`` (datasets, samplers, collate,
``DataLoader`` with spawned workers, device prefetch) against the JAX
package's ``paddle_tpu.io``, on the CPU.

- Samplers, ``random_split``, ``DistributedBatchSampler`` and
  ``default_collate_fn`` draw and stack with numpy in both packages: the
  same seeds give the same indices and the same arrays, exactly.
- ``DataLoader`` gives the JAX package's batches in its order, with 0
  workers and with 2 spawned worker processes.  A worker sees no card:
  ``CUDA_VISIBLE_DEVICES`` is the empty string in it and torch never
  initialized CUDA there; the parent's environment is as it was.
  Workers send numpy, in shared-memory segments by default (the same
  batches as through the queue, no segment left behind); a worker's
  error reaches the consumer; a dataset that does not pickle is served
  by threads, with a warning.
- ``device_prefetch=True`` raises without a card, before any thread or
  worker starts.  The copy stage's order (pinned copy on the side
  stream, event, the consumer's stream waits on it, ``record_stream`` on
  every tensor) is checked with stand-in stream objects, since the copy
  itself needs the card (``chip_smoke.py`` drives it there).
"""
import os
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu.io as jio
import paddle_tpu_torch.io as tio
from paddle_tpu_torch.observe.histogram import histogram

from torch_io_datasets import Boom, Squares, WhereAmI


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_samplers_draw_the_jax_packages_indices():
    data = list(range(23))
    for kw in ({}, {"replacement": True, "num_samples": 40}):
        assert list(tio.RandomSampler(data, generator=7, **kw)) == \
            list(jio.RandomSampler(data, generator=7, **kw))
    for shuffle, drop in ((False, False), (True, True)):
        j = jio.BatchSampler(data, jio.RandomSampler(data, generator=3)
                             if shuffle else None, batch_size=5,
                             drop_last=drop)
        t = tio.BatchSampler(data, tio.RandomSampler(data, generator=3)
                             if shuffle else None, batch_size=5,
                             drop_last=drop)
        assert list(t) == list(j) and len(t) == len(j)


def test_random_split_and_distributed_sampler_match_jax():
    data = tio.TensorDataset([np.arange(17, dtype="f4")])
    jparts = jio.random_split(jio.TensorDataset([np.arange(17, dtype="f4")]),
                              [10, 7], generator=5)
    tparts = tio.random_split(data, [10, 7], generator=5)
    assert [p.indices for p in tparts] == [p.indices for p in jparts]
    for rank in (0, 1, 2):
        j = jio.DistributedBatchSampler(list(range(17)), 4, num_replicas=3,
                                        rank=rank, shuffle=True)
        t = tio.DistributedBatchSampler(list(range(17)), 4, num_replicas=3,
                                        rank=rank, shuffle=True)
        j.set_epoch(2)
        t.set_epoch(2)
        assert list(t) == list(j) and len(t) == len(j)


def test_default_collate_fn_matches_jax():
    rs = np.random.RandomState(0)
    samples = [({"img": rs.randn(2, 3), "id": i}, np.float64(i) / 3,
                torch.arange(3) * i) for i in range(4)]
    jax_samples = [(d, f, t.numpy()) for d, f, t in samples]
    _same(jio.default_collate_fn(jax_samples),
          tio.default_collate_fn(samples))
    out = tio.default_collate_fn(samples)
    assert out[0]["img"].dtype == np.float32


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_batches_equal_jax_in_order(workers):
    from paddle_tpu.vision.datasets import FakeData as JFake
    from paddle_tpu_torch.vision.datasets import FakeData as TFake

    j = jio.DataLoader(JFake(num_samples=14, image_shape=(2, 3, 3)),
                       batch_sampler=jio.BatchSampler(
                           jio.RandomSampler(list(range(14)), generator=1),
                           batch_size=4))
    t = tio.DataLoader(TFake(num_samples=14, image_shape=(2, 3, 3)),
                       batch_sampler=tio.BatchSampler(
                           tio.RandomSampler(list(range(14)), generator=1),
                           batch_size=4), num_workers=workers)
    jb, tb = list(j), list(t)
    assert len(tb) == len(jb) == 4
    for a, b in zip(jb, tb):
        _same(tuple(np.asarray(x) for x in a), b)
        assert all(isinstance(x, np.ndarray) for x in b)


def test_workers_see_no_card_and_the_parent_env_is_kept():
    before = os.environ.get("CUDA_VISIBLE_DEVICES")
    rows = np.concatenate(list(tio.DataLoader(
        WhereAmI(), batch_size=2, num_workers=2, use_buffer_reader=False)))
    assert os.environ.get("CUDA_VISIBLE_DEVICES") == before
    pids, cuda_init, pinned, wid = rows.T
    assert os.getpid() not in set(pids.tolist())
    assert not cuda_init.any() and pinned.all()
    assert set(wid.tolist()) <= {0, 1} and (wid >= 0).all()
    assert tio.get_worker_info() is None


def test_shared_memory_batches_equal_pickled_ones_and_leave_nothing(
        monkeypatch):
    from multiprocessing import shared_memory

    names, real = [], tio._from_shared

    def from_shared(x):
        if isinstance(x, tio._Shared):
            names.append(x.name)
        return real(x)

    monkeypatch.setattr(tio, "_from_shared", from_shared)
    got = [list(tio.DataLoader(Squares(), batch_size=4, num_workers=2,
                               use_shared_memory=shared))
           for shared in (True, False)]
    for a, b in zip(*got):
        _same(a, b)
    assert len(got[0]) == 5 and len(names) == 10   # two arrays a batch
    for name in names:   # each segment was unlinked after its copy
        with pytest.raises(FileNotFoundError):
            shared_memory.SharedMemory(name=name)


def test_worker_error_reaches_the_consumer():
    with pytest.raises(RuntimeError, match="synthetic decode failure"):
        list(tio.DataLoader(Boom(), batch_size=2, num_workers=2,
                            use_buffer_reader=False))


def test_unpicklable_dataset_is_served_by_threads():
    class Local(tio.Dataset):
        def __len__(self):
            return 6

        def __getitem__(self, i):
            return np.array([i], "i8")

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        batches = list(tio.DataLoader(Local(), batch_size=2, num_workers=2))
    assert [b.ravel().tolist() for b in batches] == [[0, 1], [2, 3], [4, 5]]
    assert any("thread pool" in str(x.message) for x in w)


def test_worker_start_seconds_and_input_wait_are_recorded():
    histogram("input_wait_seconds").reset()
    loader = tio.DataLoader(Squares(), batch_size=4, num_workers=2)
    batches = list(loader)
    assert len(batches) == 5
    assert loader.worker_start_seconds > 0
    # one wait per batch plus the end marker's
    assert histogram("input_wait_seconds").summary()["count"] == 6


def test_iterable_dataset_and_exhausted_iterator():
    class Stream(tio.IterableDataset):
        def __iter__(self):
            return iter(np.arange(10, dtype="f4"))

    loader = tio.DataLoader(Stream(), batch_size=4, drop_last=True)
    it = iter(loader)
    assert [b.tolist() for b in it] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    with pytest.raises(StopIteration):
        next(it)
    with pytest.raises(TypeError):
        len(loader)


def test_device_prefetch_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from paddle_tpu_torch.dygraph import base

    prev = base._state.place
    base._state.place = "cpu"
    try:
        loader = tio.DataLoader(Squares(), batch_size=4, num_workers=2,
                                device_prefetch=True)
        with pytest.raises(RuntimeError, match="CUDA card"):
            iter(loader)
        assert loader.worker_start_seconds is None   # nothing started
        with pytest.raises(RuntimeError, match="CUDA card"):
            tio.DevicePrefetcher([1], sharding=torch.device("cpu"))
    finally:
        base._state.place = prev


def test_device_prefetch_copies_on_a_side_stream_and_waits(monkeypatch):
    """Stand-ins for the stream, the event and the pinned copy record
    what the stage does, in order, with the batches on the CPU."""
    calls = []

    class Stream:
        def __init__(self, device=None):
            self.name = "side" if device is not None else "consumer"

        def wait_event(self, event):
            calls.append(("wait", self.name, event.n))

    class Event:
        count = 0

        def record(self, stream):
            Event.count += 1
            self.n = Event.count
            calls.append(("record", stream.name, self.n))

    class StreamGuard:
        def __init__(self, stream):
            self.stream = stream

        def __enter__(self):
            calls.append(("enter", self.stream.name))

        def __exit__(self, *exc):
            return False

    consumer = Stream()
    monkeypatch.setattr(torch.cuda, "Stream", Stream)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "stream", StreamGuard)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: consumer)
    monkeypatch.setattr(tio, "prefetch_device", lambda s: torch.device("cpu"))
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda t: t.clone())
    monkeypatch.setattr(torch.Tensor, "record_stream",
                        lambda t, s: calls.append(("record_stream", s.name)))
    batches = list(tio.DataLoader(Squares(), batch_size=8,
                                  device_prefetch=True))
    assert [b[1].ravel().tolist() for b in batches] == \
        [list(range(0, 8)), list(range(8, 16)), list(range(16, 20))]
    assert all(isinstance(x, torch.Tensor) for b in batches for x in b)
    # per batch: two leaves copied on the side stream, its event recorded
    # there, then the consumer waits on that event and marks both leaves
    per_batch = [c for c in calls if c[0] != "enter"]
    assert per_batch[:1] == [("record", "side", 1)]
    waits = [c for c in calls if c[0] == "wait"]
    assert waits == [("wait", "consumer", n) for n in (1, 2, 3)]
    assert sum(c == ("record_stream", "consumer") for c in calls) == 6
    assert sum(c == ("enter", "side") for c in calls) == 6
