"""`paddle.io` equivalent: Dataset / Sampler / DataLoader.

Counterpart of ``paddle_tpu/io/__init__.py`` (reference
python/paddle/fluid/reader.py ``DataLoader``:147 and fluid/dataloader/).
The datasets, samplers, ``default_collate_fn`` and the loader's order,
batching and worker protocol are the JAX package's, numpy draws
included, so a seeded loader yields the same batches in the same order
in both packages.  Two parts differ, because the device is a CUDA card:

- **Workers are spawned with no card.**  ``num_workers > 0`` starts
  worker processes with the ``spawn`` method (a process forked after
  CUDA was initialized cannot use it, and forking a threaded process is
  unsafe), with ``CUDA_VISIBLE_DEVICES=""`` pinned into their
  environment under ``_ENV_PIN_LOCK``, as the JAX package pins
  ``JAX_PLATFORMS=cpu``.  Workers run the dataset and the collate
  function only, and send batches back as numpy arrays.  A dataset that
  does not pickle is served by threads instead, with a warning, as in
  the JAX package.
- **Batches cross in shared memory** (``use_shared_memory=True``, the
  reference's default, which the JAX package ignores): a worker writes
  each array of its batch into a ``multiprocessing.shared_memory``
  segment and sends only its name; the parent copies the array out and
  unlinks the segment.  On the H100 test machine's host, a 77 MB batch
  of 128 ImageNet-sized images moved through the queue's pipe at 77
  MB/s, against 592 MB/s through shared memory (``tools/loader_ipc.py``,
  ``PERF.md``), so 4 workers sending pickled batches delivered about as
  many images a second as one process making them.
  ``use_shared_memory=False`` sends the arrays through the queue.
- **Device prefetch** (``device_prefetch=True``, ``DevicePrefetcher``):
  a background thread copies each batch's arrays into pinned host
  memory and from there to the card on a side stream, and records a
  CUDA event after the copies.  The consumer's stream waits on that
  event when the batch is taken, and every tensor of the batch is
  marked used by that stream (``record_stream``), so the caching
  allocator does not hand its memory out again while the consumer's
  kernels may still read it.  The device is the card: ``feed_sharding``
  names it (a ``torch.device``, ``"gpu:<i>"`` or a place), else the
  dygraph place.  Without a card it raises; it never yields host
  tensors in place of device ones.

``io/data_feed.py`` (the MultiSlot feed and its native parser) comes
with a later slice of the port.
"""
from __future__ import annotations

import itertools
import math
import os
import queue
import threading
import time
from typing import List, Sequence

import numpy as np

from ..monitor import stat_add, stat_set
from ..observe import tracer as otrace
from ..observe.histogram import stat_time


class Dataset:
    """Map-style dataset (reference fluid/dataloader/dataset.py)."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise TypeError("IterableDataset is not subscriptable")

    def __len__(self):
        raise TypeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors: Sequence):
        arrays = [np.asarray(t) if not hasattr(t, "numpy") else t.numpy()
                  for t in tensors]
        n = len(arrays[0])
        if any(len(a) != n for a in arrays):
            raise ValueError("tensors must share dim 0")
        self.tensors = arrays

    def __getitem__(self, idx):
        return tuple(a[idx] for a in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset, self.indices = dataset, list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    if sum(lengths) != len(dataset):
        raise ValueError(f"lengths {lengths} do not sum to the dataset's "
                         f"{len(dataset)}")
    rng = np.random.RandomState(generator if isinstance(generator, int) else None)
    perm = rng.permutation(len(dataset))
    out, ofs = [], 0
    for ln in lengths:
        out.append(Subset(dataset, perm[ofs:ofs + ln].tolist()))
        ofs += ln
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    """Indices from numpy's ``RandomState`` (seeded by an int
    ``generator``), the JAX package's draw."""

    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self.num_samples = num_samples or len(data_source)
        self.generator = generator

    def __iter__(self):
        n = len(self.data_source)
        rng = np.random.RandomState(
            self.generator if isinstance(self.generator, int) else None)
        if self.replacement:
            return iter(rng.randint(0, n, self.num_samples).tolist())
        return iter(rng.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


def _rank_and_world():
    """This process's rank and the world size: ``torch.distributed``'s
    when a group is up, else the launcher's ``PADDLE_TRAINER_ID`` /
    ``PADDLE_TRAINERS_NUM``, else 0 and 1."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return (int(os.environ.get("PADDLE_TRAINER_ID", 0)),
            int(os.environ.get("PADDLE_TRAINERS_NUM", 1)))


class DistributedBatchSampler(Sampler):
    """Shards batches across ranks (reference
    fluid/dataloader/batch_sampler.py DistributedBatchSampler)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        own_rank, world = _rank_and_world()
        self.nranks = num_replicas if num_replicas is not None else world
        self.local_rank = rank if rank is not None else own_rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        indices = list(range(n))
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            rng.shuffle(indices)
        indices += indices[: self.total_size - n]
        local = indices[self.local_rank::self.nranks]
        batch = []
        for i in local:
            batch.append(i)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return int(math.ceil(self.num_samples / self.batch_size))


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        if sampler is None:
            sampler = (RandomSampler(dataset) if shuffle
                       else SequenceSampler(dataset))
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def default_collate_fn(batch: List):
    """Stack samples into numpy batch arrays (reference
    fluid/dataloader/collate.py); float64 becomes float32."""
    sample = batch[0]
    if isinstance(sample, (list, tuple)):
        return tuple(default_collate_fn([b[i] for b in batch])
                     for i in range(len(sample)))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if hasattr(sample, "numpy"):
        return np.stack([np.asarray(b.numpy()) for b in batch])
    arr = np.asarray(batch)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return arr


class _StageIterator:
    """Consumer half of one background pipeline stage: bounded queue,
    ``_END`` marker, exception propagation, stop-event abandonment, and
    the ``input_wait_seconds`` accounting.  ``_PrefetchIterator`` (host
    batch assembly) and ``DevicePrefetcher`` (the copy to the card) are
    this plus a producer thread running ``_stage_fill``."""

    _END = object()

    def __init__(self, queue_size, record_wait=True):
        self._q = queue.Queue(maxsize=queue_size)
        self._exc_box: list = []
        self._stop_evt = threading.Event()
        self._done = False
        # input_wait_seconds is the training loop's stall metric: only
        # the outermost stage records it (an inner stage's queue waits
        # are background-thread idle time, not consumer stalls)
        self._record_wait = record_wait

    def _start(self, target, args):
        # the fill function must not hold a strong ref to self: a running
        # thread would keep the iterator alive forever and __del__ (the
        # worker-reaping trigger on abandonment) would never fire
        self._thread = threading.Thread(target=target, args=args,
                                        daemon=True)
        self._thread.start()

    def close(self):
        """Release the fill thread (and through it any worker processes)
        when the consumer abandons the iterator mid-epoch."""
        stop = self.__dict__.get("_stop_evt")   # None: __init__ raised
        if stop is not None:
            stop.set()

    __del__ = close

    def __iter__(self):
        return self

    def _take(self):
        if self._record_wait:
            t0 = time.perf_counter()
            item = self._q.get()
            stat_time("input_wait_seconds", time.perf_counter() - t0)
            return item
        return self._q.get()

    def __next__(self):
        if self._done:
            # the single _END marker was already consumed and the fill
            # thread has exited: a re-entered exhausted iterator must
            # keep raising StopIteration, not block on an empty queue
            raise StopIteration
        item = self._take()
        if item is self._END:
            self._done = True
            if self._exc_box:
                raise self._exc_box[0]
            raise StopIteration
        return item


class _PrefetchIterator(_StageIterator):
    """Background-thread prefetch of host batches (the reference
    buffered_reader role)."""

    def __init__(self, make_batches, num_workers, prefetch_factor=2,
                 record_wait=True):
        super().__init__(max(2, num_workers * prefetch_factor),
                         record_wait=record_wait)
        self._start(_prefetch_fill,
                    (make_batches, self._q, self._exc_box, self._stop_evt))


def _stage_fill(gen, q, exc_box, stop_evt, end_marker, transform=None):
    """The one background pipeline-stage body (_PrefetchIterator and
    DevicePrefetcher both run this): pull items from ``gen``, optionally
    ``transform`` each, block-put into the bounded queue with stop-event
    polling, surface exceptions through ``exc_box``.

    The ``end_marker`` always reaches the consumer, even when the queue
    is still full of undrained batches: a dropped marker would block
    ``__next__`` forever.  Only an explicit close() abandons delivery."""
    try:
        for b in gen:
            if transform is not None:
                b = transform(b)
            placed = False
            while not stop_evt.is_set():
                try:
                    q.put(b, timeout=0.25)
                    placed = True
                    break
                except queue.Full:
                    continue
            if not placed:
                break
    except BaseException as e:  # noqa: BLE001 - re-raised by the consumer
        exc_box.append(e)
    finally:
        # abandonment path: closing the generator runs its finally,
        # which shuts down any worker processes it spawned
        if hasattr(gen, "close"):
            gen.close()
        while True:
            try:
                q.put(end_marker, timeout=0.25)
                break
            except queue.Full:
                if stop_evt.is_set():
                    break


def _prefetch_fill(make_batches, q, exc_box, stop_evt):
    _stage_fill(make_batches(), q, exc_box, stop_evt,
                _PrefetchIterator._END)


def prefetch_device(sharding=None):
    """The card ``DevicePrefetcher`` copies to: ``sharding`` (a
    ``torch.device``, a place, ``"gpu:<i>"``) or the dygraph place.
    Raises unless it is a CUDA card torch sees."""
    import torch

    from ..dygraph import base

    if sharding is None:
        dev = base.current_device()
    elif isinstance(sharding, torch.device):
        dev = sharding
    else:
        dev = base._torch_device(base._parse_place(sharding))
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(
            f"device_prefetch copies batches to a CUDA card, and the "
            f"target is {dev} (torch sees {torch.cuda.device_count()} "
            f"card(s)); pass device_prefetch=False to keep batches on the "
            f"host")
    return dev


def _map_arrays(batch, fn):
    """``batch`` (nested tuples, lists, dicts) with ``fn`` applied to
    each leaf."""
    if isinstance(batch, dict):
        return {k: _map_arrays(v, fn) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        out = [_map_arrays(v, fn) for v in batch]
        return tuple(out) if isinstance(batch, tuple) else out
    return fn(batch)


def _device_put_batch(batch, device, stream):
    """Copy every array leaf of ``batch`` through pinned host memory to
    ``device`` on ``stream``.  Returns ``(device_batch, bytes_copied)``;
    tensors already on ``device`` pass through untouched."""
    import torch

    n_bytes = 0

    def put(x):
        nonlocal n_bytes
        if isinstance(x, torch.Tensor) and x.device == device:
            return x
        t = x if isinstance(x, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(x))
        n_bytes += t.numel() * t.element_size()
        with torch.cuda.stream(stream):
            return t.pin_memory().to(device, non_blocking=True)

    return _map_arrays(batch, put), n_bytes


def _device_prefetch_fill(it, q, exc_box, stop_evt, device):
    """Background transfer stage: pull host batches, copy them to the
    card on a side stream, queue ``(device batch, event)``.  The
    queue/END/abandonment protocol is _stage_fill's."""
    import torch

    stream = torch.cuda.Stream(device)

    def to_device(b):
        with otrace.span("h2d_prefetch"):
            b, n = _device_put_batch(b, device, stream)
            event = torch.cuda.Event()
            event.record(stream)
            otrace.set_span_args(bytes=n)
        stat_set("h2d_bytes_per_step", n)
        stat_add("h2d_bytes_total", n)
        return b, event

    _stage_fill(it, q, exc_box, stop_evt, DevicePrefetcher._END,
                transform=to_device)


class DevicePrefetcher(_StageIterator):
    """Device-side input prefetch: wraps any batch iterable and copies
    the next ``prefetch_factor`` batches to the card from a background
    thread (pinned host memory, a side stream, an event), so the copies
    overlap the card's compute.  Taking a batch makes the caller's
    current stream wait on its event and marks each of its tensors used
    by that stream (``record_stream``).  Exceptions from the source
    iterable or the copy surface on the consumer's ``next()``.
    ``input_wait_seconds`` (histogram) records how long the consumer
    blocked per batch; ``h2d_bytes_per_step`` (gauge), ``h2d_bytes_total``
    (counter) and the ``h2d_prefetch`` tracer span account the copies."""

    def __init__(self, iterable, prefetch_factor: int = 2, sharding=None):
        device = prefetch_device(sharding)   # raises before a thread starts
        super().__init__(max(int(prefetch_factor), 1))
        self.device = device
        it = iter(iterable)
        if isinstance(it, _StageIterator):
            # this stage is now the outermost: the inner stage's queue
            # waits happen on our background thread and are not
            # training-loop input stalls
            it._record_wait = False
        self._start(_device_prefetch_fill,
                    (it, self._q, self._exc_box, self._stop_evt, device))

    def __next__(self):
        import torch

        batch, event = super().__next__()
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(event)
        _map_arrays(batch, lambda t: t.record_stream(stream)
                    if isinstance(t, torch.Tensor) else None)
        return batch


# guards the CUDA_VISIBLE_DEVICES pin around starting workers
_ENV_PIN_LOCK = threading.Lock()


class _Shared:
    """An array a worker left in a shared-memory segment: its name,
    shape and dtype."""

    __slots__ = ("name", "shape", "dtype")

    def __init__(self, name, shape, dtype):
        self.name, self.shape, self.dtype = name, shape, dtype


def _to_shared(x):
    """A worker's array into a new segment (registered with the
    resource tracker the parent shares, which unlinks what a dead parent
    leaves); anything else as it is."""
    from multiprocessing import shared_memory

    if not isinstance(x, np.ndarray) or x.dtype == object or not x.nbytes:
        return x
    shm = shared_memory.SharedMemory(create=True, size=x.nbytes)
    np.ndarray(x.shape, x.dtype, buffer=shm.buf)[...] = x
    out = _Shared(shm.name, x.shape, x.dtype.str)
    shm.close()
    return out


def _from_shared(x):
    """The parent's copy of a ``_Shared`` array; the segment is
    unlinked (which also drops its resource-tracker entry)."""
    from multiprocessing import shared_memory

    if not isinstance(x, _Shared):
        return x
    shm = shared_memory.SharedMemory(name=x.name)
    try:
        return np.ndarray(x.shape, np.dtype(x.dtype), buffer=shm.buf).copy()
    finally:
        shm.close()
        shm.unlink()


def _start_all(procs):
    """``p.start()`` for every process at once, each on its own thread;
    raises the first error after all have returned.  A spawned start
    blocks until its child has imported the parent's main module and
    read the pickled dataset, so one after another the start-ups add up
    (about 10 s a worker for a full-width ImageNet-shaped ``FakeData``
    on the H100 machine's host)."""
    errors = []

    def start(p):
        try:
            p.start()
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)

    threads = [threading.Thread(target=start, args=(p,),
                                name=f"loader-start-{i}")
               for i, p in enumerate(procs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def _worker_loop(wid, n_workers, dataset, collate, init_fn, task_q,
                 result_q, parent_pid, shared=False):
    """Worker-process body.  Module-level so the spawn start method can
    pickle it by reference.  Polls the task queue with a short timeout
    and watches the parent's liveness: if the parent is SIGKILL'd
    (daemon=True does not cover that), getppid() changes and the worker
    exits instead of surviving as an orphan."""
    import queue as _q

    # Never touch the card from a worker: the parent pinned the env for
    # the spawn; set it here too for workers started some other way.
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    global _worker_info
    _worker_info = WorkerInfo(wid, n_workers, dataset)
    if init_fn is not None:
        init_fn(wid)

    def put_watching_parent(item):
        """Bounded-queue put that also watches parent liveness."""
        while True:
            try:
                result_q.put(item, timeout=2.0)
                return True
            except _q.Full:
                if os.getppid() != parent_pid:
                    return False

    while True:
        try:
            task = task_q.get(timeout=2.0)
        except _q.Empty:
            if os.getppid() != parent_pid:
                return  # parent died; don't orphan
            continue
        if task is None:
            return
        bid, idxs = task
        try:
            batch = collate([dataset[i] for i in idxs])
            if shared:
                batch = _map_arrays(batch, _to_shared)
            ok = put_watching_parent((bid, batch, None))
        except BaseException:  # noqa: BLE001 - surfaced in the parent
            import traceback

            ok = put_watching_parent((bid, None, traceback.format_exc()))
        if not ok:
            return


class DataLoader:
    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False,
                 drop_last=False, collate_fn=None, num_workers=0,
                 use_buffer_reader=True, prefetch_factor=2, use_shared_memory=True,
                 timeout=0, worker_init_fn=None, device_prefetch=False,
                 feed_sharding=None):
        self.dataset = dataset
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.use_shared_memory = use_shared_memory
        self.prefetch_factor = prefetch_factor
        self.use_buffer_reader = use_buffer_reader
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        # device-side input prefetch (DevicePrefetcher): batches come
        # back already on the card named by ``feed_sharding`` (or the
        # dygraph place)
        self.device_prefetch = device_prefetch
        self.feed_sharding = feed_sharding
        # seconds from iter() until the worker processes had started
        # (pickling the dataset into each), the last epoch's
        self.worker_start_seconds = None
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)

    def _batches(self):
        if self._iterable_mode:
            it = iter(self.dataset)
            while True:
                chunk = list(itertools.islice(it, self.batch_size))
                if not chunk:
                    return
                if len(chunk) < self.batch_size and self.drop_last:
                    return
                yield self.collate_fn(chunk)
        elif self.num_workers > 0:
            yield from self._worker_batches()
        else:
            for idxs in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in idxs])

    def _start_workers(self, procs):
        """Start ``procs`` with ``CUDA_VISIBLE_DEVICES=""`` in their
        environment.  Returns False (after a warning, the processes
        reaped) when the dataset, collate_fn or worker_init_fn does not
        pickle; raises on any other failure."""
        import pickle
        import warnings

        # the save/set/restore of the process-global env var must not
        # interleave across loaders iterating concurrently (train+eval),
        # or one thread's restore can leak the pin into the parent
        with _ENV_PIN_LOCK:
            saved = os.environ.get("CUDA_VISIBLE_DEVICES")
            os.environ["CUDA_VISIBLE_DEVICES"] = ""
            try:
                _start_all(procs)
                return True
            except (pickle.PicklingError, TypeError, AttributeError) as e:
                for p in procs:
                    if p.is_alive():
                        p.terminate()
                # spawn pickles (dataset, collate_fn, worker_init_fn) by
                # value; closures and local classes do not pickle
                warnings.warn(
                    f"DataLoader: dataset/collate_fn/worker_init_fn not "
                    f"picklable for spawned workers ({e!r}); falling back "
                    f"to a thread pool (GIL-bound, no worker_init_fn / "
                    f"get_worker_info). Move the dataset class to module "
                    f"scope for real worker processes.", RuntimeWarning,
                    stacklevel=4)
                return False
            except BaseException:
                for p in procs:
                    if p.is_alive():
                        p.terminate()
                raise
            finally:
                if saved is None:
                    os.environ.pop("CUDA_VISIBLE_DEVICES", None)
                else:
                    os.environ["CUDA_VISIBLE_DEVICES"] = saved

    def _worker_batches(self):
        """Worker processes (reference dataloader_iter.py:467
        _DataLoaderIterMultiProcess): workers pull (batch_id, indices)
        tasks, run dataset[i] + collate, and send numpy batches back
        over queues; the parent reassembles in order with a bounded
        in-flight window.  Spawned, never forked, with no card visible
        (see the module docstring); threads serve a dataset that does
        not pickle, and a spawned child still importing an unguarded
        script that iterates a loader at top level."""
        import multiprocessing as mp

        if getattr(mp.current_process(), "_inheriting", False):
            import warnings

            warnings.warn(
                "DataLoader: this process is a spawned worker re-running "
                "an unguarded script top level; serving its loader on "
                "threads.  Wrap the script's entry point in `if __name__ "
                "== '__main__':` to avoid re-executing top-level code "
                "once per worker.", RuntimeWarning, stacklevel=3)
            yield from self._thread_batches()
            return

        ctx = mp.get_context("spawn")
        n_workers = self.num_workers
        task_q = ctx.Queue()
        # one window constant governs both the result-queue capacity and
        # the dispatch in-flight bound
        max_in_flight = max(2, n_workers * self.prefetch_factor)
        result_q = ctx.Queue(maxsize=max_in_flight)
        procs = [ctx.Process(
            target=_worker_loop,
            args=(w, n_workers, self.dataset, self.collate_fn,
                  self.worker_init_fn, task_q, result_q, os.getpid(),
                  bool(self.use_shared_memory)),
            daemon=True) for w in range(n_workers)]
        t0 = time.perf_counter()
        if not self._start_workers(procs):
            yield from self._thread_batches()
            return
        self.worker_start_seconds = time.perf_counter() - t0
        stat_time("loader_worker_start_seconds", self.worker_start_seconds)

        # timeout=0 (the default) means no user deadline: block as long
        # as workers are alive; dead workers are still detected on a
        # liveness poll
        user_timeout = float(self.timeout) if self.timeout else None
        pending = {}  # bid -> batch, out-of-order arrivals
        next_out = 0
        dispatched = 0
        sampler_it = iter(self.batch_sampler)

        def recv():
            nonlocal next_out
            # poll in <=10s slices even under a long user timeout so a
            # dead worker is diagnosed within seconds, not at deadline
            deadline = (time.monotonic() + user_timeout) \
                if user_timeout else None
            while next_out not in pending:
                slice_t = 10.0 if deadline is None else max(
                    0.1, min(10.0, deadline - time.monotonic()))
                try:
                    bid, batch, err = result_q.get(timeout=slice_t)
                except queue.Empty:
                    dead = [w for w, p in enumerate(procs)
                            if not p.is_alive()]
                    if dead:
                        raise RuntimeError(
                            f"DataLoader worker(s) {dead} died without "
                            f"producing their batch") from None
                    if deadline is not None and \
                            time.monotonic() >= deadline:
                        raise RuntimeError(
                            f"DataLoader produced no batch within the "
                            f"configured timeout={user_timeout}s") from None
                    continue
                if err is not None:
                    raise RuntimeError(
                        f"DataLoader worker failed on batch {bid}:\n{err}")
                pending[bid] = _map_arrays(batch, _from_shared)
            out = pending.pop(next_out)
            next_out += 1
            return out

        try:
            exhausted = False
            while True:
                while not exhausted and dispatched - next_out \
                        - len(pending) < max_in_flight:
                    try:
                        idxs = next(sampler_it)
                    except StopIteration:
                        exhausted = True
                        break
                    task_q.put((dispatched, list(idxs)))
                    dispatched += 1
                if next_out >= dispatched and exhausted:
                    return
                yield recv()
        finally:
            for _ in procs:
                task_q.put(None)
            # drain what workers still send before joining them: a
            # worker blocked on a full result queue never reads its stop
            deadline = time.monotonic() + 5.0
            while any(p.is_alive() for p in procs) and \
                    time.monotonic() < deadline:
                try:
                    _map_arrays(result_q.get(timeout=0.1)[1], _from_shared)
                except queue.Empty:
                    pass
            for p in procs:
                p.join(timeout=1)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5)

    def _thread_batches(self):
        from concurrent.futures import ThreadPoolExecutor

        def load(idxs):
            return self.collate_fn([self.dataset[i] for i in idxs])

        in_flight = []
        max_in_flight = self.num_workers * self.prefetch_factor
        with ThreadPoolExecutor(self.num_workers) as pool:
            for idxs in self.batch_sampler:
                in_flight.append(pool.submit(load, idxs))
                while len(in_flight) >= max_in_flight:
                    yield in_flight.pop(0).result()
            for f in in_flight:
                yield f.result()

    def __iter__(self):
        # the card is checked before any thread or worker starts
        device = prefetch_device(self.feed_sharding) \
            if self.device_prefetch else None
        if self.use_buffer_reader:
            it = _PrefetchIterator(self._batches, max(self.num_workers, 1),
                                   self.prefetch_factor,
                                   record_wait=not self.device_prefetch)
        else:
            it = self._batches()
        if self.device_prefetch:
            it = DevicePrefetcher(it, prefetch_factor=self.prefetch_factor,
                                  sharding=device)
        return it

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("length of an IterableDataset loader is unknown")
        return len(self.batch_sampler)


class WorkerInfo:
    """Reference fluid.dataloader worker_info: visible only inside a
    worker process."""

    def __init__(self, wid, num_workers, dataset):
        self.id = wid
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info = None


def get_worker_info():
    return _worker_info  # None in the main process
