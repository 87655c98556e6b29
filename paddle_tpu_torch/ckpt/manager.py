"""Asynchronous, atomic checkpoint manager with retention + integrity.

Counterpart of ``paddle_tpu/ckpt/manager.py``:

- **Async**: ``save(step, scope=...)`` snapshots the scope on the
  caller's thread (``state.take_snapshot``: a drain, device clones and
  copies to pinned host buffers enqueued on a side stream), then hands
  serialization + file writes to a background writer thread, which waits
  for the copies' event first.  A queued-but-unstarted save is COALESCED
  away when a newer one arrives (the newest state wins), so at most one
  save is queued and one written: three sets of pinned buffers, reused
  from save to save.  Coalescing applies to single-process managers
  only: with ``world_size > 1`` pending saves queue strictly FIFO (at
  most ``_MAX_PENDING_SAVES``, then ``save`` blocks), because the commit
  barriers need every rank's writer to run the same step sequence.
- **Atomic**: shards are written into ``step_<N>.tmp``; the commit
  fsyncs every file, writes a SHA-256 manifest of every file, fsyncs it,
  and renames the directory to ``step_<N>``.  A crash at any point
  before the rename leaves only a ``.tmp`` directory that restore never
  looks at; corruption after the rename is caught by the hash check.
- **Integrity + fallback**: ``restore()`` validates the manifest
  (existence, size, SHA-256 of every file) and falls back to the newest
  *intact* step when the latest is torn or corrupt.
- **Retention**: the ``keep_n`` newest steps plus every
  ``keep_every_n_steps`` multiple survive GC; stale ``.tmp`` leftovers
  are swept too.

The on-disk layout is the JAX package's, byte for byte:
``step_<N>/shard_r0.npz``, ``meta_r0.json`` (``"format": 1``, ``vars``
with the dtype strings, ``host_state``) and ``MANIFEST.json``.  bfloat16
and float8 values are written as their raw bits (int16 / uint8 arrays)
under the JAX package's dtype strings and read back through ``torch``
views, so neither side needs ``ml_dtypes`` and each package reads the
other's checkpoints.  The generator's state is written under the port's
own dtype string ``torch_generator``.

- **Several processes**: every rank writes exactly its own shard file
  (``shard_r<k>.npz`` + ``meta_r<k>.json``): a rank other than 0 only
  its :class:`~.state.LocalShard` blocks, rank 0 the replicated values
  too.  Three barriers order the commit, ``mkdir`` / ``written`` /
  ``committed``: rank 0 hashes, manifests (``world_size`` in
  ``MANIFEST.json``) and renames only after every rank wrote, and every
  rank's save returns once the step is visible.  The barrier is
  ``barrier=`` (a callable of a tag): :class:`KVBarrier` over the fleet
  KV HTTP server (``distributed/fleet/utils/http_server.py``), else
  ``_default_barrier``, which meets on the live ``torch.distributed``
  group's store (the JAX package's ``sync_global_devices``).  ``rank``
  and ``world_size`` default to the live group's.  A restore
  re-assembles each sharded value from the rank files (by origin, else
  in rank order along axis 0) at any reading world size.

Observability: ``ckpt/snapshot|serialize|write|commit`` tracer spans,
``ckpt_save_blocking_seconds`` / ``ckpt_write_seconds`` histograms,
``ckpt_bytes_written`` / ``ckpt_saves`` / ``ckpt_save_failures`` /
``ckpt_saves_coalesced`` / ``ckpt_restores`` / ``ckpt_restore_fallbacks``
/ ``ckpt_gc_removed`` counters, and ``stats``: one dict a save (its
blocking seconds; the writer's wait for the copies, serialize + write,
fsync, hash and commit seconds; its bytes).
"""
from __future__ import annotations

import atexit
import collections
import hashlib
import json
import logging
import os
import re
import shutil
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..framework import flags as _flags
from ..framework.place import DeviceLike, default_device
from ..framework.scope import to_tensor
from ..monitor import stat_add, stat_time
from ..observe import flight as _flight
from ..observe import tracer as otrace
from .state import (GeneratorState, LocalShard, restore_scope,
                    take_snapshot)

logger = logging.getLogger(__name__)

__all__ = ["CheckpointManager", "CheckpointError", "KVBarrier", "wait_all"]

_STEP_RE = re.compile(r"^step_(\d+)$")
_TMP_RE = re.compile(r"^step_(\d+)\.tmp$")
_MANIFEST = "MANIFEST.json"
GENERATOR_DTYPE = "torch_generator"
# dtype string -> (numpy carrier of its bits, torch dtype)
_BITS = {"bfloat16": (np.int16, torch.bfloat16),
         "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
         "float8_e5m2": (np.uint8, torch.float8_e5m2)}
_TORCH_BITS = {t: (name, c) for name, (c, t) in _BITS.items()}
# FIFO (several-rank) backlog cap: save() blocks once this many snapshots
# are pending, bounding host memory when the writer falls behind
_MAX_PENDING_SAVES = 2


class CheckpointError(RuntimeError):
    """A checkpoint could not be written or no intact one restored."""


# every live manager, so Executor.close()/atexit can drain pending saves
_LIVE: "weakref.WeakSet[CheckpointManager]" = weakref.WeakSet()


def wait_all(raise_errors: bool = True) -> None:
    """Drain pending async saves of every live manager."""
    for m in list(_LIVE):
        try:
            m.wait()
        except CheckpointError:
            if raise_errors:
                raise
            logger.exception("checkpoint drain failed for %s", m.dirname)


def _atexit_drain():  # pragma: no cover - interpreter teardown
    wait_all(raise_errors=False)


atexit.register(_atexit_drain)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _fsync_dir(path: str) -> None:
    if not _flags.flag("ckpt_fsync"):
        return
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:  # platforms without directory fds
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _to_np(v) -> Tuple[np.ndarray, dict]:
    """A host value as (the array written, its meta record)."""
    if isinstance(v, LocalShard):
        arr, rec = _to_np(v.array)
        rec.update(sharded=True, global_shape=list(v.global_shape))
        if v.origin is not None:
            rec["origin"] = list(v.origin)
        return arr, rec
    if isinstance(v, GeneratorState):
        arr = v.state.numpy()
        return arr, {"dtype": GENERATOR_DTYPE, "shape": list(arr.shape),
                     "sharded": False, "generator_device": v.device}
    if v.dtype in _TORCH_BITS:
        name, carrier = _TORCH_BITS[v.dtype]
        arr = v.view(torch.int16 if carrier is np.int16
                     else torch.uint8).numpy()
        return arr, {"dtype": name, "shape": list(arr.shape),
                     "sharded": False}
    arr = v.numpy()
    return arr, {"dtype": str(arr.dtype), "shape": list(arr.shape),
                 "sharded": False}


def _from_np(arr: np.ndarray, rec: dict):
    """The value a meta record describes: a CPU tensor, a
    ``GeneratorState``, or (a dtype torch has no tensor for) the array."""
    dtype = rec["dtype"]
    if dtype == GENERATOR_DTYPE:
        return GeneratorState(torch.from_numpy(np.array(arr, np.uint8)),
                              rec.get("generator_device", "cpu"))
    if dtype in _BITS:
        carrier, tdt = _BITS[dtype]
        return torch.from_numpy(np.ascontiguousarray(arr).view(carrier)
                                .copy()).view(tdt)
    try:
        want = np.dtype(dtype)
    except TypeError:
        raise CheckpointError(
            f"dtype {dtype!r} has no reader in the port's checkpoints")
    arr = arr.view(want) if arr.dtype != want else arr
    try:
        return to_tensor(arr)
    except TypeError:  # e.g. a JAX PRNG key's uint32 on an older torch
        return arr


class KVBarrier:
    """Rendezvous over the fleet KV HTTP server: every rank PUTs
    ``ckpt_barrier/<prefix><tag>:g<gen>/<rank>`` and polls until all
    ranks arrived (the JAX package's barrier, line for line).

    ``gen`` counts prior uses of the same tag by this instance, so a
    re-save of one step never reuses live keys; per tag, not a global
    call counter, so that after an asymmetric failure the ranks re-align
    at the next fresh tag.  Keys from two completed barriers back are
    swept by rank 0.  Across a restart against a long-lived KV server,
    pass a run-unique ``prefix``: a collision can at worst time out,
    since the commit never renames before the post-write barrier.

    ``dead_ranks_fn`` (optional): a zero-arg callable returning the
    currently dead-listed ranks; a barrier still waiting on one of them
    fails fast with the rank named instead of waiting out the
    deadline."""

    def __init__(self, endpoint: str, rank: int, world_size: int,
                 timeout: float = 120.0, prefix: str = "",
                 dead_ranks_fn: Optional[Callable[[], Sequence[int]]]
                 = None):
        self.endpoint = endpoint.rstrip("/")
        if not self.endpoint.startswith("http"):
            self.endpoint = "http://" + self.endpoint
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.timeout = float(timeout)
        self.prefix = (prefix + ":") if prefix else ""
        self.dead_ranks_fn = dead_ranks_fn
        self._tag_gens: Dict[str, int] = {}
        self._past_tags: list = []

    def _url(self, tag: str, rank: int) -> str:
        return f"{self.endpoint}/ckpt_barrier/{self.prefix}{tag}/{rank}"

    def __call__(self, tag: str) -> None:
        import urllib.error
        import urllib.request

        gen = self._tag_gens.get(tag, 0)
        self._tag_gens[tag] = gen + 1
        gen_tag = f"{tag}:g{gen}"
        deadline = time.monotonic() + self.timeout
        # a refused or reset connection (the server restarting or not up
        # yet) is as transient as a 404: retry both until the deadline
        req = urllib.request.Request(self._url(gen_tag, self.rank),
                                     data=b"1", method="PUT")
        while True:
            try:
                # clamped to the remaining deadline: a stalled but
                # accepting server must not hold a short barrier for the
                # full socket timeout
                urllib.request.urlopen(req, timeout=min(
                    5.0, max(0.1, deadline - time.monotonic())))
                break
            except (urllib.error.URLError, TimeoutError) as e:
                if time.monotonic() >= deadline:
                    raise CheckpointError(
                        f"KVBarrier {gen_tag!r}: cannot announce to KV "
                        f"server {self.endpoint} after {self.timeout}s: "
                        f"{e}") from e
                time.sleep(0.05)
        missing = set(range(self.world_size))
        last_dead_check = 0.0
        while missing:
            for r in sorted(missing):
                try:
                    urllib.request.urlopen(
                        self._url(gen_tag, r),
                        timeout=min(5.0, max(
                            0.1, deadline - time.monotonic())))
                    missing.discard(r)
                except (urllib.error.URLError, TimeoutError):
                    pass
            if not missing:
                break
            # a dead-listed rank we still wait on can never arrive: fail
            # fast with it named (throttled: dead_ranks_fn may poll HTTP)
            if self.dead_ranks_fn is not None and \
                    time.monotonic() - last_dead_check >= 0.25:
                last_dead_check = time.monotonic()
                try:
                    dead = {int(x) for x in (self.dead_ranks_fn() or ())}
                except Exception:  # noqa: BLE001 - no evidence,
                    dead = set()   # no verdict
                lost = sorted(dead & missing)
                if lost:
                    raise CheckpointError(
                        f"KVBarrier {gen_tag!r}: rank(s) {lost} "
                        f"dead-listed by the health plane while still "
                        f"missing from the barrier "
                        f"(world={self.world_size}); failing fast "
                        f"instead of waiting out the {self.timeout}s "
                        f"deadline")
            if time.monotonic() >= deadline:
                raise CheckpointError(
                    f"KVBarrier {gen_tag!r}: ranks {sorted(missing)} "
                    f"missing after {self.timeout}s "
                    f"(world={self.world_size})")
            time.sleep(0.02)
        # sweep the barrier two completed barriers back: every rank
        # trims its list, only rank 0 issues the DELETEs
        self._past_tags.append((tag, gen_tag))
        if len(self._past_tags) > 2:
            old_tag, old_gen_tag = self._past_tags.pop(0)
            # the swept barrier's gen count goes with its keys, unless a
            # later use of the tag is still live or (rank 0) a DELETE
            # failed: stale keys plus a re-minted gen would release a
            # reused tag early
            swept = True
            if self.rank == 0:
                for r in range(self.world_size):
                    try:
                        urllib.request.urlopen(urllib.request.Request(
                            self._url(old_gen_tag, r), method="DELETE"),
                            timeout=min(5.0, max(
                                0.5, deadline - time.monotonic())))
                    except (urllib.error.URLError, TimeoutError):
                        swept = False
            if swept and all(t != old_tag for t, _ in self._past_tags):
                self._tag_gens.pop(old_tag, None)


# tag -> uses so far, for the store barrier's keys (every rank calls the
# same tags in the same order, so the generations agree)
_STORE_GENS: Dict[str, int] = {}
_STORE_LOCK = threading.Lock()


def _default_barrier(tag: str) -> None:
    """Every rank of the live ``torch.distributed`` group meets at
    ``tag`` on the group's store (the counterpart of the JAX package's
    ``sync_global_devices``): a counter each rank adds one to, polled
    until it reaches the world size.  The store, not a collective, so a
    background writer never interleaves with the training thread's
    collectives.  Without a group above one rank, nothing to wait for."""
    from torch.distributed import distributed_c10d

    from ..distributed.parallel_env import GROUP_TIMEOUT_S, get_world_size

    world = get_world_size()
    if world <= 1:
        return
    store = distributed_c10d._get_default_store()
    with _STORE_LOCK:
        gen = _STORE_GENS.get(tag, 0)
        _STORE_GENS[tag] = gen + 1
    key = f"ckpt_barrier/{tag}:g{gen}"
    store.add(key, 1)
    deadline = time.monotonic() + GROUP_TIMEOUT_S
    while store.add(key, 0) < world:
        if time.monotonic() >= deadline:
            raise CheckpointError(
                f"checkpoint barrier {key!r}: {world - store.add(key, 0)} "
                f"of {world} ranks missing after {GROUP_TIMEOUT_S} s")
        time.sleep(0.005)


class _Job:
    __slots__ = ("step", "state", "host_state", "stats", "pinned")

    def __init__(self, step, state, host_state, stats, pinned=None):
        self.step = int(step)
        self.state = state          # a state._Pending
        self.host_state = host_state
        self.stats = stats
        self.pinned = pinned        # the pinned buffer set it fills


class CheckpointManager:
    """See module docstring.  ``keep_n=None`` / ``async_save=None``
    default from ``FLAGS_ckpt_keep_n`` / ``FLAGS_ckpt_async_save``
    (``keep_n=0`` keeps everything)."""

    def __init__(self, dirname: str, keep_n: Optional[int] = None,
                 keep_every_n_steps: Optional[int] = None,
                 async_save: Optional[bool] = None,
                 rank: Optional[int] = None,
                 world_size: Optional[int] = None,
                 barrier: Optional[Callable[[str], None]] = None):
        self.dirname = os.path.abspath(dirname)
        self.keep_n = int(_flags.flag("ckpt_keep_n") if keep_n is None
                          else keep_n)
        self.keep_every_n_steps = (int(keep_every_n_steps)
                                   if keep_every_n_steps else None)
        self.async_save = bool(_flags.flag("ckpt_async_save")
                               if async_save is None else async_save)
        self._rank = None if rank is None else int(rank)
        self._world = None if world_size is None else int(world_size)
        self._barrier = barrier if barrier is not None else _default_barrier
        self._components: Dict[str, object] = {}
        self._fault_hook: Optional[Callable[[str, int], None]] = None
        self._cond = threading.Condition()
        self._queue: "collections.deque[_Job]" = collections.deque()
        self._active: Optional[_Job] = None
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        # pinned host buffer sets (``state._pinned_views``: one flat
        # buffer and its views) not held by a job, and the side stream
        # every copy into them goes on (so a set given back by a
        # coalesced job is refilled only after its copies)
        self._free_pinned: List[dict] = []
        self._stream = None
        self.stats: List[dict] = []
        # jobs RUN so far (not queued), in lockstep on every rank (the
        # queue is FIFO above one rank, and a job that fails inside
        # _run_job still used its number everywhere): it stamps the
        # barrier tags, so a re-save of a failed step never meets the
        # first attempt's half-used tags.  A save that fails on one rank
        # before its job runs leaves that rank a number behind; its later
        # saves then fail by barrier timeout, never with a bad commit.
        self._job_seq = 0
        _LIVE.add(self)

    # -- topology ---------------------------------------------------------
    @property
    def rank(self) -> int:
        if self._rank is not None:
            return self._rank
        from ..distributed.parallel_env import get_rank

        return get_rank()

    @property
    def world_size(self) -> int:
        if self._world is not None:
            return self._world
        from ..distributed.parallel_env import get_world_size

        return get_world_size()

    # -- test/fault-injection hook ---------------------------------------
    def set_fault_hook(self, fn: Optional[Callable[[str, int], None]]):
        """``fn(phase, step)`` is called from the writer at ``serialize``
        / ``write_shard`` / ``pre_commit`` / ``post_commit``.  Raising
        simulates a crash at that point (the torn ``.tmp`` stays on disk
        as a killed process would leave it)."""
        self._fault_hook = fn

    def _fault(self, phase: str, step: int) -> None:
        if self._fault_hook is not None:
            self._fault_hook(phase, step)

    # -- host-side components (LR scheduler, data iterator, ...) ---------
    def register(self, name: str, obj) -> None:
        """Attach a host-side component exposing ``state_dict()`` /
        ``set_state_dict()``; its JSON state rides every save and is
        pushed back on restore."""
        for attr in ("state_dict", "set_state_dict"):
            if not hasattr(obj, attr):
                raise TypeError(
                    f"component {name!r} must expose state_dict/"
                    f"set_state_dict (got {type(obj).__name__})")
        self._components[name] = obj

    # -- save -------------------------------------------------------------
    def _snapshot(self, scope, var_names):
        """(pending host state, its pinned set) of ``scope``: a rank
        other than 0 of several takes only its sharded blocks."""
        with self._cond:
            pinned = self._free_pinned.pop() if self._free_pinned else {}
        try:
            pending = take_snapshot(
                scope, var_names, pinned=pinned, stream=self._stream,
                shards_only=self.world_size > 1 and self.rank != 0)
        except BaseException:
            self._give_back(pinned)
            raise
        self._stream = pending.stream or self._stream
        return pending, pinned

    def _give_back(self, pinned) -> None:
        if pinned:
            with self._cond:
                self._free_pinned.append(pinned)

    def save(self, step: int, scope=None, var_names=None, state=None,
             host_state: Optional[dict] = None, wait: bool = False
             ) -> List[str]:
        """Checkpoint ``step``.  Exactly one of ``scope`` (the state taken
        by ``take_snapshot``) or ``state`` (name -> array or tensor)
        supplies the payload.  Returns the saved variable names.  With
        ``async_save`` the call returns once the snapshot is enqueued; a
        background failure is reported on ``wait()``/``close()``."""
        from .state import _Pending

        if self._closed:
            raise CheckpointError("CheckpointManager is closed")
        t0 = time.perf_counter()
        pinned = None
        if state is None:
            if scope is None:
                from ..framework.scope import global_scope

                scope = global_scope()
            with otrace.span("ckpt/snapshot", step=int(step)):
                pending, pinned = self._snapshot(scope, var_names)
        else:
            pending = _Pending({
                n: v if isinstance(v, (LocalShard, GeneratorState)) else
                (v.detach().to("cpu", copy=True)
                 if isinstance(v, torch.Tensor) else
                 to_tensor(np.array(v, copy=True)))
                for n, v in state.items()})
        for name, v in pending.values.items():
            if self.world_size == 1 and isinstance(v, LocalShard) \
                    and tuple(v.array.shape) != tuple(v.global_shape):
                # a rank-0-local save of ZeRO-sharded state would commit
                # a checkpoint missing every other rank's block
                self._give_back(pinned)
                raise CheckpointError(
                    f"var {name!r} is a partial shard "
                    f"({tuple(v.array.shape)} of global {v.global_shape}) "
                    f"but this manager has world_size=1: the other ranks' "
                    f"blocks would never be written and the checkpoint "
                    f"could not restore. Save state sharded over several "
                    f"processes through a manager with rank/world_size "
                    f"set on every rank "
                    f"(distributed.checkpoint.save_sharded)")
        host = dict(host_state or {})
        if self._components:
            host["components"] = {n: c.state_dict()
                                  for n, c in self._components.items()}
        stats = {"step": int(step)}
        job = _Job(step, pending, host, stats, pinned)
        names = sorted(pending.values)
        _flight.record("ckpt/save", step=int(step), vars=len(names),
                       async_save=self.async_save)
        if not self.async_save:
            try:
                self._run_job(job)
            finally:
                self._give_back(pinned)
            self._blocking(stats, t0)
            return names
        with self._cond:
            if self._closed:
                self._give_back(pinned)
                raise CheckpointError("CheckpointManager is closed")
            if self.world_size > 1:
                # FIFO: every rank's writer runs the same step sequence;
                # each job holds a host snapshot, so the backlog is
                # capped (every rank blocks at the same save)
                while len(self._queue) >= _MAX_PENDING_SAVES \
                        and not self._closed:
                    self._cond.wait(timeout=0.1)
                if self._closed:
                    self._give_back(pinned)
                    raise CheckpointError("CheckpointManager is closed")
            elif self._queue:
                # coalesce: the unstarted stale save is superseded
                stale = self._queue.pop()
                stale.stats["coalesced"] = True
                if stale.pinned:
                    self._free_pinned.append(stale.pinned)
                stat_add("ckpt_saves_coalesced")
                logger.info("ckpt: coalescing pending save of step %d "
                            "under newer step %d", stale.step, job.step)
            self._queue.append(job)
            self._ensure_thread()
            self._cond.notify_all()
        self._blocking(stats, t0)
        if wait:
            self.wait()
        return names

    def _blocking(self, stats, t0) -> None:
        dt = time.perf_counter() - t0
        stats["blocking_s"] = dt
        stat_time("ckpt_save_blocking_seconds", dt)
        with self._cond:
            self.stats.append(stats)

    def wait(self) -> None:
        """Block until no save is queued or in flight; re-raise the first
        background failure."""
        with self._cond:
            while self._queue or self._active is not None:
                self._cond.wait(timeout=0.1)
            err, self._error = self._error, None
        if err is not None:
            raise CheckpointError(
                f"background checkpoint save failed: {err}") from err

    def close(self) -> None:
        """Drain pending saves and stop the writer thread."""
        try:
            self.wait()
        finally:
            with self._cond:
                self._closed = True
                self._cond.notify_all()
            if self._thread is not None:
                self._thread.join(timeout=5)
                self._thread = None
            self._free_pinned.clear()
            _LIVE.discard(self)

    # -- writer thread ----------------------------------------------------
    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._writer_loop, name="ckpt-writer", daemon=True)
            self._thread.start()

    def _writer_loop(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait(timeout=0.25)
                if self._closed and not self._queue:
                    return
                self._active = job = self._queue.popleft()
                self._cond.notify_all()
            try:
                self._run_job(job)
            except BaseException as e:  # noqa: BLE001 - writer survives
                stat_add("ckpt_save_failures")
                job.stats["error"] = f"{type(e).__name__}: {e}"[:300]
                _flight.record("ckpt/save_error", step=int(job.step),
                               error=f"{type(e).__name__}: {e}"[:500])
                logger.exception(
                    "ckpt: background save of step %d failed (torn .tmp "
                    "left for inspection; restore() will fall back to "
                    "the previous intact step)", job.step)
                with self._cond:
                    if self._error is None:
                        self._error = e
            finally:
                self._give_back(job.pinned)
                with self._cond:
                    self._active = None
                    self._cond.notify_all()

    # -- the actual write -------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dirname, f"step_{int(step)}")

    def _run_job(self, job: _Job) -> None:
        t0 = time.perf_counter()
        st = job.stats
        rank, world = self.rank, self.world_size
        seq, self._job_seq = self._job_seq, self._job_seq + 1
        tag = f"{job.step}:j{seq}"
        tmp = self._step_dir(job.step) + ".tmp"
        final = self._step_dir(job.step)
        if rank == 0:
            if os.path.isdir(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp, exist_ok=True)
        if world > 1:
            self._barrier(f"mkdir:{tag}")
            os.makedirs(tmp, exist_ok=True)  # a racing mkdir is fine

        self._fault("serialize", job.step)
        t = time.perf_counter()
        values = job.state.wait()   # the card's copies have landed
        st["copy_wait_s"] = time.perf_counter() - t
        # a rank other than 0 contributes only its blocks; replicated
        # values are written once, by rank 0
        payload: Dict[str, np.ndarray] = {}
        var_meta: Dict[str, dict] = {}
        with otrace.span("ckpt/serialize", step=job.step,
                         vars=len(values)):
            for name, v in values.items():
                if rank == 0 or isinstance(v, LocalShard):
                    payload[name], var_meta[name] = _to_np(v)
        nbytes = sum(a.nbytes for a in payload.values())
        shard_name, meta_name = f"shard_r{rank}.npz", f"meta_r{rank}.json"
        shard_path = os.path.join(tmp, shard_name)
        fsync = _flags.flag("ckpt_fsync")
        fsync_s = 0.0
        with otrace.span("ckpt/write", step=job.step, bytes=nbytes):
            self._fault("write_shard", job.step)
            t = time.perf_counter()
            with open(shard_path, "wb") as f:
                np.savez(f, **payload)
                f.flush()
                st["write_s"] = time.perf_counter() - t
                t = time.perf_counter()
                if fsync:
                    os.fsync(f.fileno())
                fsync_s += time.perf_counter() - t
            meta = {"format": 1, "step": job.step, "rank": rank,
                    "world_size": world, "shard": shard_name,
                    "vars": var_meta}
            if rank == 0:
                meta["host_state"] = job.host_state
                meta["created_unix"] = time.time()
            with open(os.path.join(tmp, meta_name), "w") as f:
                json.dump(meta, f)
                f.flush()
                t = time.perf_counter()
                if fsync:
                    os.fsync(f.fileno())
                fsync_s += time.perf_counter() - t

        # commit: every rank's files durable -> rank 0 manifests, renames
        with otrace.span("ckpt/commit", step=job.step):
            if world > 1:
                t = time.perf_counter()
                self._barrier(f"written:{tag}")
                st["barrier_s"] = time.perf_counter() - t
            t = time.perf_counter()
            if rank == 0:
                self._fault("pre_commit", job.step)
                files = {}
                for fname in sorted(os.listdir(tmp)):
                    p = os.path.join(tmp, fname)
                    files[fname] = {"sha256": _sha256(p),
                                    "bytes": os.path.getsize(p)}
                st["hash_s"] = time.perf_counter() - t
                t = time.perf_counter()
                manifest = {"format": 1, "step": job.step,
                            "world_size": world, "files": files}
                with open(os.path.join(tmp, _MANIFEST), "w") as f:
                    json.dump(manifest, f)
                    f.flush()
                    if fsync:
                        os.fsync(f.fileno())
                _fsync_dir(tmp)
                if os.path.isdir(final):  # re-save of an existing step
                    shutil.rmtree(final)
                os.rename(tmp, final)
                _fsync_dir(self.dirname)
                self._fault("post_commit", job.step)
            if world > 1:
                # every rank's save returns once the step is visible
                self._barrier(f"committed:{tag}")
            st["commit_s"] = time.perf_counter() - t
        st["fsync_s"] = fsync_s
        st["bytes"] = nbytes
        dt = time.perf_counter() - t0
        st["writer_s"] = dt
        stat_time("ckpt_write_seconds", dt)
        stat_add("ckpt_saves")
        stat_add("ckpt_bytes_written", nbytes)
        _flight.record("ckpt/commit", step=int(job.step), rank=rank,
                       write_seconds=round(dt, 4), bytes=nbytes)
        if rank == 0:
            self._gc(current_step=job.step)

    # -- retention --------------------------------------------------------
    def _gc(self, current_step: int) -> None:
        steps = self.all_steps()
        keep = set(steps if self.keep_n <= 0 else steps[-self.keep_n:])
        if self.keep_every_n_steps:
            keep |= {s for s in steps
                     if s % self.keep_every_n_steps == 0}
        keep.add(current_step)
        removed = 0
        for s in steps:
            if s not in keep:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)
                removed += 1
        # stale .tmp leftovers from crashed runs, any step (the writer is
        # serial: this job's own tmp has been renamed already)
        try:
            entries = os.listdir(self.dirname)
        except OSError:
            entries = []
        for e in entries:
            if _TMP_RE.match(e):
                shutil.rmtree(os.path.join(self.dirname, e),
                              ignore_errors=True)
                removed += 1
        if removed:
            stat_add("ckpt_gc_removed", removed)

    # -- discovery / validation ------------------------------------------
    def all_steps(self) -> List[int]:
        """Committed (renamed) step numbers, ascending.  Intactness is
        judged at restore time."""
        try:
            entries = os.listdir(self.dirname)
        except OSError:
            return []
        out = []
        for e in entries:
            m = _STEP_RE.match(e)
            if m and os.path.isdir(os.path.join(self.dirname, e)):
                out.append(int(m.group(1)))
        return sorted(out)

    def next_step(self) -> int:
        steps = self.all_steps()
        return (steps[-1] + 1) if steps else 0

    def validate(self, step: int) -> Tuple[bool, str]:
        """Manifest check for one committed step: every listed file must
        exist with matching size and SHA-256."""
        d = self._step_dir(step)
        mpath = os.path.join(d, _MANIFEST)
        if not os.path.isfile(mpath):
            return False, "missing MANIFEST.json"
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            return False, f"unreadable manifest: {e}"
        files = manifest.get("files", {})
        for k in range(int(manifest.get("world_size", 1) or 1)):
            if f"meta_r{k}.json" not in files:
                return False, f"manifest lists no rank-{k} meta"
            if f"shard_r{k}.npz" not in files:
                return False, f"manifest lists no rank-{k} shard"
        for fname, rec in files.items():
            p = os.path.join(d, fname)
            if not os.path.isfile(p):
                return False, f"missing file {fname}"
            if os.path.getsize(p) != rec.get("bytes"):
                return False, f"size mismatch on {fname}"
            if _flags.flag("ckpt_verify_restore") \
                    and _sha256(p) != rec.get("sha256"):
                return False, f"hash mismatch on {fname}"
        return True, "ok"

    def latest_intact_step(self) -> Optional[int]:
        for s in reversed(self.all_steps()):
            if self.validate(s)[0]:
                return s
        return None

    # -- restore ----------------------------------------------------------
    def restore(self, scope=None, step: Optional[int] = None,
                var_names: Optional[Sequence[str]] = None,
                device: DeviceLike = None) -> Optional[dict]:
        """Load the newest intact checkpoint (or exactly ``step``) onto
        ``device`` (the card unless told otherwise).

        Falls back, loudly, past torn or corrupt steps.  Returns ``None``
        when the directory holds no committed checkpoint; raises
        :class:`CheckpointError` when checkpoints exist but none
        validates.  The returned meta dict carries ``step``,
        ``host_state``, ``vars`` and, when ``scope`` is None, ``state``
        (name -> tensor on ``device``, the generator a generator
        there)."""
        steps = self.all_steps()
        if step is not None:
            if step not in steps:
                raise CheckpointError(
                    f"no committed checkpoint for step {step} in "
                    f"{self.dirname} (have {steps or 'none'})")
            candidates = [step]
        else:
            candidates = list(reversed(steps))
        if not candidates:
            return None
        reasons = []
        for s in candidates:
            ok, why = self.validate(s)
            if not ok:
                stat_add("ckpt_restore_fallbacks")
                _flight.record("ckpt/restore_fallback", step=int(s),
                               reason=str(why)[:300])
                logger.warning(
                    "ckpt: step %d in %s is not intact (%s); falling "
                    "back", s, self.dirname, why)
                reasons.append(f"step {s}: {why}")
                continue
            state, host = self._read_step(s)
            meta = {"step": s, "host_state": host, "vars": sorted(state)}
            if scope is not None:
                restore_scope(scope, state, var_names, device)
            else:
                dev = default_device(device)
                meta["state"] = {
                    n: (v.generator(dev) if isinstance(v, GeneratorState)
                        else v.to(dev) if isinstance(v, torch.Tensor)
                        else v)
                    for n, v in state.items()
                    if var_names is None or n in var_names}
            comps = (host or {}).get("components", {})
            for name, cstate in comps.items():
                obj = self._components.get(name)
                if obj is not None:
                    obj.set_state_dict(cstate)
            stat_add("ckpt_restores")
            _flight.record("ckpt/restore", step=int(s),
                           vars=len(meta["vars"]))
            return meta
        raise CheckpointError(
            f"no intact checkpoint in {self.dirname}: "
            + "; ".join(reasons))

    def _read_step(self, step: int) -> Tuple[Dict[str, object], dict]:
        """Every rank file of ``step`` merged: replicated values from
        their file, each sharded value re-assembled from its blocks (by
        origin, else concatenated along axis 0 in rank order)."""
        d = self._step_dir(step)
        metas = []
        for fname in sorted(os.listdir(d)):
            if fname.startswith("meta_r") and fname.endswith(".json"):
                with open(os.path.join(d, fname)) as f:
                    metas.append(json.load(f))
        metas.sort(key=lambda m: m.get("rank", 0))
        host_state = {}
        merged: Dict[str, object] = {}
        shard_parts: Dict[str, List[Tuple[int, np.ndarray]]] = {}
        origin_parts: Dict[str, List[Tuple[tuple, np.ndarray]]] = {}
        shard_info: Dict[str, dict] = {}
        for m in metas:
            if m.get("rank", 0) == 0:
                host_state = m.get("host_state", {}) or {}
            with np.load(os.path.join(d, m["shard"])) as z:
                for name, rec in m.get("vars", {}).items():
                    if not rec.get("sharded"):
                        merged[name] = _from_np(z[name], rec)
                        continue
                    shard_info[name] = rec
                    if rec.get("origin") is not None:
                        origin_parts.setdefault(name, []).append(
                            (tuple(int(o) for o in rec["origin"]), z[name]))
                    else:
                        shard_parts.setdefault(name, []).append(
                            (m.get("rank", 0), z[name]))
        for name, parts in shard_parts.items():
            parts.sort(key=lambda p: p[0])
            full = np.concatenate([a for _, a in parts], axis=0)
            want = tuple(shard_info[name].get("global_shape") or ())
            if want and full.shape != want:
                raise CheckpointError(
                    f"sharded var {name!r} re-assembles to {full.shape}, "
                    f"manifest says {want} (rank files inconsistent)")
            merged[name] = _from_np(full, shard_info[name])
        for name, parts in origin_parts.items():
            want = tuple(shard_info[name].get("global_shape") or ())
            _check_origin_coverage(name, parts, want)
            full = np.empty(want, dtype=parts[0][1].dtype)
            for origin, arr in parts:
                full[tuple(slice(o, o + s)
                           for o, s in zip(origin, arr.shape))] = arr
            merged[name] = _from_np(full, shard_info[name])
        return merged, host_state


def _check_origin_coverage(name, parts, want):
    """The blocks of a sharded value must tile it: axis-aligned blocks on
    a regular per-dimension origin grid, checked in O(#blocks) without
    a mask of the global shape.  A hole means a rank's block is missing:
    an unrestorable value fails here."""
    import itertools

    blocks = {}
    for origin, arr in parts:
        if len(origin) != len(want) or any(
                o + s > w for o, s, w in zip(origin, arr.shape, want)):
            raise CheckpointError(
                f"sharded var {name!r}: block {arr.shape} at origin "
                f"{origin} does not fit global {want}")
        prev = blocks.get(origin)
        if prev is not None and prev != arr.shape:
            raise CheckpointError(
                f"sharded var {name!r}: conflicting blocks {prev} vs "
                f"{arr.shape} at origin {origin}")
        blocks[origin] = arr.shape  # replicated duplicates collapse
    per_dim = [sorted({o[d] for o in blocks}) for d in range(len(want))]
    for d, origins in enumerate(per_dim):
        if origins and origins[0] != 0:
            raise CheckpointError(
                f"sharded var {name!r}: dim {d} grid starts at "
                f"{origins[0]}, not 0 (missing rank file?)")
    for origin in itertools.product(*per_dim):
        shape = blocks.get(origin)
        if shape is None:
            raise CheckpointError(
                f"sharded var {name!r}: no block at grid origin {origin} "
                f"of global {want} (missing rank file?)")
        for d, (o, s) in enumerate(zip(origin, shape)):
            nxt = per_dim[d].index(o) + 1
            end = per_dim[d][nxt] if nxt < len(per_dim[d]) else want[d]
            if o + s != end:
                raise CheckpointError(
                    f"sharded var {name!r}: block at {origin} spans "
                    f"[{o}, {o + s}) on dim {d} but the grid expects "
                    f"[{o}, {end}) over global {want} (holes or overlap)")
