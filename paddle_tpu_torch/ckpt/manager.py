"""Asynchronous, atomic checkpoint manager with retention + integrity.

Counterpart of ``paddle_tpu/ckpt/manager.py``, for one process:

- **Async**: ``save(step, scope=...)`` snapshots the scope on the
  caller's thread (``state.take_snapshot``: a drain, device clones and
  copies to pinned host buffers enqueued on a side stream), then hands
  serialization + file writes to a background writer thread, which waits
  for the copies' event first.  A queued-but-unstarted save is COALESCED
  away when a newer one arrives (the newest state wins), so at most one
  save is queued and one written: three sets of pinned buffers, reused
  from save to save.
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

Several processes writing one checkpoint (``world_size > 1``, the
``KVBarrier`` over the fleet KV server) come with the distributed slices
of the port and raise ``NotImplementedError`` here.

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


class CheckpointError(RuntimeError):
    """A checkpoint could not be written or no intact one restored."""


def _later(what: str):
    return NotImplementedError(
        f"{what} is not in the PyTorch port's checkpoints yet: it comes "
        f"with the distributed slices of the port")


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
    """The JAX package's commit barrier over the fleet KV HTTP server;
    the port's fleet KV server comes with its distributed slices."""

    def __init__(self, *args, **kwargs):
        raise _later("KVBarrier (the fleet KV server's commit barrier)")


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
        if (world_size is not None and int(world_size) != 1) or \
                (rank is not None and int(rank) != 0):
            raise _later(f"a checkpoint written by several processes "
                         f"(rank={rank}, world_size={world_size})")
        if barrier is not None:
            raise _later("a commit barrier")
        self.dirname = os.path.abspath(dirname)
        self.keep_n = int(_flags.flag("ckpt_keep_n") if keep_n is None
                          else keep_n)
        self.keep_every_n_steps = (int(keep_every_n_steps)
                                   if keep_every_n_steps else None)
        self.async_save = bool(_flags.flag("ckpt_async_save")
                               if async_save is None else async_save)
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
        _LIVE.add(self)

    rank = 0
    world_size = 1

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
        """(pending host state, its pinned set) of ``scope``."""
        with self._cond:
            pinned = self._free_pinned.pop() if self._free_pinned else {}
        try:
            pending = take_snapshot(scope, var_names, pinned=pinned,
                                    stream=self._stream)
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
            if isinstance(v, LocalShard) \
                    and tuple(v.array.shape) != tuple(v.global_shape):
                self._give_back(pinned)
                raise CheckpointError(
                    f"var {name!r} is a partial shard "
                    f"({tuple(v.array.shape)} of global {v.global_shape}) "
                    f"but this manager has world_size=1: the other ranks' "
                    f"blocks would never be written")
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
            if self._queue:
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
        tmp = self._step_dir(job.step) + ".tmp"
        final = self._step_dir(job.step)
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)

        self._fault("serialize", job.step)
        t = time.perf_counter()
        values = job.state.wait()   # the card's copies have landed
        st["copy_wait_s"] = time.perf_counter() - t
        payload: Dict[str, np.ndarray] = {}
        var_meta: Dict[str, dict] = {}
        with otrace.span("ckpt/serialize", step=job.step,
                         vars=len(values)):
            for name, v in values.items():
                payload[name], var_meta[name] = _to_np(
                    v.array if isinstance(v, LocalShard) else v)
        nbytes = sum(a.nbytes for a in payload.values())
        shard_name, meta_name = "shard_r0.npz", "meta_r0.json"
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
            meta = {"format": 1, "step": job.step, "rank": 0,
                    "world_size": 1, "shard": shard_name, "vars": var_meta,
                    "host_state": job.host_state,
                    "created_unix": time.time()}
            with open(os.path.join(tmp, meta_name), "w") as f:
                json.dump(meta, f)
                f.flush()
                t = time.perf_counter()
                if fsync:
                    os.fsync(f.fileno())
                fsync_s += time.perf_counter() - t

        with otrace.span("ckpt/commit", step=job.step):
            self._fault("pre_commit", job.step)
            t = time.perf_counter()
            files = {}
            for fname in sorted(os.listdir(tmp)):
                p = os.path.join(tmp, fname)
                files[fname] = {"sha256": _sha256(p),
                                "bytes": os.path.getsize(p)}
            st["hash_s"] = time.perf_counter() - t
            t = time.perf_counter()
            manifest = {"format": 1, "step": job.step, "world_size": 1,
                        "files": files}
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
            st["commit_s"] = time.perf_counter() - t
            self._fault("post_commit", job.step)
        st["fsync_s"] = fsync_s
        st["bytes"] = nbytes
        dt = time.perf_counter() - t0
        st["writer_s"] = dt
        stat_time("ckpt_write_seconds", dt)
        stat_add("ckpt_saves")
        stat_add("ckpt_bytes_written", nbytes)
        _flight.record("ckpt/commit", step=int(job.step), rank=0,
                       write_seconds=round(dt, 4), bytes=nbytes)
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
        d = self._step_dir(step)
        metas = []
        for fname in sorted(os.listdir(d)):
            if fname.startswith("meta_r") and fname.endswith(".json"):
                with open(os.path.join(d, fname)) as f:
                    metas.append(json.load(f))
        if len(metas) != 1 or any(r.get("sharded") for m in metas
                                  for r in m.get("vars", {}).values()):
            raise _later(f"restoring a checkpoint written by several "
                         f"processes ({d})")
        m = metas[0]
        merged: Dict[str, object] = {}
        with np.load(os.path.join(d, m["shard"])) as z:
            for name, rec in m.get("vars", {}).items():
                merged[name] = _from_np(z[name], rec)
        return merged, m.get("host_state", {}) or {}
