"""Flight recorder: always-on bounded ring of structured run events.

Role: the black box for the failure modes the in-process tracer cannot
see.  The span tracer (``observe/tracer.py``) and histograms observe a
*healthy* hot path; when the device itself dies ("device init did not
complete within 240s", BENCH rounds 4-5) all that survives is whatever
was written down *before* the hang.  This module keeps a bounded
in-memory ring of structured JSONL events — run metadata (torch and
CUDA versions, device names, FLAGS snapshot, rank/world size) and
lifecycle events (Executor dispatch/drain, checkpoint save/restore,
serving start/stop, postmortem dumps) — cheap enough to leave on in
production (one dict + deque append per event, ~µs), gated by
``FLAGS_flight_recorder`` (default ON).

``FLAGS_flight_recorder_file`` adds an always-on file sink: every event
is appended as one JSON line and flushed immediately, so a process that
dies without running any handler still leaves its tail on disk (the
Dapper-style "postmortem dump" half of always-on tracing).  The
postmortem bundle (``observe/health.py``) embeds ``tail()`` regardless.

Events are plain dicts::

    {"ts": <epoch seconds>, "seq": <monotone int>, "event": "ckpt/commit",
     ...event fields...}

Event names are slash-namespaced like span names (``executor/…``,
``ckpt/…``, ``serving/…``, ``run/…``, ``health/…``, ``postmortem/…``).
"""
from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional

from ..framework import flags as _flags

__all__ = ["FlightRecorder", "get_flight_recorder", "record",
           "record_run_metadata", "record_device_topology", "run_metadata",
           "snapshot_events", "tail", "dump", "clear_events"]

DEFAULT_CAPACITY = 4096


def _jsonable(v):
    """Best-effort conversion so record() never raises on an odd field
    value (instrumentation must not take the process down)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return repr(v)


class FlightRecorder:
    """Thread-safe bounded ring of structured events + optional file
    sink.  The module singleton is what the framework feeds; tests may
    build their own with a small capacity."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._buf = collections.deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self._seq = 0
        self._dropped = 0
        self._meta_recorded = False
        self._topology_recorded = False
        self._sink = None
        self._sink_path: Optional[str] = None
        self._sink_failed_path: Optional[str] = None
        self._rotations = 0

    # -- recording -------------------------------------------------------
    def record(self, event: str, **fields) -> Optional[dict]:
        """Append one event.  Never raises: a sink write failure or an
        unserializable field degrades, it does not propagate into the
        training loop."""
        rec = {"ts": time.time(), "seq": 0, "event": str(event)}
        for k, v in fields.items():
            rec[k] = _jsonable(v)
        with self._lock:
            self._seq += 1
            rec["seq"] = self._seq
            if len(self._buf) == self._buf.maxlen:
                self._dropped += 1
            self._buf.append(rec)
            self._write_sink(rec)
        return rec

    def _write_sink(self, rec: dict) -> None:
        """File sink (called under the lock): follows
        ``FLAGS_flight_recorder_file`` live — set/clear/retarget the
        flag at any time.  Each line is flushed so a dying process
        keeps its tail."""
        try:
            path = _flags.flag("flight_recorder_file")
        except KeyError:  # pragma: no cover - partial installs
            path = ""
        try:
            if not path:
                if self._sink is not None:
                    self._sink.close()
                    self._sink = None
                    self._sink_path = None
                self._sink_failed_path = None
                return
            if path == self._sink_failed_path:
                return  # latched: don't pay two failing syscalls per
                # hot-path event; retargeting the flag re-tries
            if self._sink is None or self._sink_path != path:
                if self._sink is not None:
                    self._sink.close()
                d = os.path.dirname(path)
                if d:
                    os.makedirs(d, exist_ok=True)
                self._sink = open(path, "a")
                self._sink_path = path
                self._sink_failed_path = None
            self._sink.write(json.dumps(rec) + "\n")
            self._sink.flush()
            self._maybe_rotate(path)
        except OSError:  # sink trouble must never fail the caller
            self._sink = None
            self._sink_path = None
            self._sink_failed_path = path

    def _maybe_rotate(self, path: str) -> None:
        """Size-based sink rotation (``FLAGS_flight_recorder_max_mb``,
        called under the lock right after a flushed write): when the
        active segment passes the cap it becomes ``<path>.1`` (the one
        previous segment kept — two segments bound disk at 2x the cap
        on an unbounded run) and a fresh segment opens.  The rotated
        file is complete JSONL, so a post-SIGKILL reader concatenating
        ``<path>.1`` + ``<path>`` always has at least one full cap of
        tail history."""
        try:
            max_mb = float(_flags.flag("flight_recorder_max_mb") or 0.0)
        except KeyError:  # pragma: no cover - partial installs
            return
        if max_mb <= 0.0 or self._sink is None:
            return
        if self._sink.tell() < max_mb * 1024.0 * 1024.0:
            return
        self._sink.close()
        self._sink = None
        os.replace(path, path + ".1")  # atomic; drops any older .1
        self._sink = open(path, "a")
        self._sink_path = path
        self._rotations += 1
        try:
            from ..monitor import stat_add

            stat_add("flight_sink_rotations")
        except ImportError:  # pragma: no cover
            pass

    # -- reading ---------------------------------------------------------
    def snapshot(self) -> List[dict]:
        with self._lock:
            return list(self._buf)

    def tail(self, n: Optional[int] = None) -> List[dict]:
        evs = self.snapshot()
        return evs if n is None else evs[-int(n):]

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def dump(self, path: str, n: Optional[int] = None) -> str:
        """Write the (tail of the) ring as JSONL to ``path``."""
        evs = self.tail(n)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            for rec in evs:
                f.write(json.dumps(rec) + "\n")
        return path

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._dropped = 0
            self._meta_recorded = False
            self._topology_recorded = False


_RECORDER = FlightRecorder()


def get_flight_recorder() -> FlightRecorder:
    return _RECORDER


def enabled() -> bool:
    return bool(_flags.flag("flight_recorder"))


def record(event: str, **fields) -> Optional[dict]:
    """Record one event on the process recorder; no-op (one flag read)
    when ``FLAGS_flight_recorder`` is off."""
    if not _flags.flag("flight_recorder"):
        return None
    return _RECORDER.record(event, **fields)


# ---------------------------------------------------------------------------
# run metadata
# ---------------------------------------------------------------------------


def _rank_world() -> tuple:
    """(rank, world_size) best-effort: the ``torch.distributed`` group
    when one is initialized, else rank 0 of ``PADDLE_TRAINERS_NUM``."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
    except Exception:  # noqa: BLE001 - metadata only
        pass
    return 0, int(os.environ.get("PADDLE_TRAINERS_NUM", "1") or 1)


def run_metadata(include_devices: bool = False) -> Dict:
    """The who/what/where of this process: versions (python, torch and
    the CUDA toolkit torch was built with), rank/world, FLAGS snapshot,
    argv.  ``include_devices=True`` additionally asks torch for the
    visible CUDA devices -- callers pass it only once the device is in
    use, so the probe never starts a CUDA context on its own."""
    import platform

    import torch

    meta: Dict = {
        "pid": os.getpid(),
        "argv": list(sys.argv),
        "python": platform.python_version(),
        "host": platform.node(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
    }
    meta["rank"], meta["world_size"] = _rank_world()
    meta["flags"] = _flags.flags_snapshot()
    if include_devices:
        meta.update(_device_topology())
    return meta


def _device_topology() -> Dict:
    try:
        import torch

        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        return {
            "platform": "gpu" if n else "cpu",
            "device_count": n,
            "devices": [torch.cuda.get_device_name(i)
                        for i in range(min(n, 16))],
        }
    except Exception as e:  # noqa: BLE001 - a dead backend is an EVENT
        return {"device_probe_error": f"{type(e).__name__}: {e}"}


def record_run_metadata(force: bool = False, **extra) -> Optional[dict]:
    """Record the ``run/metadata`` event once per process (the first
    Executor construction calls this; later calls are no-ops unless
    ``force``)."""
    if not _flags.flag("flight_recorder"):
        return None
    with _RECORDER._lock:
        if _RECORDER._meta_recorded and not force:
            return None
        _RECORDER._meta_recorded = True
    return _RECORDER.record("run/metadata", **run_metadata(), **extra)


def record_device_topology(force: bool = False) -> Optional[dict]:
    """Record the ``run/devices`` event once per process, from a point
    where the device is already in use (the probe must not be the call
    that starts a CUDA context)."""
    if not _flags.flag("flight_recorder"):
        return None
    with _RECORDER._lock:
        if _RECORDER._topology_recorded and not force:
            return None
        _RECORDER._topology_recorded = True
    return _RECORDER.record("run/devices", **_device_topology())


# ---------------------------------------------------------------------------
# module-level conveniences over the singleton
# ---------------------------------------------------------------------------


def snapshot_events() -> List[dict]:
    return _RECORDER.snapshot()


def tail(n: Optional[int] = None) -> List[dict]:
    return _RECORDER.tail(n)


def dump(path: str, n: Optional[int] = None) -> str:
    return _RECORDER.dump(path, n)


def clear_events() -> None:
    _RECORDER.clear()


def _atexit_flush():  # pragma: no cover - interpreter teardown
    r = _RECORDER
    with r._lock:
        if r._sink is not None:
            try:
                r._sink.flush()
            except OSError:
                pass


import atexit  # noqa: E402

atexit.register(_atexit_flush)
