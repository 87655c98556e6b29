"""Profiler: ``RecordEvent`` annotations + trace capture over
``torch.profiler``.

Counterpart of ``paddle_tpu/profiler.py`` (reference
``python/paddle/fluid/profiler.py``: ``profiler`` :255,
``start_profiler`` :131, ``stop_profiler`` :198), which captures through
``jax.profiler``.  Here a capture is a ``torch.profiler.profile`` over
the host (``ProfilerActivity.CPU``) and, once the card is in use, CUPTI's
CUDA kernel events (``ProfilerActivity.CUDA``); ``stop_profiler`` writes
it as a Chrome trace, ``<dir>/<host>_<pid>.trace.json``, viewable in
Perfetto.  ``RecordEvent`` is ``torch.profiler.record_function``, so a
named span shows on the trace beside the kernels it launched, and it
dual-feeds the in-process span tracer (``observe/tracer.py``) exactly
as the JAX one does.
"""
from __future__ import annotations

import contextlib
import functools
import os
import socket
import tempfile
import threading
import time
from typing import Optional

from .observe import tracer as _otracer

_state = {"running": False, "dir": None, "t0": None, "prof": None}


class RecordEvent:
    """Scoped host-side annotation: a context manager, explicit
    ``begin()``/``end()``, or a function decorator."""

    def __init__(self, name: str):
        self.name = name
        # per-thread LIFO of live annotations, so one instance can be
        # shared across threads or re-entered
        self._local = threading.local()

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with RecordEvent(self.name):
                return fn(*args, **kwargs)

        return wrapped

    def _entries(self):
        st = getattr(self._local, "entries", None)
        if st is None:
            st = self._local.entries = []
        return st

    def begin(self):
        import torch

        _otracer.begin(self.name)
        ann = torch.profiler.record_function(self.name)
        ann.__enter__()
        self._entries().append(ann)

    def end(self):
        entries = self._entries()
        if entries:
            entries.pop().__exit__(None, None, None)
        _otracer.end()

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()
        return False


def start_profiler(state: str = "All", tracer_option: str = "Default",
                   profile_path: Optional[str] = None):
    """Begin a trace capture (reference fluid/profiler.py:131) into
    ``profile_path``, else ``$PADDLE_TPU_PROFILE_DIR``, else
    ``paddle_tpu_profile`` under the temporary directory.

    ``state``/``tracer_option`` are accepted for API parity: the
    capture traces the host and, once the card is in use, its kernels.
    """
    import torch

    from .observe.profiler_capture import _activities

    if _state["running"]:
        raise RuntimeError("profiler is already running")
    out = profile_path or os.environ.get(
        "PADDLE_TPU_PROFILE_DIR",
        os.path.join(tempfile.gettempdir(), "paddle_tpu_profile"))
    os.makedirs(out, exist_ok=True)
    prof = torch.profiler.profile(activities=_activities())
    _state.update(running=True, dir=out, t0=time.perf_counter(), prof=prof)
    try:
        prof.start()
    except Exception:
        # a failed capture must not wedge the "already running" check
        # for the rest of the process
        _state.update(running=False, dir=None, t0=None, prof=None)
        raise


def stop_profiler(sorted_key: Optional[str] = None,
                  profile_path: Optional[str] = None) -> str:
    """End the capture, write its Chrome trace and return the trace
    directory (reference fluid/profiler.py:198).  ``sorted_key`` is
    parity-only: aggregation and sorting happen in Perfetto over the
    written trace, not in-process."""
    if not _state["running"]:
        raise RuntimeError("profiler is not running")
    out, prof = _state["dir"], _state["prof"]
    # full reset (not just the running bit): a later start must never
    # see this capture's dir/t0
    _state.update(running=False, dir=None, t0=None, prof=None)
    prof.stop()
    prof.export_chrome_trace(os.path.join(
        out, f"{socket.gethostname()}_{os.getpid()}.trace.json"))
    return out


@contextlib.contextmanager
def profiler(state: str = "All", sorted_key: str = "total",
             profile_path: Optional[str] = None, tracer_option: str = "Default"):
    """Context manager parity with ``fluid.profiler.profiler`` (:255)::

        with profiler(profile_path="/tmp/trace"):
            exe.run(main, feed=..., fetch_list=[loss])
    """
    start_profiler(state, tracer_option, profile_path)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


@contextlib.contextmanager
def cuda_profiler(*args, **kwargs):
    """Reference API shim: the same capture as :func:`profiler`, into
    its default directory (kept so fluid scripts run unchanged)."""
    with profiler():
        yield
