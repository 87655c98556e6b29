"""In-process span tracer: always-available, low-overhead host timeline.

Role parity: the reference's CUPTI ``DeviceTracer`` + ``RecordEvent``
host annotations feeding ``profiler.proto`` (platform/device_tracer.cc,
platform/profiler.cc:53).  TPU-native framing: XLA owns the device
timeline (``jax.profiler`` captures it when asked), but a heavyweight
XLA capture is the wrong tool for "where did THIS step's milliseconds
go" in a serving process at 3am — so this tracer records *host-side*
named spans into a bounded in-memory ring buffer, always compiled in,
gated by ``FLAGS_enable_tracer``, and exportable at any moment as
Chrome trace-event JSON (``observe/timeline.py``) without restarting or
re-running anything.

Design constraints:
- **Disabled cost ~ zero**: ``span()`` with the flag off is one dict
  lookup and a shared no-op context manager — no allocation, no lock.
- **Enabled cost is bounded**: finished spans land in a
  ``deque(maxlen=capacity)`` (old spans fall off; a long-lived server
  cannot leak), two ``perf_counter`` calls + one lock per span.
- **Thread-correct nesting**: the open-span stack is thread-local, so
  concurrent serving clients / executor callers each get a properly
  nested lane, keyed by thread id in the export.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

from ..framework import flags as _flags

__all__ = ["SpanRecord", "Tracer", "get_tracer", "enabled", "enable",
           "disable", "span", "begin", "end", "snapshot", "clear",
           "NULL_SPAN"]

DEFAULT_CAPACITY = 65536

# perf_counter origin for the whole process: every span timestamp is
# relative to this, so spans from different threads share one timeline
_EPOCH = time.perf_counter()


class SpanRecord(NamedTuple):
    """One finished span (times are seconds since the tracer epoch)."""

    name: str
    t_begin: float
    t_end: float
    tid: int
    thread_name: str
    depth: int          # 0 = top-level on its thread
    parent: Optional[str]
    args: Optional[dict]

    @property
    def duration(self) -> float:
        return self.t_end - self.t_begin


class Tracer:
    """Ring buffer of finished spans + per-thread open-span stacks."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        import collections

        self._buf = collections.deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self._local = threading.local()
        self._dropped = 0
        self.pid = os.getpid()

    # -- recording -------------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def begin(self, name: Optional[str], args: Optional[dict] = None) -> None:
        """``name=None`` pushes a DISCARD sentinel: the matching end()
        pops it without recording.  The module-level begin() pushes it
        when the tracer is disabled, so a begin/end pair stays balanced
        even if ``FLAGS_enable_tracer`` flips between the two calls."""
        if name is None:
            self._stack().append((None, 0.0, None))
            return
        self._stack().append((name, time.perf_counter() - _EPOCH, args))

    def end(self) -> None:
        st = self._stack()
        if not st:  # unbalanced end(): drop silently (never raise in
            return  # instrumentation paths)
        if st[-1][0] is None:  # disabled-begin sentinel
            st.pop()
            return
        t1 = time.perf_counter() - _EPOCH
        name, t0, args = st.pop()
        th = threading.current_thread()
        # sentinels are invisible to nesting: depth/parent only count
        # real open spans
        depth = sum(1 for e in st if e[0] is not None)
        parent = next((e[0] for e in reversed(st) if e[0] is not None),
                      None)
        rec = SpanRecord(name, t0, t1, th.ident or 0, th.name, depth,
                         parent, args)
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self._dropped += 1
            self._buf.append(rec)

    def set_args(self, **kwargs) -> None:
        """Attach/extend args on the INNERMOST open span of this thread
        (e.g. byte counts known only after the span body ran)."""
        st = self._stack()
        if not st or st[-1][0] is None:  # no open span / sentinel
            return
        name, t0, args = st[-1]
        merged = dict(args or {})
        merged.update(kwargs)
        st[-1] = (name, t0, merged)

    # -- reading ---------------------------------------------------------
    def snapshot(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._buf)

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._dropped = 0


_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def enabled() -> bool:
    """Single source of truth is ``FLAGS_enable_tracer`` (so
    ``paddle_tpu.set_flags`` and the env var both just work)."""
    return bool(_flags.flag("enable_tracer"))


def enable() -> None:
    _flags.set_flags({"enable_tracer": True})


def disable() -> None:
    _flags.set_flags({"enable_tracer": False})


class _Span:
    """Context manager for one live span (only built when enabled)."""

    __slots__ = ("_name", "_args")

    def __init__(self, name, args):
        self._name = name
        self._args = args

    def __enter__(self):
        _TRACER.begin(self._name, self._args or None)
        return self

    def __exit__(self, *exc):
        _TRACER.end()
        return False


class _NullSpan:
    """Shared no-op: the disabled path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullSpan()

# the shared no-op, exported for instrumentation sites that need an
# "either a span or nothing" slot (e.g. the Executor's first-call
# compile wrapper) without growing their own null context manager
NULL_SPAN = _NULL


def span(name: str, **attrs):
    """``with observe.span("executor/run", bytes=n):`` — no-op unless
    ``FLAGS_enable_tracer`` is set."""
    if not _flags.flag("enable_tracer"):
        return _NULL
    return _Span(name, attrs)


def begin(name: str, **attrs) -> None:
    """Explicit begin/end pair (``RecordEvent`` dual-feed path).  The
    caller must guarantee LIFO order per thread.  Gated by
    ``FLAGS_enable_tracer`` like ``span()`` — a disabled begin pushes
    only a discard sentinel so the pair stays balanced across flag
    flips."""
    if _flags.flag("enable_tracer"):
        _TRACER.begin(name, attrs or None)
    else:
        _TRACER.begin(None)


def end() -> None:
    _TRACER.end()


def set_span_args(**kwargs) -> None:
    if _flags.flag("enable_tracer"):
        _TRACER.set_args(**kwargs)


def snapshot() -> List[SpanRecord]:
    return _TRACER.snapshot()


def clear() -> None:
    _TRACER.clear()
