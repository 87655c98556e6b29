"""Runtime stat registry (reference paddle/fluid/platform/monitor.h:77
``StatRegistry`` / ``STAT_ADD``/``STAT_RESET`` macros and monitor.py's
exposed counters).

TPU-native framing: the reference tracks GPU mem/NCCL counters per
device; here the interesting runtime facts are compile-cache behavior
and dispatch counts (XLA owns memory).  The registry is a process-wide,
thread-safe name -> int64 counter map; the Executor feeds it
(executor_compile / executor_cache_hit / executor_run), and user code
can register its own counters with the same API.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Tuple

__all__ = ["StatRegistry", "stat_add", "stat_get", "stat_reset",
           "stat_set", "stat_max", "stat_time", "export_stats"]


class _Stat:
    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def add(self, increment: int = 1) -> None:
        with self._lock:
            self._value += int(increment)

    def set(self, value: int) -> None:
        """Gauge semantics (queue depth, last-batch size, ...)."""
        with self._lock:
            self._value = int(value)

    def max_update(self, value: int) -> None:
        """High-water-mark semantics: keep the max ever seen."""
        value = int(value)
        with self._lock:
            if value > self._value:
                self._value = value

    def reset(self) -> None:
        with self._lock:
            self._value = 0

    def get(self) -> int:
        with self._lock:
            return self._value


class StatRegistry:
    """Process-wide singleton (reference monitor.h StatRegistry::Instance)."""

    _instance: "StatRegistry" = None  # type: ignore[assignment]
    _instance_lock = threading.Lock()

    def __init__(self):
        self._stats: Dict[str, _Stat] = {}
        self._lock = threading.Lock()

    @classmethod
    def instance(cls) -> "StatRegistry":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def stat(self, name: str) -> _Stat:
        with self._lock:
            s = self._stats.get(name)
            if s is None:
                s = self._stats[name] = _Stat(name)
            return s

    def add(self, name: str, increment: int = 1) -> None:
        self.stat(name).add(increment)

    def set(self, name: str, value: int) -> None:
        self.stat(name).set(value)

    def max_update(self, name: str, value: int) -> None:
        self.stat(name).max_update(value)

    def get(self, name: str) -> int:
        return self.stat(name).get()

    def reset(self, name: str = None) -> None:
        if name is not None:
            self.stat(name).reset()
            return
        with self._lock:
            stats = list(self._stats.values())
        for s in stats:
            s.reset()

    def export(self) -> List[Tuple[str, int]]:
        """Sorted (name, value) snapshot (reference StatRegistry::publish)."""
        with self._lock:
            stats = list(self._stats.items())
        return sorted((n, s.get()) for n, s in stats)


def stat_add(name: str, increment: int = 1) -> None:
    """Reference STAT_ADD macro."""
    StatRegistry.instance().add(name, increment)


def stat_set(name: str, value: int) -> None:
    """Gauge write (queue depth, occupancy high-water marks use stat_max)."""
    StatRegistry.instance().set(name, value)


def stat_max(name: str, value: int) -> None:
    """Keep the maximum ever observed for ``name``."""
    StatRegistry.instance().max_update(name, value)


def stat_get(name: str) -> int:
    return StatRegistry.instance().get(name)


def stat_reset(name: str = None) -> None:
    """Reference STAT_RESET macro (no name: reset everything)."""
    StatRegistry.instance().reset(name)


def stat_time(name: str, seconds: float) -> None:
    """Latency observation — the timing sibling of STAT_ADD.  Feeds the
    log-bucketed histogram registry (observe/histogram.py); p50/p95/p99
    come back through ``export_stats()``/``/stats``/``/metrics``."""
    from .observe.histogram import stat_time as _stat_time

    _stat_time(name, seconds)


def export_stats() -> List[Tuple[str, float]]:
    """Counters plus flattened histogram summaries (``<name>_p50`` ...),
    one sorted snapshot — counters stay ints, histogram rows are floats."""
    out = list(StatRegistry.instance().export())
    from .observe.histogram import histogram_summaries

    out.extend(histogram_summaries())
    return sorted(out)
