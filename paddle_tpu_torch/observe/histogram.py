"""Log-bucketed latency histograms + Prometheus text exposition.

Role parity: the reference's ``StatRegistry`` (platform/monitor.h:77)
holds int64 counters only — no notion of a latency *distribution*, which
is the metric that matters for tail-sensitive serving ("p99 under
heavy traffic", ROADMAP north star).  This module adds the missing
half: ``stat_time(name, seconds)`` feeds a process-wide, thread-safe
histogram with power-of-two buckets from 1µs to ~67s, and the whole
registry (counters + histograms) renders as Prometheus text-exposition
format for the fleet KV HTTP server's ``/metrics`` route.

Quantiles are bucket-interpolated (the classic Prometheus
``histogram_quantile`` estimate): exact enough to steer optimization,
cheap enough to leave on in production.  The true maximum is tracked
exactly.
"""
from __future__ import annotations

import math
import re
import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["BUCKET_BOUNDS", "Histogram", "HistogramRegistry", "histogram",
           "stat_time", "export_histograms", "histogram_summaries",
           "prometheus_text"]

# power-of-two bounds 1µs .. ~67s (27 finite buckets + the +Inf bucket);
# log-spaced so one grid serves µs-scale collectives and minute-scale
# compiles with constant relative error
BUCKET_BOUNDS: Tuple[float, ...] = tuple(1e-6 * 2 ** i for i in range(27))


class Histogram:
    """Thread-safe log-bucketed histogram of nonnegative seconds."""

    __slots__ = ("name", "_counts", "_count", "_sum", "_max", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._counts = [0] * (len(BUCKET_BOUNDS) + 1)  # +1: the +Inf bucket
        self._count = 0
        self._sum = 0.0
        self._max = 0.0
        self._lock = threading.Lock()

    @staticmethod
    def _bucket_index(value: float) -> int:
        if value <= BUCKET_BOUNDS[0]:
            return 0
        if value > BUCKET_BOUNDS[-1]:
            return len(BUCKET_BOUNDS)
        # buckets are exact powers of two of 1e-6: index via log2
        return int(math.ceil(math.log2(value / 1e-6)))

    def observe(self, value: float) -> None:
        value = float(value)
        if value < 0.0 or value != value:  # negative / NaN: drop, never raise
            return
        i = self._bucket_index(value)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += value
            if value > self._max:
                self._max = value

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(BUCKET_BOUNDS) + 1)
            self._count = 0
            self._sum = 0.0
            self._max = 0.0

    # -- reading ---------------------------------------------------------
    def _snap(self):
        with self._lock:
            return list(self._counts), self._count, self._sum, self._max

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def max(self) -> float:
        with self._lock:
            return self._max

    def percentile(self, q: float) -> float:
        """Bucket-interpolated quantile estimate, clamped to the exact
        max (so p100-ish asks never report a bucket bound above the
        largest value ever seen).  ``q`` in [0, 100]."""
        counts, count, _sum, mx = self._snap()
        if count == 0:
            return 0.0
        rank = q / 100.0 * count
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= rank:
                lo = BUCKET_BOUNDS[i - 1] if 0 < i <= len(BUCKET_BOUNDS) \
                    else 0.0
                hi = BUCKET_BOUNDS[i] if i < len(BUCKET_BOUNDS) else mx
                frac = (rank - cum) / c
                return min(lo + (max(hi, lo) - lo) * frac, mx)
            cum += c
        return mx

    def summary(self) -> Dict[str, float]:
        counts, count, total, mx = self._snap()
        out = {"count": count, "sum": round(total, 6)}
        if count:
            out.update(
                mean=round(total / count, 6),
                p50=round(self.percentile(50), 6),
                p95=round(self.percentile(95), 6),
                p99=round(self.percentile(99), 6),
                max=round(mx, 6),
            )
        return out

    def cumulative_buckets(self) -> List[Tuple[float, int]]:
        """Prometheus-style (le_upper_bound, cumulative_count) rows,
        ending with (+inf, total)."""
        counts, count, _sum, _mx = self._snap()
        rows, cum = [], 0
        for bound, c in zip(BUCKET_BOUNDS, counts):
            cum += c
            rows.append((bound, cum))
        rows.append((math.inf, count))
        return rows


class HistogramRegistry:
    """Process-wide singleton, same shape as monitor.StatRegistry."""

    _instance: "HistogramRegistry" = None  # type: ignore[assignment]
    _instance_lock = threading.Lock()

    def __init__(self):
        self._hists: Dict[str, Histogram] = {}
        self._lock = threading.Lock()

    @classmethod
    def instance(cls) -> "HistogramRegistry":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(name)
            return h

    def export(self) -> List[Tuple[str, Histogram]]:
        with self._lock:
            return sorted(self._hists.items())

    def reset(self, name: Optional[str] = None) -> None:
        if name is not None:
            self.histogram(name).reset()
            return
        with self._lock:
            hists = list(self._hists.values())
        for h in hists:
            h.reset()


def histogram(name: str) -> Histogram:
    return HistogramRegistry.instance().histogram(name)


def stat_time(name: str, seconds: float) -> None:
    """Record one latency observation (the timing sibling of
    ``monitor.stat_add``).  Name by unit: ``*_seconds``."""
    HistogramRegistry.instance().histogram(name).observe(seconds)


def export_histograms() -> Dict[str, Dict[str, float]]:
    return {n: h.summary()
            for n, h in HistogramRegistry.instance().export()}


def histogram_summaries() -> List[Tuple[str, float]]:
    """Flattened (``<name>_<stat>``, value) rows for
    ``monitor.export_stats()`` — quantiles ride the same snapshot the
    counters do, so ``/stats`` and user dashboards get p50/p95/p99
    without a second API."""
    rows: List[Tuple[str, float]] = []
    for name, h in HistogramRegistry.instance().export():
        for k, v in h.summary().items():
            rows.append((f"{name}_{k}", v))
    return rows


# ---------------------------------------------------------------------------
# Prometheus text exposition (the serving/fleet /metrics route)
# ---------------------------------------------------------------------------

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _metric_name(name: str, namespace: str) -> str:
    n = _NAME_RE.sub("_", name)
    if n and n[0].isdigit():
        n = "_" + n
    return f"{namespace}_{n}"


def _fmt(v) -> str:
    if v == math.inf:
        return "+Inf"
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


def prometheus_text(namespace: str = "paddle_tpu") -> str:
    """Render every StatRegistry counter (as a gauge: our counters can
    be reset) and every histogram (as a real cumulative-bucket
    histogram) in Prometheus/OpenMetrics text-exposition format v0.0.4.

    Served by the fleet KV HTTP server's ``/metrics`` route:
    ``curl :port/metrics | promtool check metrics`` parses clean.
    """
    from ..monitor import StatRegistry

    lines: List[str] = []
    for name, value in StatRegistry.instance().export():
        m = _metric_name(name, namespace)
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m} {_fmt(value)}")
    for name, h in HistogramRegistry.instance().export():
        m = _metric_name(name, namespace)
        lines.append(f"# TYPE {m} histogram")
        for bound, cum in h.cumulative_buckets():
            lines.append(f'{m}_bucket{{le="{_fmt(bound)}"}} {cum}')
        lines.append(f"{m}_sum {_fmt(h.sum)}")
        lines.append(f"{m}_count {h.count}")
    return "\n".join(lines) + "\n"
