"""SLO objectives, multi-window burn rates, and goodput for serving.

Role: the Google SRE-workbook control plane over the per-request
timelines in ``observe/request_trace.py``.  Raw ``decode_tokens_per_sec``
can rise while users suffer — tokens streamed after a blown deadline
are waste.  This module makes "did users feel it" first-class:

- **Objectives** are declarative per-request predicates with an error
  budget: ``ttft p99 <= X ms`` (budget 1%: up to 1% of requests may
  exceed X), ``tpot p50 <= Y ms`` (budget 50%, against the request's
  MEAN time-per-output-token), ``error-rate <= Z`` (budget Z: a
  request is bad when its outcome is not ``completed``).  Defaults
  come from ``FLAGS_slo_*``; :func:`configure` replaces them at
  runtime (bench/tests/deployment).
- **Burn rate** (the SRE-workbook multi-window formulation): for each
  objective and each rolling window (``FLAGS_slo_windows_s``, default
  60s and 300s), ``burn = bad_fraction / budget_fraction`` — 1.0 means
  exactly consuming budget, 14.4 on a 1h window is the classic
  page-now threshold.  The emitted gauge is the MAX across windows
  (short window catches fast burn, long window catches slow bleed):
  ``slo_burn_rate_<name>_ppm`` (parts-per-million fixed point) plus a
  rounded integer ``slo_burn_rate_<name>``, and
  ``slo_budget_remaining_<name>_ppm`` (fraction of the long window's
  budget still unspent; 0 when exhausted).
- **Goodput**: ``decode_goodput_rps`` (+ ``_ppm`` float precision) =
  completions meeting ALL objectives per second over the short window
  — the number capacity work should optimize once raw tokens/sec stops
  being what users feel.  ``decode_slo_violations`` counts objective
  violations (one per objective per request).

Gauges refresh on every terminal request observation and on
:func:`snapshot` (so a ``/metrics`` scrape after a quiet period still
reads internally consistent values from the last refresh).
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Sequence

from ..framework import flags as _flags
from ..monitor import stat_add, stat_set

__all__ = ["Objective", "SLOEngine", "get_slo_engine", "configure",
           "observe_request", "snapshot", "refresh_gauges",
           "default_objectives"]


class Objective:
    """One declarative objective: ``metric`` in ``{"ttft", "tpot",
    "latency", "error"}``, ``threshold_s`` (None for ``error``), and
    the error-budget fraction (p99 latency objective -> 0.01)."""

    __slots__ = ("name", "metric", "threshold_s", "budget")

    def __init__(self, name: str, metric: str,
                 threshold_s: Optional[float], budget: float):
        if metric not in ("ttft", "tpot", "latency", "error"):
            raise ValueError(f"unknown SLO metric {metric!r}")
        if not 0.0 < float(budget) <= 1.0:
            raise ValueError("budget must be a fraction in (0, 1]")
        if metric != "error" and threshold_s is None:
            raise ValueError(
                f"a {metric!r} objective needs a threshold_s (only "
                f"'error' objectives are threshold-free)")
        self.name = str(name)
        self.metric = metric
        self.threshold_s = None if threshold_s is None \
            else float(threshold_s)
        self.budget = float(budget)

    def is_violated(self, summary: dict) -> bool:
        """Judge one terminal request summary (keys: ``outcome``,
        ``ttft_s``, ``tpot_s``, ``latency_s``).  A ttft/latency
        objective treats a request that never produced the measured
        signal (died before first token) as violated — a blown
        deadline must not read as 'fast'.  A missing ``tpot_s`` is NOT
        a violation: a normal 1-token completion has no
        time-per-output-token at all."""
        if self.metric == "error":
            return summary.get("outcome") != "completed"
        v = summary.get(f"{self.metric}_s")
        if v is None:
            return self.metric != "tpot"
        return float(v) > self.threshold_s

    def to_dict(self) -> dict:
        return {"name": self.name, "metric": self.metric,
                "threshold_ms": None if self.threshold_s is None
                else round(self.threshold_s * 1e3, 3),
                "budget": self.budget}


def default_objectives() -> List[Objective]:
    """Objectives from the ``FLAGS_slo_*`` registry (0 disables a
    latency objective; the error-rate objective is always on so
    goodput/burn gauges exist out of the box)."""
    out: List[Objective] = []
    try:
        ttft_ms = float(_flags.flag("slo_ttft_p99_ms"))
        tpot_ms = float(_flags.flag("slo_tpot_p50_ms"))
        err_ppm = int(_flags.flag("slo_error_rate_ppm"))
    except KeyError:  # pragma: no cover - partial installs
        ttft_ms, tpot_ms, err_ppm = 0.0, 0.0, 10000
    if ttft_ms > 0:
        out.append(Objective("ttft_p99", "ttft", ttft_ms / 1e3, 0.01))
    if tpot_ms > 0:
        out.append(Objective("tpot_p50", "tpot", tpot_ms / 1e3, 0.50))
    if err_ppm > 0:
        out.append(Objective("error_rate", "error", None, err_ppm / 1e6))
    return out


def _windows() -> tuple:
    try:
        raw = str(_flags.flag("slo_windows_s"))
    except KeyError:  # pragma: no cover - partial installs
        raw = "60,300"
    ws = []
    for part in raw.split(","):
        part = part.strip()
        if part:
            ws.append(max(float(part), 1e-3))
    return tuple(sorted(ws)) or (60.0, 300.0)


class SLOEngine:
    """Rolling multi-window evaluator.  ``observe(summary)`` is called
    once per terminal request (any replica — the gauges are fleet-wide
    per process, like every StatRegistry series) and returns the list
    of violated objective names, which the trace store uses for tail
    retention."""

    def __init__(self, objectives: Optional[Sequence[Objective]] = None,
                 windows: Optional[Sequence[float]] = None,
                 gauge_prefix: str = "decode"):
        self._objectives = list(objectives) if objectives is not None \
            else default_objectives()
        self._windows = tuple(sorted(windows)) if windows else _windows()
        self._prefix = str(gauge_prefix)
        # (t, tuple(violated names), good_completion)
        self._events: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._violations_total = 0
        self._t_gauges = 0.0  # last gauge refresh (throttle)

    @property
    def objectives(self) -> List[Objective]:
        return list(self._objectives)

    @property
    def windows(self) -> tuple:
        return self._windows

    # -- observation ------------------------------------------------------
    def observe(self, summary: dict) -> List[str]:
        violated = [o.name for o in self._objectives
                    if o.is_violated(summary)]
        good = (not violated) and summary.get("outcome") == "completed"
        now = time.monotonic()
        with self._lock:
            self._events.append((now, tuple(violated), good))
            self._violations_total += len(violated)
            self._update_gauges_locked(now)
        if violated:
            stat_add(f"{self._prefix}_slo_violations", len(violated))
        return violated

    # -- evaluation (ONE implementation behind gauges AND snapshot) -------
    def _evaluate_locked(self, now: float) -> Dict:
        """Prune beyond the long window and compute per-objective
        burn-per-window + long-window budget remaining + short-window
        goodput.  Called with the lock held."""
        long_w = self._windows[-1]
        while self._events and self._events[0][0] < now - long_w:
            self._events.popleft()
        evs = self._events
        # one pass per window over the time-ordered deque (windows are
        # sorted ascending, so iterate from the right and cut early)
        per_window: Dict[float, Dict] = {}
        for w in self._windows:
            cutoff = now - w
            n = 0
            bad: Dict[str, int] = {}
            good = 0
            for t, violated, is_good in reversed(evs):
                if t < cutoff:
                    break
                n += 1
                good += is_good
                for name in violated:
                    bad[name] = bad.get(name, 0) + 1
            per_window[w] = {"n": n, "bad": bad, "good": good}
        out: Dict = {"burn": {}, "remaining": {}}
        for o in self._objectives:
            burn = 0.0
            remaining = 1.0
            rates = {}
            for w in self._windows:
                pw = per_window[w]
                frac = (pw["bad"].get(o.name, 0) / pw["n"]) \
                    if pw["n"] else 0.0
                rate = frac / o.budget
                rates[f"{int(w)}s"] = rate
                burn = max(burn, rate)
                if w == long_w:
                    remaining = max(1.0 - rate, 0.0)
            out["burn"][o.name] = {"max": burn, "windows": rates}
            out["remaining"][o.name] = remaining
        # goodput over the SHORT window, against time actually elapsed
        # (a 3-second-old process must not divide 3s of completions by
        # a 60s window)
        short_w = self._windows[0]
        span = min(short_w, max(now - self._t0, 1e-3))
        out["goodput_rps"] = per_window[short_w]["good"] / span
        out["observed"] = len(evs)
        return out

    def _update_gauges_locked(self, now: float,
                              force: bool = False) -> Optional[Dict]:
        # throttled: observe() runs on the engine thread per terminal
        # request — at high request rates the window scan must not run
        # per completion (snapshot() always forces a fresh view).
        # Returns the evaluation dict when it ran, so snapshot() does
        # not pay the window scan twice.
        if not force and now - self._t_gauges < 0.5:
            return None
        self._t_gauges = now
        ev = self._evaluate_locked(now)
        for o in self._objectives:
            burn = ev["burn"][o.name]["max"]
            stat_set(f"slo_burn_rate_{o.name}", int(round(burn)))
            stat_set(f"slo_burn_rate_{o.name}_ppm", int(burn * 1e6))
            stat_set(f"slo_budget_remaining_{o.name}_ppm",
                     int(ev["remaining"][o.name] * 1e6))
        rps = ev["goodput_rps"]
        stat_set(f"{self._prefix}_goodput_rps", int(round(rps)))
        stat_set(f"{self._prefix}_goodput_rps_ppm", int(rps * 1e6))
        return ev

    def snapshot(self) -> Dict:
        """Objectives + current burn/budget/goodput numbers (refreshes
        the gauges); the ``/debug/slo`` route and postmortem
        ``requests.json`` serve this."""
        now = time.monotonic()
        with self._lock:
            ev = self._update_gauges_locked(now, force=True)
            violations_total = self._violations_total
        return {
            "objectives": [o.to_dict() for o in self._objectives],
            "windows_s": list(self._windows),
            "observed": ev["observed"],
            "violations_total": violations_total,
            "burn_rates": {
                name: {w: round(r, 6) for w, r in b["windows"].items()}
                for name, b in ev["burn"].items()},
            "budget_remaining": {
                name: round(r, 6) for name, r in ev["remaining"].items()},
            "goodput_rps": round(ev["goodput_rps"], 6),
        }

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._violations_total = 0
            self._t0 = time.monotonic()


_ENGINE = SLOEngine()
_ENGINE_LOCK = threading.Lock()


def get_slo_engine() -> SLOEngine:
    return _ENGINE


def configure(objectives: Optional[Sequence[Objective]] = None,
              windows: Optional[Sequence[float]] = None) -> SLOEngine:
    """Replace the process SLO engine (``None`` objectives: rebuild
    from the ``FLAGS_slo_*`` defaults).  Returns the new engine."""
    global _ENGINE
    with _ENGINE_LOCK:
        _ENGINE = SLOEngine(objectives, windows)
    return _ENGINE


def observe_request(summary: dict) -> List[str]:
    """Feed one terminal request summary; returns violated objective
    names (the trace store's tail-retention signal)."""
    return _ENGINE.observe(summary)


def snapshot() -> Dict:
    return _ENGINE.snapshot()


def refresh_gauges() -> None:
    """Force-refresh the burn/budget/goodput gauges against the
    current window contents.  The fleet KV HTTP server calls this per
    ``/metrics`` scrape: without it a burst of violations followed by
    silence would freeze the gauges at their peak forever (they
    otherwise refresh only on terminal-request observations)."""
    now = time.monotonic()
    eng = _ENGINE
    with eng._lock:
        eng._update_gauges_locked(now, force=True)
