"""Anomaly-triggered + continuous ``torch.profiler`` capture.

Counterpart of ``paddle_tpu/observe/profiler_capture.py`` (which
captures ``jax.profiler`` traces).  The phase-attribution engine
(``observe/phases.py``) says where a step went on *average*; this
module answers "what happened at 03:12 when p99 doubled" --
automatically, with the evidence already on disk when a human looks.

- **Anomaly trigger** (``FLAGS_prof_trigger_ratio``): every drained
  step's wall time feeds a rolling-median baseline; a step exceeding
  ``ratio x baseline`` -- or any ``slo_burn_rate_*_ppm`` gauge past its
  budget -- fires ONE bounded capture: a ``torch.profiler`` window of at
  most ``FLAGS_prof_capture_s`` seconds plus a phase snapshot, dumped
  as a postmortem bundle (``phases.json`` section, rendered by
  ``python -m tools.postmortem``).  The trigger then latches until the
  step time drops back under the threshold, and a
  ``FLAGS_prof_cooldown_s`` quiet period follows every capture, so one
  episode produces one bundle, not one per step -- and the capture's
  own overhead can never re-trigger it.
- **Continuous mode** (``FLAGS_prof_continuous_s``): a daemon thread
  captures one bounded window every N seconds (duty cycle
  ``capture_s / continuous_s``) into a 2-deep rotating directory set --
  the always-on profiling mode, without bundles.

A window traces ``ProfilerActivity.CPU`` and, once a CUDA context
exists, ``ProfilerActivity.CUDA`` (CUPTI records every kernel of the
process, those of CUDA-graph replays included), and writes
``<dir>/<pid>.trace.json`` through ``export_chrome_trace``.  On the card
a window is started and stopped on the training thread, in the drain
hook, never beside its launches: stopped on another thread while the
training thread replays a CUDA graph, the profiler's flush and the
replay can block each other for good (seen on an H100).  So a firing
step opens its window where it drains, a later drain closes it once
``FLAGS_prof_capture_s`` has passed, and the daemon thread only writes
the trace and the bundle.  The window stays bounded: one that no drain
has closed ``STOP_GRACE_S`` past its time (the loop stopped draining)
is closed by the daemon thread; ``wait`` closes it on its caller's
thread.  Continuous windows on the card are opened and closed by the
drain hook the same way; where no CUDA context exists the daemon
thread opens and closes them itself.  The drained step after a closing
one carries the stop and is not fed to the baseline.  Where the
profiler cannot start on the CPU, ``prof_trace_unavailable`` is counted
and the phase snapshot still lands; on the card a failure is no such
skip: it is counted as ``prof_capture_errors`` and its message lands in
the bundle's ``meta.json``.  Trace directories are summarized
best-effort (file count/bytes + event count of the Chrome traces).
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Dict, List, Optional

from ..framework import flags as _flags
from ..monitor import stat_add, stat_set

__all__ = ["CaptureEngine", "capture_engine", "on_step_drained",
           "maybe_start_continuous", "stop_continuous", "parse_trace_dir",
           "reset_capture"]

BASELINE_WINDOW = 64   # rolling step-time samples behind the median
BASELINE_WARMUP = 8    # steps before the trigger may fire
STOP_GRACE_S = 10.0    # past a window's time, a drain's time to close it


def _burning_slo() -> Optional[str]:
    """Name of the first SLO objective burning past budget
    (``slo_burn_rate_<name>_ppm`` > 1e6), or None."""
    from ..monitor import StatRegistry

    for name, value in StatRegistry.instance().export():
        if name.startswith("slo_burn_rate_") and name.endswith("_ppm") \
                and value > 1_000_000:
            return name
    return None


def _activities():
    """CPU, and CUDA once a CUDA context exists (the profiler must not be
    the call that creates one)."""
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_initialized():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _profiler_start(trace_dir: str):
    """(a started ``torch.profiler.profile`` writing to ``trace_dir``,
    None) or (None, the error on the card, or None where the CPU cannot
    trace: ``prof_trace_unavailable``)."""
    import torch

    acts = None
    try:
        os.makedirs(trace_dir, exist_ok=True)
        acts = _activities()
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        return prof, None
    except Exception as e:  # noqa: BLE001 - judged below
        if acts is not None and len(acts) > 1:
            stat_add("prof_capture_errors")
            return None, f"{type(e).__name__}: {e}"
        stat_add("prof_trace_unavailable")
        return None, None


def _profiler_export(prof, trace_dir: str) -> Optional[str]:
    """Write the stopped ``prof``'s Chrome trace into ``trace_dir``;
    the error text, or None."""
    try:
        prof.export_chrome_trace(
            os.path.join(trace_dir, f"{os.getpid()}.trace.json"))
    except Exception as e:  # noqa: BLE001 - a capture must not kill callers
        stat_add("prof_capture_errors")
        return f"{type(e).__name__}: {e}"
    return None


def parse_trace_dir(directory: str) -> Dict:
    """Best-effort summary of a trace directory: file count + total
    bytes always; trace-event count where a ``*.trace.json(.gz)`` is
    present and parseable."""
    out: Dict = {"dir": directory, "files": 0, "bytes": 0}
    try:
        paths: List[str] = []
        for root, _dirs, files in os.walk(directory):
            for f in files:
                paths.append(os.path.join(root, f))
        out["files"] = len(paths)
        out["bytes"] = sum(os.path.getsize(p) for p in paths)
        events = 0
        for p in paths:
            if p.endswith(".trace.json.gz") or p.endswith(".trace.json"):
                try:
                    if p.endswith(".gz"):
                        import gzip

                        with gzip.open(p, "rt") as f:
                            doc = json.load(f)
                    else:
                        with open(p) as f:
                            doc = json.load(f)
                    events += len(doc.get("traceEvents", []))
                except Exception:  # noqa: BLE001 - summary only
                    continue
        if events:
            out["trace_events"] = events
    except OSError:
        pass
    return out


class _Window:
    """One bounded profiler window: opened (``open``) and closed
    (``close``) on the thread that launches, written out by the daemon
    thread once ``closed`` is set."""

    __slots__ = ("trace_dir", "capture_s", "prof", "error", "t_open",
                 "closed")

    def __init__(self, trace_dir: str, capture_s: float):
        self.trace_dir = trace_dir
        self.capture_s = capture_s
        self.prof = None
        self.error: Optional[str] = None
        self.t_open = 0.0
        self.closed = threading.Event()

    def open(self) -> None:
        self.prof, self.error = _profiler_start(self.trace_dir)
        self.t_open = time.monotonic()
        if self.prof is None:
            self.closed.set()

    def due(self) -> bool:
        return self.t_open > 0.0 and \
            time.monotonic() - self.t_open >= self.capture_s

    def close(self) -> None:
        try:
            self.prof.stop()
        except Exception as e:  # noqa: BLE001 - a capture must not kill
            stat_add("prof_capture_errors")
            self.error = f"{type(e).__name__}: {e}"
        finally:
            self.closed.set()

    def write(self) -> Optional[Dict]:
        """The trace written and summarized: ``parse_trace_dir``'s dict,
        ``{"error": ...}``, or ``{"unavailable": True}`` where the CPU
        cannot trace (None if the window never opened)."""
        if self.t_open == 0.0:
            return None
        if self.prof is None:
            return {"error": self.error} if self.error \
                else {"unavailable": True}
        if self.error is None:
            self.error = _profiler_export(self.prof, self.trace_dir)
        self.prof = None
        if self.error is not None:
            return {"error": self.error}
        return parse_trace_dir(self.trace_dir)


class CaptureEngine:
    """Rolling baseline + latched anomaly capture + continuous mode;
    one instance per process (the executor drain feeds the module
    singleton)."""

    def __init__(self, window: int = BASELINE_WINDOW,
                 warmup: int = BASELINE_WARMUP):
        self._lock = threading.Lock()
        self._samples = collections.deque(maxlen=int(window))
        self.warmup = int(warmup)
        self._latched = False
        self._last_burn_check = 0.0
        self._burning = False
        self._last_capture_t = 0.0
        self._capture_thread: Optional[threading.Thread] = None
        self._continuous_thread: Optional[threading.Thread] = None
        self._continuous_stop = threading.Event()
        # the open window, and a continuous one waiting for a drain to
        # open it; drained steps still to keep out of the baseline
        self._window: Optional[_Window] = None
        self._pending: Optional[_Window] = None
        self._skip = 0
        self.captures = 0
        self.bundles: List[str] = []

    # -- baseline + trigger (executor drain path) ------------------------
    def _baseline(self) -> float:
        s = sorted(self._samples)
        return s[len(s) // 2] if s else 0.0

    def on_step(self, wall_s: float, compiled: bool = False) -> None:
        """Feed one drained step; fires at most one capture per
        anomaly episode.  First-call (compile) steps never feed the
        baseline — a compile is not a regression."""
        ratio = float(_flags.flag("prof_trigger_ratio") or 0.0)
        if ratio <= 0.0 or compiled:
            return
        if self._skip:
            self._skip -= 1
            return
        wall = max(float(wall_s), 0.0)
        # the SLO-burn probe walks the stat registry: throttle it to
        # ~1/s so the trigger path stays amortized-free per step
        now = time.monotonic()
        burn = None
        if now - self._last_burn_check >= 1.0:
            self._last_burn_check = now
            burn = _burning_slo()
            self._burning = burn is not None
        fire: Optional[str] = None
        cooldown = float(_flags.flag("prof_cooldown_s") or 0.0)
        with self._lock:
            base = self._baseline()
            armed = len(self._samples) >= self.warmup
            spiking = armed and base > 0.0 and wall > ratio * base
            if not spiking:
                # a spiking step never joins the baseline: the anomaly
                # must not drag its own detector upward
                self._samples.append(wall)
            capturing = self._window is not None or (
                self._capture_thread is not None
                and self._capture_thread.is_alive())
            cooling = now - self._last_capture_t < cooldown \
                and self._last_capture_t > 0.0
            if (spiking or burn is not None) and not self._latched \
                    and not capturing and not cooling:
                self._latched = True
                self._last_capture_t = now
                fire = (f"step_time {wall * 1e3:.1f}ms > {ratio:g}x "
                        f"baseline {base * 1e3:.1f}ms") if spiking \
                    else f"slo_burn {burn}"
            elif self._latched and not spiking and not self._burning:
                self._latched = False  # episode over: re-arm
        if fire is not None:
            self._start_capture(fire)

    # -- windows (opened and closed where the steps drain) ---------------
    def service(self) -> None:
        """Drain-path half of the windows, on the training thread: close
        the open window once its time is up, open a requested one."""
        w = self._window
        if w is not None and w.due() and self._take(w):
            w.close()
            self._skip = 1      # the next drained step carries the stop
        p = self._pending
        if p is not None and self._window is None:
            with self._lock:
                if self._pending is not p or self._window is not None:
                    return
                self._pending, self._window = None, p
            p.open()
            if p.prof is None:
                self._take(p)

    def _take(self, w: _Window) -> bool:
        """Whether this caller took ``w`` off as the open window (and so
        closes it)."""
        with self._lock:
            if self._window is not w:
                return False
            self._window = None
            return True

    def _await_close(self, w: _Window, t_requested: float) -> None:
        """Wait for a drain to close ``w``.  Past ``STOP_GRACE_S`` beyond
        its time with no drain, take it back: close it here if it is
        open, drop it if it never opened."""
        while not w.closed.is_set():
            start = w.t_open or t_requested
            left = start + w.capture_s + STOP_GRACE_S - time.monotonic()
            if left > 0:
                w.closed.wait(min(left, 0.5))
                continue
            with self._lock:
                if self._pending is w:
                    self._pending = None
                    w.closed.set()
                    return
                mine = self._window is w and w.t_open > 0.0
                if mine:
                    self._window = None
            if mine:
                w.close()
            else:
                w.closed.wait(0.5)

    # -- one bounded capture ---------------------------------------------
    def _start_capture(self, trigger: str) -> None:
        """Open the window on this (the draining) thread; the daemon
        thread waits for it to close and writes the bundle."""
        stat_add("prof_captures_triggered")
        capture_s = max(float(_flags.flag("prof_capture_s") or 0.0), 0.0)
        base = _flags.flag("postmortem_dir") or "postmortem"
        w = _Window(os.path.join(
            str(base), f"prof_{time.strftime('%Y%m%d_%H%M%S')}_"
                       f"{os.getpid()}"), capture_s)
        with self._lock:
            self._window = w
        w.open()
        if w.prof is None:
            self._take(w)
        t = threading.Thread(target=self._capture, args=(trigger, w),
                             name="prof-capture", daemon=True)
        with self._lock:
            self._capture_thread = t
        t.start()

    def _capture(self, trigger: str, w: _Window) -> None:
        from . import flight as _flight
        from . import health as _health

        _flight.record("prof/capture_start", trigger=trigger,
                       trace=w.prof is not None, capture_s=w.capture_s)
        self._await_close(w, w.t_open)
        profiler = w.write() or {"unavailable": True}
        try:
            bundle = _health.dump_postmortem(
                "step_time_anomaly",
                extra={"trigger": trigger, "profiler": profiler,
                       "prof_capture_s": w.capture_s})
        except Exception:  # noqa: BLE001 - capture must not kill callers
            bundle = None
        with self._lock:
            self.captures += 1
            if bundle:
                self.bundles.append(bundle)
        stat_add("prof_captures")
        stat_set("prof_capture_latched", 1)
        _flight.record("prof/capture_done", trigger=trigger,
                       bundle=bundle or "")

    def _close_open_window(self, timeout: float) -> None:
        """Close the open window on this thread, once its time is up
        (at most ``timeout`` from now)."""
        w = self._window
        if w is None:
            return
        deadline = time.monotonic() + timeout
        while not w.due() and time.monotonic() < deadline \
                and self._window is w:
            time.sleep(0.01)
        if self._take(w):
            w.close()

    def wait(self, timeout: float = 30.0) -> bool:
        """Close an open window on this thread once its time is up and
        join the in-flight capture thread (tests/bench); returns whether
        it finished."""
        t_end = time.monotonic() + timeout
        self._close_open_window(timeout)
        with self._lock:
            t = self._capture_thread
        if t is None:
            return True
        t.join(max(t_end - time.monotonic(), 0.0))
        return not t.is_alive()

    # -- continuous low-duty-cycle mode ----------------------------------
    def start_continuous(self) -> bool:
        """Start the continuous-profiling daemon when
        ``FLAGS_prof_continuous_s`` > 0; idempotent."""
        period = float(_flags.flag("prof_continuous_s") or 0.0)
        if period <= 0.0:
            return False
        with self._lock:
            if self._continuous_thread is not None \
                    and self._continuous_thread.is_alive():
                return True
            self._continuous_stop.clear()
            self._continuous_thread = threading.Thread(
                target=self._continuous_loop, args=(period,),
                name="prof-continuous", daemon=True)
            self._continuous_thread.start()
        return True

    def _continuous_window(self, w: _Window) -> None:
        """One continuous window: requested from the drain hook on the
        card, opened and closed here where no CUDA context exists."""
        import torch

        if torch.cuda.is_initialized():
            with self._lock:
                if self._window is not None or self._pending is not None:
                    return              # an anomaly window is open
                self._pending = w
            self._await_close(w, time.monotonic())
            return
        w.open()
        if w.prof is not None:
            time.sleep(w.capture_s)
            w.close()

    def _continuous_loop(self, period: float) -> None:
        from . import flight as _flight

        base = _flags.flag("postmortem_dir") or "postmortem"
        root = os.path.join(str(base), "prof_continuous")
        n = 0
        while not self._continuous_stop.wait(period):
            capture_s = max(float(_flags.flag("prof_capture_s") or 0.0),
                            0.0)
            # 2-deep rotation: slot index alternates, so disk usage is
            # bounded at two windows no matter how long the fleet runs
            trace_dir = os.path.join(root, f"window_{n % 2}")
            n += 1
            try:
                import shutil

                shutil.rmtree(trace_dir, ignore_errors=True)
                os.makedirs(trace_dir, exist_ok=True)
            except OSError:
                continue
            w = _Window(trace_dir, capture_s)
            self._continuous_window(w)
            out = w.write()
            if out is None or "error" in out or out.get("unavailable"):
                continue
            stat_add("prof_continuous_captures")
            _flight.record("prof/continuous_window", **out)

    def stop_continuous(self) -> None:
        self._continuous_stop.set()
        with self._lock:
            t, self._continuous_thread = self._continuous_thread, None
        if t is not None:
            t.join(timeout=5)

    def reset(self) -> None:
        self.stop_continuous()
        self.wait(timeout=5)
        with self._lock:
            self._pending = None
            self._samples.clear()
            self._latched = False
            self._last_burn_check = 0.0
            self._burning = False
            self._last_capture_t = 0.0
            self._skip = 0
            self.captures = 0
            self.bundles = []
        stat_set("prof_capture_latched", 0)


_ENGINE = CaptureEngine()


def capture_engine() -> CaptureEngine:
    return _ENGINE


def on_step_drained(wall_s: float, compiled: bool = False) -> None:
    """Drain-path hook (framework/executor.py), on the training thread:
    the trigger, then the windows' opening and closing; never raises."""
    try:
        _ENGINE.on_step(wall_s, compiled=compiled)
        if _ENGINE._window is not None or _ENGINE._pending is not None:
            _ENGINE.service()
    except Exception:  # noqa: BLE001 - observer only
        stat_add("prof_trigger_errors")


def maybe_start_continuous() -> bool:
    """Auto-start hook (Executor construction): the continuous daemon
    when ``FLAGS_prof_continuous_s`` > 0, else nothing."""
    try:
        return _ENGINE.start_continuous()
    except Exception:  # noqa: BLE001
        return False


def stop_continuous() -> None:
    _ENGINE.stop_continuous()


def reset_capture() -> None:
    _ENGINE.reset()
