"""Per-step telemetry: step-time distribution, throughput, MFU.

Counterpart of ``paddle_tpu/observe/step_stats.py``: the Executor feeds
ONE ``StepTimer`` per process from ``run``/``run_steps``, each call
recording its wall time, step count, example count and the program's
FLOPs (``hapi/model_stat.py`` accounting over the program IR, scaled by
the feed's batch when the program's batch dim is symbolic).

Out the other end:
- ``step_time_seconds`` histogram (p50/p95/p99 via observe/histogram);
- ``summary()``: examples/sec, the warm-up-vs-steady wall split, the
  allreduce bytes a step (the post-pass program's allreduce payload, from
  the Executor), and an **MFU estimate** = achieved FLOP/s / ``peak_tflops`` (or
  ``FLAGS_device_peak_tflops``; with neither set, MFU is null).

Timing: with the pipelined window (``FLAGS_max_inflight_steps`` > 0,
the default) the Executor records a step when it drains, with the wall
time since the previous drain: in a steady loop, where each dispatch at
the cap drains the oldest step, that is the loop's period, input wait
included.  ``summary()`` and ``reset()`` drain every live Executor first
(``raise_errors=False``: a failure met there is parked and raised at the
next raising drain point), so a summary counts only completed steps and
a reset drops the steps dispatched before it.  With the window at 0,
``run`` records its call when it returns, after its fetches reached the
host (``return_numpy=True``).  A key's first run (eager on the card)
and, on the card, its second (the CUDA-graph capture) are charged to the
compile side, so the steady numbers are replays.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

from ..framework import flags as _flags
from .histogram import histogram, stat_time

__all__ = ["STEP_TIME_HISTOGRAM", "StepTimer", "step_timer",
           "reset_step_stats", "mfu_estimate"]

STEP_TIME_HISTOGRAM = "step_time_seconds"


def _peak(peak_tflops: Optional[float]) -> float:
    return float(peak_tflops if peak_tflops is not None
                 else _flags.flag("device_peak_tflops"))


def mfu_estimate(flops_per_step: float, step_time_s: float,
                 peak_tflops: Optional[float] = None) -> float:
    """Model FLOPs utilization: achieved / peak.  ``peak_tflops``
    defaults to ``FLAGS_device_peak_tflops``; 0.0 without a peak."""
    if step_time_s <= 0.0 or flops_per_step <= 0.0:
        return 0.0
    peak = _peak(peak_tflops)
    if peak <= 0.0:
        return 0.0
    return (flops_per_step / step_time_s) / (peak * 1e12)


class StepTimer:
    """Accumulates per-run telemetry; one instance per process (the
    Executor feeds the module singleton; tests may build their own)."""

    def __init__(self, hist_name: str = STEP_TIME_HISTOGRAM):
        self._lock = threading.Lock()
        self._hist_name = hist_name
        histogram(hist_name)  # registered before the first step runs
        self._zero()

    def _zero(self):
        self.runs = 0
        self.steps = 0
        self.examples = 0
        self.compiles = 0
        self.compile_time = 0.0
        self.execute_time = 0.0
        self.flops = 0.0
        self.allreduce_bytes = 0

    def record_run(self, duration_s: float, steps: int = 1,
                   examples: int = 0, compiled: bool = False,
                   flops_per_step: float = 0.0,
                   allreduce_bytes_per_step: int = 0) -> None:
        steps = max(int(steps), 1)
        with self._lock:
            self.runs += 1
            if compiled:
                # the warm-up and the capture: charged apart so the
                # steady-state numbers stay replays
                self.compiles += 1
                self.compile_time += duration_s
            else:
                self.execute_time += duration_s
                self.steps += steps
                self.examples += int(examples)
                self.flops += flops_per_step * steps
                self.allreduce_bytes += int(allreduce_bytes_per_step) * steps
        if not compiled:
            stat_time(self._hist_name, duration_s / steps)

    def summary(self, peak_tflops: Optional[float] = None) -> Dict:
        _drain_executors()
        with self._lock:
            runs, steps, examples = self.runs, self.steps, self.examples
            compiles = self.compiles
            ct, et = self.compile_time, self.execute_time
            flops, ar_bytes = self.flops, self.allreduce_bytes
        out = {
            "runs": runs,
            "steps": steps,
            "compiles": compiles,
            "compile_time_s": round(ct, 6),
            "execute_time_s": round(et, 6),
            "step_time_s": histogram(self._hist_name).summary(),
        }
        if et > 0.0 and steps:
            out["steps_per_sec"] = round(steps / et, 3)
            if examples:
                out["examples_per_sec"] = round(examples / et, 3)
            out["allreduce_bytes_per_step"] = ar_bytes // steps
            if flops:
                out["flops_per_step"] = int(flops / steps)
                peak = _peak(peak_tflops)
                # null, not a misleading 0.0, without a peak; significant
                # digits so a small model's MFU does not round to zero
                out["mfu"] = float(
                    f"{mfu_estimate(flops / steps, et / steps, peak):.4g}") \
                    if peak > 0.0 else None
        return out

    def reset(self) -> None:
        _drain_executors()
        with self._lock:
            self._zero()
        histogram(self._hist_name).reset()


def _drain_executors() -> None:
    """Drain every live Executor's window, parking failures."""
    from ..framework.executor import drain_all

    drain_all(raise_errors=False)


_STEP_TIMER = StepTimer()


def step_timer() -> StepTimer:
    return _STEP_TIMER


def reset_step_stats() -> None:
    _STEP_TIMER.reset()
