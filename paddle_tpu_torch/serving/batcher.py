"""Request futures shared by the serving layer.

PyTorch port: ``RequestBase`` and the ``_UNSET`` deadline sentinel of
``paddle_tpu/serving/batcher.py`` (no JAX in them), which the decode
engine's ``DecodeRequest`` builds on.  The bucket ``Batcher`` waits for
the static-graph slice.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from ..monitor import stat_add
from ..observe.histogram import stat_time
from .buckets import (DeadlineExceededError, QueueFullError,
                      RequestAbandonedError, ServerClosedError)


class _Unset:
    """"Use the server default" deadline sentinel; the stable repr keeps
    API.spec (which prints default values) deterministic across runs."""

    def __repr__(self):
        return "<server default>"


_UNSET = _Unset()


class RequestBase:
    """Future-like completion/deadline machinery shared by every
    serving request kind: the bucket batcher's ``InferenceRequest``
    below and the decode engine's streaming ``DecodeRequest``
    (serving/decode.py).  The deadline contract is one rule applied at
    EVERY stage a request can sit in: reaped at dequeue, reaped during
    the coalescing window, reaped MID-DECODE at each step boundary
    (the decode scheduler frees the slot so a stalled client cannot
    pin it for the full max_new_tokens), and self-reaped on the
    client's own ``result()`` wait — whichever fires first wins the
    ``_complete`` race."""

    __slots__ = ("deadline", "t_enqueue", "_event", "_lock", "_result",
                 "_error", "trace")

    _deadline_stat = "serving_deadline_exceeded"
    # flat-name outcome counters: <prefix>_requests_total_<outcome>
    _outcome_prefix = "serving"

    def __init__(self, deadline):
        self.deadline = deadline  # absolute monotonic seconds, or None
        self.t_enqueue = time.monotonic()
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._result = None
        self._error = None
        self.trace = None  # observe.request_trace.RequestTrace

    def _complete(self, result=None, error=None) -> bool:
        """First completion wins (batcher and client-side deadline can
        race); returns whether THIS call won."""
        with self._lock:
            if self._event.is_set():
                return False
            self._result, self._error = result, error
            self._event.set()
        try:
            # EVERY terminal path funnels here (engine reply, queue
            # reap, client-side deadline self-reap, abandon, cancel),
            # so the per-outcome counters, terminal latency, the SLO
            # observation, and the trace verdict happen exactly once
            self._on_terminal(error)
        except Exception:  # noqa: BLE001 — instrumentation must never
            stat_add("request_trace_errors")  # break completion
        return True

    # -- terminal accounting ---------------------------------------------
    @staticmethod
    def _classify(error) -> str:
        if error is None:
            return "completed"
        if isinstance(error, DeadlineExceededError):
            return "deadline"
        if isinstance(error, RequestAbandonedError):
            return "abandoned"
        if isinstance(error, QueueFullError):
            return "rejected"
        if isinstance(error, ServerClosedError):
            return "cancelled"
        return "error"

    def _on_terminal(self, error) -> None:
        outcome = self._classify(error)
        latency = time.monotonic() - self.t_enqueue
        stat_add(f"{self._outcome_prefix}_requests_total_{outcome}")
        self._finish_stats(outcome, latency)
        if self.trace is None:
            return
        summary = self._summary(outcome, latency)
        try:
            violations = self._slo_check(summary)
        except Exception:  # noqa: BLE001 — a broken objective must not
            # leak the trace in the in-flight map forever
            stat_add("request_trace_errors")
            violations = ()
        from ..observe.request_trace import get_trace_store

        summary.pop("outcome", None)  # stored top-level on the trace
        get_trace_store().finish(
            self.trace, outcome=outcome,
            reason=summary.pop("reason", None)
            or (f"{type(error).__name__}: {error}" if error else None),
            violations=violations, **summary)

    def _finish_stats(self, outcome: str, latency: float) -> None:
        """Terminal latency for the abnormal paths — the completed path
        records ``serving_latency_seconds`` at reply time already, but
        error-rate SLOs need deadline/abandon/cancel in the
        distribution's denominator too."""
        if outcome != "completed":
            stat_time("serving_latency_seconds", latency)

    def _summary(self, outcome: str, latency: float) -> dict:
        return {"outcome": outcome, "latency_s": round(latency, 6)}

    def _slo_check(self, summary: dict):
        return ()

    def abandon(self, reason: str = "client abandoned") -> bool:
        """Client-side give-up: completes the request with
        ``RequestAbandonedError`` (outcome ``abandoned``); the engine
        frees any slot/queue entry it holds at the next boundary."""
        return self._complete(error=RequestAbandonedError(reason))

    def expired(self, now=None) -> bool:
        return self.deadline is not None and \
            (now if now is not None else time.monotonic()) >= self.deadline

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block until completed; raises the request's error if it
        failed.  A deadline-carrying request stops waiting at its
        deadline and completes itself with ``DeadlineExceededError`` if
        the batcher has not produced a result by then.  ``timeout`` is
        the CALLER's wait budget and wins when shorter than the
        deadline: the call raises ``TimeoutError`` and the request stays
        in flight."""
        if self.deadline is not None:
            remaining = max(self.deadline - time.monotonic(), 0.0)
            budget = remaining if timeout is None \
                else min(remaining, timeout)
            if not self._event.wait(budget):
                if timeout is not None and timeout < remaining:
                    raise TimeoutError(
                        "request not completed within timeout")
                if self._complete(error=DeadlineExceededError(
                        f"deadline exceeded after "
                        f"{time.monotonic() - self.t_enqueue:.3f}s "
                        f"(never completed)")):
                    stat_add(self._deadline_stat)
        if not self._event.wait(timeout):
            raise TimeoutError("request not completed within timeout")
        if self._error is not None:
            raise self._error
        return self._result
