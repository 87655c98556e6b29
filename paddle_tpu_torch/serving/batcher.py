"""Dynamic micro-batcher: bounded queue + single consumer thread.

PyTorch port: a copy of ``paddle_tpu/serving/batcher.py`` (no JAX in
it).  ``RequestBase`` is the future the decode engine's
``DecodeRequest`` builds on too.  Concurrent client requests coalesce
into padded bucket batches (``buckets.py``) run one at a time on the
card: the runner is the one-shot ``Server``'s ``Predictor.run``, whose
executor replays the batch bucket's captured graph.  The design is
single-consumer on purpose: the Predictor/Executor pair is not
re-entrant.

Robustness contract:
- bounded queue -- ``submit`` raises ``QueueFullError`` instead of
  growing without limit (explicit backpressure beats silent OOM);
- per-request deadline -- an expired request completes with
  ``DeadlineExceededError`` (reaped at dequeue AND on the client's own
  wait, whichever fires first) and never blocks younger requests;
- graceful drain -- ``stop(drain=True)`` refuses new work, finishes
  what is queued, then joins the consumer thread.

Observability rides monitor.StatRegistry (serving_* counters/gauges)
and ``profiler.RecordEvent`` spans per executed batch.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, Optional

import numpy as np

from ..monitor import stat_add, stat_max, stat_set
from ..observe import tracer as otrace
from ..observe.histogram import stat_time
from ..profiler import RecordEvent
from .buckets import (BucketSpec, DeadlineExceededError, QueueFullError,
                      RequestAbandonedError, ServerClosedError,
                      ServingError, assemble, plan_request)


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


class InferenceRequest(RequestBase):
    """Future-like handle for one in-flight bucket-batcher request."""

    __slots__ = ("feeds", "nrows", "key")

    def __init__(self, feeds, nrows, key, deadline):
        super().__init__(deadline)
        self.feeds = feeds
        self.nrows = nrows
        self.key = key


class Batcher:
    """The queue + consumer loop; ``runner`` executes one padded batch
    (a dict of bucket-shaped feeds) and returns the fetch list."""

    def __init__(self, runner, plans: Dict[str, tuple], spec: BucketSpec,
                 max_queue: int = 128, batch_window_ms: float = 5.0,
                 default_deadline_ms: Optional[float] = None,
                 pad_value=0):
        self._runner = runner
        self._plans = plans
        self._spec = spec
        self._max_queue = int(max_queue)
        if self._max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self._window = float(batch_window_ms) / 1e3
        self._default_deadline_ms = default_deadline_ms
        self._pad_value = pad_value
        self._queue = collections.deque()
        self._cond = threading.Condition()
        self._closing = False
        self._paused = False
        self._thread = None

    # -- client side -----------------------------------------------------
    def submit(self, feeds, deadline_ms=_UNSET) -> InferenceRequest:
        from ..observe.request_trace import get_trace_store

        with otrace.span("serving/enqueue"):
            try:
                arrays, nrows, key = plan_request(feeds, self._plans,
                                                  self._spec)
            except ServingError:
                stat_add("serving_requests_total_rejected")
                raise
            if deadline_ms is _UNSET:
                deadline_ms = self._default_deadline_ms
            deadline = None if deadline_ms is None \
                else time.monotonic() + float(deadline_ms) / 1e3
            req = InferenceRequest(arrays, nrows, key, deadline)
            req.trace = get_trace_store().start(
                "serving", replica="batcher", nrows=nrows,
                key=str(key),
                deadline_ms=None if deadline_ms is None
                else float(deadline_ms))
            with self._cond:
                if self._closing:
                    err = ServerClosedError("server is draining/stopped")
                    req._complete(error=err)
                    raise err
                if len(self._queue) >= self._max_queue:
                    stat_add("serving_rejected_queue_full")
                    err = QueueFullError(
                        f"request queue is at capacity ({self._max_queue}); "
                        f"retry with backoff")
                    req._complete(error=err)
                    raise err
                self._queue.append(req)
                req.trace.event("enqueue", queue_depth=len(self._queue))
                stat_add("serving_requests")
                stat_set("serving_queue_depth", len(self._queue))
                stat_max("serving_queue_depth_max", len(self._queue))
                self._cond.notify_all()
            return req

    def infer(self, feeds, deadline_ms=_UNSET):
        return self.submit(feeds, deadline_ms=deadline_ms).result()

    # -- lifecycle -------------------------------------------------------
    def start(self):
        with self._cond:  # check-and-spawn must be atomic: a second
            # consumer would race the non-reentrant Predictor
            if self._thread is not None:
                return self
            self._closing = False  # a stopped batcher can restart
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="serving-batcher")
            # started INSIDE the lock: a concurrent stop() must never
            # observe (and join) an assigned-but-unstarted thread
            self._thread.start()
        return self

    def pause(self):
        """Hold the consumer (tests / maintenance); queued requests stay
        queued, backpressure still applies."""
        with self._cond:
            self._paused = True
            self._cond.notify_all()

    def resume(self):
        with self._cond:
            self._paused = False
            self._cond.notify_all()

    def stop(self, drain: bool = True):
        with self._cond:
            self._closing = True
            # with no consumer thread there is nothing to drain INTO —
            # cancel the queue rather than strand its waiters
            if not drain or self._thread is None:
                while self._queue:
                    req = self._queue.popleft()
                    if req._complete(error=ServerClosedError(
                            "server stopped before the request ran")):
                        stat_add("serving_cancelled")
                stat_set("serving_queue_depth", 0)
            self._paused = False  # a paused server still drains
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    @property
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._queue)

    def debug_requests(self):
        """Live in-flight table for the ``/debug/requests`` route: one
        row per queued request (trace id, age, rows, bucket key)."""
        with self._cond:
            q = list(self._queue)
        now = time.monotonic()
        return [{
            "trace_id": r.trace.trace_id if r.trace is not None else None,
            "replica": "batcher",
            "phase": "queued",
            "age_ms": round((now - r.t_enqueue) * 1e3, 3),
            "rows": r.nrows,
            "key": str(r.key),
            "deadline_in_ms": None if r.deadline is None
            else round((r.deadline - now) * 1e3, 3),
        } for r in q if not r.done()]

    # -- consumer side ---------------------------------------------------
    def _reap_expired_locked(self):
        now = time.monotonic()
        live = [r for r in self._queue
                if not (r.done() or
                        (r.expired(now) and self._expire(r)))]
        if len(live) != len(self._queue):
            self._queue = collections.deque(live)
            stat_set("serving_queue_depth", len(self._queue))

    @staticmethod
    def _expire(req) -> bool:
        if req._complete(error=DeadlineExceededError(
                "deadline exceeded while queued")):
            stat_add("serving_deadline_exceeded")
        return True  # drop from the queue either way

    def _group_rows_locked(self, key) -> int:
        return sum(r.nrows for r in self._queue
                   if r.key == key and not r.done())

    def _take_group_locked(self, key):
        taken, rest, total = [], [], 0
        now = time.monotonic()
        for r in self._queue:
            if r.done():
                continue  # client-side deadline already answered it
            if r.expired(now):
                # the deadline lapsed during the coalescing window:
                # honor the "reaped at dequeue" contract rather than
                # doing chip work the client contractually abandoned
                self._expire(r)
                continue
            if r.key == key and total + r.nrows <= self._spec.max_batch:
                taken.append(r)
                total += r.nrows
            else:
                rest.append(r)
        self._queue = collections.deque(rest)
        stat_set("serving_queue_depth", len(self._queue))
        return taken

    def _loop(self):
        while True:
            with self._cond:
                while True:
                    self._reap_expired_locked()
                    if self._queue and not self._paused:
                        break
                    if self._closing and not self._queue:
                        return
                    # wake early for new arrivals / resume / stop; the
                    # short cap keeps queued deadlines honest while
                    # paused or idle
                    self._cond.wait(0.05 if self._queue else None)
                head = self._queue[0]
                # the coalescing window IS the span: its duration shows
                # how long requests sat waiting for batch-mates
                with otrace.span("serving/coalesce"):
                    window_end = head.t_enqueue + self._window
                    while (not self._closing
                           and self._group_rows_locked(head.key)
                           < self._spec.max_batch):
                        remaining = window_end - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cond.wait(remaining)
                    batch = self._take_group_locked(head.key)
            if batch:
                self._execute(batch)

    def _execute(self, requests):
        try:  # assembly failures must not kill the consumer thread
            with otrace.span("serving/pad", requests=len(requests)):
                feeds, total, bucket_rows = assemble(
                    requests, requests[0].key, self._spec, self._pad_value)
            for r in requests:
                if r.trace is not None:
                    r.trace.event("execute", bucket_rows=bucket_rows,
                                  batch_mates=len(requests))
            with otrace.span("serving/execute", rows=bucket_rows,
                             requests=len(requests)):
                with RecordEvent(f"serving/batch_b{bucket_rows}"):
                    outs = self._runner(feeds)
                # the reply path owns host copies: the one sync happens
                # here, inside the execute span, so batch latency
                # attribution stays truthful
                outs = [np.asarray(o) for o in outs]
        except Exception as e:  # noqa: BLE001 — fault isolation per batch
            for r in requests:
                if r._complete(error=e):
                    stat_add("serving_failed")
            return
        bad = [tuple(o.shape) for o in outs
               if not o.shape or o.shape[0] != bucket_rows]
        if bad:
            # a fetch that is not batch-major cannot be sliced back into
            # per-request rows — fail LOUDLY instead of returning
            # other requests' data
            err = ServingError(
                f"fetch output shapes {bad} do not lead with the batch "
                f"dim ({bucket_rows} rows): this model's fetches cannot "
                f"be micro-batched")
            for r in requests:
                if r._complete(error=err):
                    stat_add("serving_failed")
            return
        now = time.monotonic()
        offset = 0
        with otrace.span("serving/reply", requests=len(requests)):
            for r in requests:
                # copy: a view would pin the whole bucket-padded batch
                # (and other requests' rows) for as long as the client
                # holds it
                sliced = [o[offset:offset + r.nrows].copy() for o in outs]
                offset += r.nrows
                if r._complete(result=sliced):
                    stat_add("serving_completed")
                    stat_add("serving_latency_us_total",
                             int((now - r.t_enqueue) * 1e6))
                    # tail latency is THE serving metric: p50/p95/p99
                    # ride /stats, /metrics, and export_stats()
                    stat_time("serving_latency_seconds", now - r.t_enqueue)
        stat_add("serving_batches")
        stat_add("serving_batched_requests", len(requests))
        stat_add("serving_batched_rows", total)
        stat_add("serving_padded_rows", bucket_rows - total)
        stat_max("serving_max_batch_occupancy", len(requests))
