"""Per-request distributed tracing for the serving stack (Dapper role).

The aggregate telemetry the serving stack already ships (``ttft_seconds``
histograms, ``decode_*`` counters) can say p99 regressed; it cannot say
WHICH request blew its deadline or WHY — queued behind a six-chunk
long-prompt adversary?  a copy-on-write storm?  every speculative round
rejected?  This module is the per-request half: every
``DecodeRequest``/batcher request gets a **trace id** minted at submit
and a structured timeline of lifecycle events with attributes —
enqueue, admission (pages claimed, prefix pages hit, CoW spare held),
each prefill chunk, each decode step that advanced it, CoW copies,
speculative propose/verify rounds with accept counts, token emissions,
and the terminal outcome (completed(eos/budget) / deadline / abandoned /
rejected / cancelled / error, with reason).

Retention (the Dapper/production compromise):

- **Recording is always on and cheap** (one monotonic read + a tuple
  append per event, no device work, no numerics impact): the in-flight
  timeline must exist for EVERY request, because whether a request is
  interesting is only known at its end.
- **Head sampling** (``FLAGS_request_trace_sample`` in [0, 1], exact
  deterministic rate) decides which *normal* completions are kept in
  the bounded finished-trace ring.
- **Tail retention**: a request that violates an SLO objective
  (``observe/slo.py``) or ends abnormally (deadline / abandoned /
  rejected / error / cancelled) is ALWAYS kept, even at sample = 0 —
  the traces you need at 3am are exactly the ones head sampling would
  have dropped.

PyTorch port: a copy of ``paddle_tpu/observe/request_trace.py`` (no
JAX in it) without the Chrome trace-event export, which waits for the
port of ``observe/timeline.py``.  ``DecodeEngine.debug_requests`` and
``TraceStore.get(id).to_dict()`` read the timelines.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Sequence

from ..framework import flags as _flags
from ..monitor import stat_add, stat_set

__all__ = ["RequestTrace", "TraceStore", "get_trace_store",
           "ABNORMAL_OUTCOMES", "MAX_EVENTS_PER_TRACE"]

# per-trace event cap: a max_new_tokens=64 request emits ~70 events;
# the cap only bites pathological requests, and the drop is counted
MAX_EVENTS_PER_TRACE = 1024

# outcomes that bypass head sampling (tail retention)
ABNORMAL_OUTCOMES = frozenset(
    ("deadline", "abandoned", "rejected", "cancelled", "error"))


class RequestTrace:
    """One request's timeline: bounded event list + terminal verdict.

    Events are ``(t_rel_seconds, name, attrs)`` relative to the mint
    time; ``event()`` is the hot path and must stay allocation-light
    (the engine calls it once per emitted token)."""

    __slots__ = ("trace_id", "kind", "replica", "sampled", "attrs",
                 "events", "t_start", "t_unix", "outcome", "reason",
                 "violations", "summary", "dropped_events", "_done")

    def __init__(self, trace_id: str, kind: str, replica: str,
                 sampled: bool, attrs: Optional[dict] = None):
        self.trace_id = trace_id
        self.kind = kind
        self.replica = replica
        self.sampled = sampled
        self.attrs = dict(attrs or {})
        self.events: List[tuple] = []
        self.t_start = time.monotonic()
        self.t_unix = time.time()
        self.outcome: Optional[str] = None
        self.reason: Optional[str] = None
        self.violations: tuple = ()
        self.summary: dict = {}
        self.dropped_events = 0
        self._done = False

    # -- recording (engine/client hot path) ------------------------------
    def event(self, name: str, **attrs) -> None:
        # post-terminal events are accepted on purpose: a client-side
        # deadline reap finishes the trace while the engine's in-flight
        # step still lands (those trailing tokens ARE the diagnosis),
        # and page registration happens at slot release
        if len(self.events) >= MAX_EVENTS_PER_TRACE:
            self.dropped_events += 1
            return
        self.events.append((time.monotonic() - self.t_start, name,
                            attrs or None))

    def finish(self, outcome: str, reason: Optional[str],
               violations: Sequence[str], summary: dict) -> bool:
        """First finish wins (the engine reap and a client-side
        deadline self-reap can race through ``RequestBase._complete``)."""
        if self._done:
            return False
        self._done = True
        self.outcome = str(outcome)
        self.reason = reason if reason is None else str(reason)
        self.violations = tuple(violations)
        self.summary = dict(summary)
        self.events.append((time.monotonic() - self.t_start, "finish",
                            {"outcome": self.outcome,
                             **({"reason": self.reason}
                                if self.reason else {}),
                             **({"violations": list(self.violations)}
                                if self.violations else {})}))
        return True

    @property
    def done(self) -> bool:
        return self._done

    @property
    def duration_s(self) -> float:
        if self.events:
            return self.events[-1][0]
        return time.monotonic() - self.t_start

    # -- reading ---------------------------------------------------------
    def to_dict(self, events: bool = True) -> dict:
        d = {
            "trace_id": self.trace_id,
            "kind": self.kind,
            "replica": self.replica,
            "sampled": self.sampled,
            "t_unix": round(self.t_unix, 6),
            "attrs": dict(self.attrs),
            "outcome": self.outcome,
            "reason": self.reason,
            "violations": list(self.violations),
            "summary": dict(self.summary),
            "duration_ms": round(self.duration_s * 1e3, 3),
            "n_events": len(self.events),
            "dropped_events": self.dropped_events,
        }
        if events:
            d["events"] = [
                {"t_ms": round(t * 1e3, 3), "name": name,
                 **(attrs or {})}
                for t, name, attrs in list(self.events)]
        return d


class TraceStore:
    """In-flight map + bounded finished-trace ring with head-sampling
    and tail retention.  The module singleton is what the serving stack
    feeds; tests may build their own with a small capacity."""

    def __init__(self, capacity: Optional[int] = None):
        # an explicit capacity is authoritative; only a flag-derived
        # one tracks FLAGS_request_trace_ring live (resized at
        # retention time — the singleton is built at import, before an
        # operator can set the flag)
        self._cap_from_flag = capacity is None
        if capacity is None:
            try:
                capacity = int(_flags.flag("request_trace_ring"))
            except KeyError:  # pragma: no cover - partial installs
                capacity = 512
        self._ring: collections.deque = collections.deque(
            maxlen=max(int(capacity), 1))
        self._inflight: Dict[str, RequestTrace] = {}
        self._lock = threading.Lock()
        self._seq = 0
        self._sample_acc = 0.0

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    # -- lifecycle --------------------------------------------------------
    def start(self, kind: str, replica: str = "", **attrs) -> RequestTrace:
        """Mint a trace id and begin an in-flight timeline.  Sampling is
        deterministic-exact-rate (an accumulator, not a coin flip), so a
        10% sample of 100 requests keeps exactly 10 normal ones."""
        try:
            sample = float(_flags.flag("request_trace_sample"))
        except KeyError:  # pragma: no cover - partial installs
            sample = 1.0
        sample = min(max(sample, 0.0), 1.0)
        with self._lock:
            self._seq += 1
            self._sample_acc += sample
            sampled = self._sample_acc >= 1.0 - 1e-12
            if sampled:
                self._sample_acc -= 1.0
            tr = RequestTrace(f"{kind}-{self._seq:06d}", kind, replica,
                              sampled, attrs)
            self._inflight[tr.trace_id] = tr
        stat_add("request_traces_started")
        stat_set("request_traces_inflight", len(self._inflight))
        return tr

    def finish(self, trace: RequestTrace, outcome: str,
               reason: Optional[str] = None,
               violations: Sequence[str] = (), **summary) -> bool:
        """Terminal: first caller wins; the trace is retained in the
        ring when head-sampled in, OR on any SLO violation, OR on an
        abnormal outcome (tail retention)."""
        if not trace.finish(outcome, reason, violations, summary):
            return False
        keep = (trace.sampled or bool(violations)
                or outcome in ABNORMAL_OUTCOMES)
        cap = self._ring.maxlen
        if self._cap_from_flag:
            try:
                cap = max(int(_flags.flag("request_trace_ring")), 1)
            except KeyError:  # pragma: no cover - partial installs
                pass
        with self._lock:
            self._inflight.pop(trace.trace_id, None)
            if cap != self._ring.maxlen:
                # the flag is live: resize at retention time (deque
                # maxlen is immutable, so rebuild — rare)
                self._ring = collections.deque(self._ring, maxlen=cap)
            if keep:
                self._ring.append(trace)
            n_inflight = len(self._inflight)
        stat_add("request_traces_retained" if keep
                 else "request_traces_sampled_out")
        stat_set("request_traces_inflight", n_inflight)
        return True

    def drop(self, trace: RequestTrace) -> None:
        """Forget an in-flight trace without retaining it (tests)."""
        with self._lock:
            self._inflight.pop(trace.trace_id, None)

    # -- reading ----------------------------------------------------------
    def get(self, trace_id: str) -> Optional[RequestTrace]:
        with self._lock:
            tr = self._inflight.get(trace_id)
            if tr is not None:
                return tr
            for tr in reversed(self._ring):
                if tr.trace_id == trace_id:
                    return tr
        return None

    def inflight(self) -> List[RequestTrace]:
        with self._lock:
            return list(self._inflight.values())

    def retained(self, n: Optional[int] = None) -> List[RequestTrace]:
        with self._lock:
            out = list(self._ring)
        return out if n is None else out[-int(n):]

    def violators(self, n: Optional[int] = None) -> List[RequestTrace]:
        """Retained traces that violated an SLO or died abnormally."""
        out = [t for t in self.retained()
               if t.violations or t.outcome in ABNORMAL_OUTCOMES]
        return out if n is None else out[-int(n):]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._inflight.clear()
            self._sample_acc = 0.0


_STORE = TraceStore()


def get_trace_store() -> TraceStore:
    return _STORE
