"""Stall watchdog, postmortem bundles, and cluster-wide health telemetry.

Counterpart of ``paddle_tpu/observe/health.py``.  Three pieces, one
purpose: make a device-level failure *diagnosable after the fact* (at
production scale preemption and device loss are the steady state, and
a hung ``synchronize`` is not a diagnosis).

- **Stall watchdog** (:class:`StallWatchdog`): a daemon thread that
  samples executor progress — steps dispatched vs drained and the age
  of the oldest in-flight window entry — and, on no-progress past
  ``FLAGS_stall_timeout_s``, dumps a postmortem bundle.  It re-arms
  only after progress resumes, so one stall produces one bundle.
- **Postmortem bundle** (:func:`dump_postmortem`): a directory with
  all-thread Python stacks (``faulthandler`` + ``sys._current_frames``
  with thread names), the tracer ring as a Chrome trace, a Prometheus
  metrics snapshot, the flight-recorder tail, the FLAGS snapshot, the
  caching allocator's counters, and a ``meta.json`` (reason, progress,
  exception).  Also installable as
  a crash hook (:func:`install_crash_handler`): an uncaught exception
  dumps the same bundle, and ``faulthandler`` is armed for fatal
  signals so even a segfaulting process leaves its stacks.
- **Cluster health** (:class:`HealthReporter` +
  :func:`serve_cluster_health`): each rank publishes periodic
  heartbeat+metrics snapshots to the fleet KV HTTP server; rank 0
  serves an aggregated ``/metrics/cluster`` route with per-rank
  last-heartbeat age, step-time skew (the straggler gauge), and
  rank-liveness counters — the signal plane an elastic supervisor acts
  on.  The port runs one process: its cluster is world size 1 against
  a local ``KVServer``.

Locking discipline: everything the watchdog samples is read WITHOUT
taking executor/window locks — the stalled thread may be blocked *while
holding* the window lock, and a watchdog that deadlocks on the very
hang it is meant to report is worse than none.  ``len(deque)`` and
``deque[0]`` are GIL-atomic; a rare torn read costs one poll interval.
Nothing it samples waits on the card either: an in-flight step's
readiness is its CUDA event's ``query()``, and memory figures are the
caching allocator's host-side counters (``torch.cuda.memory_stats``,
never ``mem_get_info``).
"""
from __future__ import annotations

import faulthandler
import json
import os
import re
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

from ..framework import flags as _flags
from . import flight as _flight

__all__ = ["StallWatchdog", "HealthReporter", "executor_progress",
           "dump_postmortem", "start_watchdog", "stop_watchdog",
           "get_watchdog", "maybe_start_watchdog", "install_crash_handler",
           "uninstall_crash_handler", "cluster_health",
           "serve_cluster_health", "HEALTH_KEY_PREFIX"]

HEALTH_KEY_PREFIX = "health/rank/"

_BUNDLE_FILES = ("meta.json", "stacks.txt", "trace.json", "metrics.prom",
                 "flight.jsonl", "flags.json", "memory.json",
                 "phases.json")


# ---------------------------------------------------------------------------
# executor progress sampling
# ---------------------------------------------------------------------------


def executor_progress() -> Dict:
    """One sample of process-wide executor progress: cumulative steps
    dispatched/drained (monitor counters fed by framework/executor.py),
    total in-flight window entries, the age in seconds of the OLDEST
    undrained entry (None when nothing is in flight), whether EVERY
    live window's next-to-drain entry is already device-complete
    (``oldest_ready`` via the non-blocking ``torch.cuda.Event.query``
    of the step's event; a step without one ran on the CPU and was
    complete when dispatch returned — completed-but-unread work is an
    idle host, not a hung device; judged per window so one idle
    executor cannot mask another's hang), and whether a key's warm-up
    or capture is in flight (``compiling`` + ``compile_age_s``).  Lock-free
    by design — see the module docstring."""
    from ..monitor import stat_get

    out = {
        "dispatched": stat_get("executor_steps_dispatched"),
        "drained": stat_get("executor_steps_drained"),
        "inflight": 0,
        "oldest_inflight_age_s": None,
        "oldest_ready": None,
        "compiling": False,
    }
    try:
        from ..framework.executor import _ACTIVE_COMPILES, _LIVE_EXECUTORS

        now = time.perf_counter()
        ages = []
        ready_flags = []
        inflight = 0
        for exe in list(_LIVE_EXECUTORS):
            entries = exe._window._entries  # no lock: GIL-atomic reads
            n = len(entries)
            inflight += n
            if not n:
                continue
            try:
                e = entries[0]
                age = now - e.t_dispatch
            except IndexError:  # drained between len() and [0]
                continue
            ages.append(age)
            # readiness of the NEXT-TO-DRAIN entry of THIS window
            # (drains are FIFO per window; aggregating across windows
            # must be per-window, or one idle-but-complete executor
            # would mask another executor's genuine hang)
            try:
                ready = True if e.event is None else bool(e.event.query())
            except Exception:  # noqa: BLE001 - a dead context etc.
                ready = None
            ready_flags.append(ready)
        out["inflight"] = inflight
        if ages:
            out["oldest_inflight_age_s"] = round(max(ages), 3)
        if ready_flags:
            # True only when EVERY window's next drain is verifiably
            # device-complete; an unknown probe counts as not-ready (a
            # mocked/hung buffer without is_ready must read as a hang)
            out["oldest_ready"] = all(f is True for f in ready_flags)
        compiles = list(_ACTIVE_COMPILES.values())
        out["compiling"] = bool(compiles)
        if compiles:
            out["compile_age_s"] = round(now - min(compiles), 3)
    except ImportError:  # pragma: no cover - partial installs
        pass
    return out


# ---------------------------------------------------------------------------
# postmortem bundle
# ---------------------------------------------------------------------------


def _format_all_stacks() -> str:
    """All-thread stacks with THREAD NAMES (faulthandler prints only
    ids; the names — 'ckpt-writer', 'serving-batcher', 'MainThread' —
    are what make a hang readable)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    lines: List[str] = []
    for tid, frame in sorted(sys._current_frames().items()):
        lines.append(f"--- thread {tid} ({names.get(tid, '?')}) ---")
        lines.extend(
            ln.rstrip() for ln in traceback.format_stack(frame))
        lines.append("")
    return "\n".join(lines)


def dump_postmortem(reason: str, directory: Optional[str] = None,
                    exc: Optional[tuple] = None,
                    extra: Optional[dict] = None) -> str:
    """Write a postmortem bundle and return its directory path.

    Bundle layout (every section best-effort — one broken exporter
    must not lose the rest; failures are recorded in ``meta.json``):

    - ``meta.json``    reason, timestamps, pid/rank, executor progress,
      exception (when given), per-section errors
    - ``stacks.txt``   all-thread Python stacks (named + faulthandler)
    - ``trace.json``   tracer ring as Chrome trace-event JSON
    - ``metrics.prom`` Prometheus text exposition snapshot
    - ``flight.jsonl`` flight-recorder tail
    - ``flags.json``   FLAGS snapshot
    - ``memory.json``  compile records (footprint breakdown, the
      pre-launch estimate, per-var attribution, budget verdicts) and
      the caching allocator's live counters (observe/xla_stats.py)
    - ``requests.json`` per-request serving traces: retained SLO
      violators + abnormal endings (full timelines), the live
      in-flight table, and the SLO verdict snapshot (burn rates,
      budget remaining, goodput) — observe/request_trace.py +
      observe/slo.py; pretty-print with ``python -m tools.reqtrace``
    - ``phases.json`` step-phase attribution snapshot
      (observe/phases.py): measured compute / exposed-comm / host /
      input-wait split, the predicted cost-model fractions, and the
      per-collective exposed-vs-hidden ledger
    """
    directory = directory or _flags.flag("postmortem_dir") or "postmortem"
    safe = re.sub(r"[^A-Za-z0-9_.-]", "_", str(reason))[:48] or "unknown"
    stamp = time.strftime("%Y%m%d_%H%M%S")
    path = os.path.join(str(directory),
                        f"bundle_{stamp}_{os.getpid()}_{safe}")
    # a second dump in the same second (watchdog + crash hook racing)
    # must not interleave into one directory
    base, i = path, 1
    while os.path.exists(path):
        path = f"{base}.{i}"
        i += 1
    os.makedirs(path, exist_ok=True)

    errors: Dict[str, str] = {}

    def section(name: str, fn: Callable[[str], None]) -> None:
        try:
            fn(os.path.join(path, name))
        except Exception as e:  # noqa: BLE001 - keep dumping
            errors[name] = f"{type(e).__name__}: {e}"

    def _stacks(p):
        with open(p, "w") as f:
            f.write(_format_all_stacks())
            f.write("\n=== faulthandler ===\n")
            f.flush()
            faulthandler.dump_traceback(file=f, all_threads=True)

    def _trace(p):
        from .timeline import export_chrome_trace

        export_chrome_trace(p)

    def _metrics(p):
        from .histogram import prometheus_text

        with open(p, "w") as f:
            f.write(prometheus_text())

    def _flight_tail(p):
        _flight.get_flight_recorder().dump(p)

    def _flags_json(p):
        with open(p, "w") as f:
            json.dump(_flags.flags_snapshot(), f, indent=2, sort_keys=True,
                      default=repr)

    def _memory_json(p):
        from . import xla_stats

        # the allocator's counters are host reads: safe to probe even
        # while the card is wedged
        with open(p, "w") as f:
            json.dump(xla_stats.memory_report(probe_devices=True), f,
                      indent=2, default=repr)

    def _requests_json(p):
        from . import request_trace as _rt
        from . import slo as _slo

        store = _rt.get_trace_store()
        doc = {
            "slo": _slo.snapshot(),
            "violators": [t.to_dict() for t in store.violators(50)],
            "retained": [t.to_dict(events=False)
                         for t in store.retained(100)],
            "inflight": [t.to_dict(events=False)
                         for t in store.inflight()],
        }
        with open(p, "w") as f:
            json.dump(doc, f, indent=2, default=repr)

    def _phases_json(p):
        from . import phases as _phases

        with open(p, "w") as f:
            json.dump(_phases.phases_report(), f, indent=2, default=repr)

    section("stacks.txt", _stacks)
    section("trace.json", _trace)
    section("metrics.prom", _metrics)
    section("flight.jsonl", _flight_tail)
    section("flags.json", _flags_json)
    section("memory.json", _memory_json)
    section("requests.json", _requests_json)
    section("phases.json", _phases_json)

    meta = {
        "reason": str(reason),
        "ts": time.time(),
        "time": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "pid": os.getpid(),
        "progress": executor_progress(),
        "section_errors": errors,
    }
    meta["rank"], meta["world_size"] = _flight._rank_world()
    if exc is not None:
        tp, val, tb = (exc + (None, None, None))[:3]
        meta["exception"] = {
            "type": getattr(tp, "__name__", str(tp)),
            "value": str(val),
            "traceback": "".join(
                traceback.format_exception(tp, val, tb))[-8000:],
        }
    if extra:
        meta["extra"] = _flight._jsonable(extra)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2, default=repr)

    from ..monitor import stat_add

    stat_add("postmortem_bundles")
    _flight.record("postmortem/dump", reason=str(reason), path=path)
    return path


# ---------------------------------------------------------------------------
# stall watchdog
# ---------------------------------------------------------------------------


class StallWatchdog:
    """Daemon thread: trips when work is pending but nothing drains.

    Stall definition: ``dispatched > drained`` (or any window entry in
    flight) AND neither counter has moved for ``timeout_s`` —
    equivalently, the oldest in-flight entry is older than the timeout.
    Three things are explicitly NOT stalls:

    - an *idle* process (nothing pending) never trips;
    - a *failing* process (drains raising) never trips, because a
      failed drain still advances the drained counter — a raise is
      progress, a hang is not;
    - an in-flight entry whose buffers are already device-complete
      (``oldest_ready``) never trips — the device finished, the host
      just hasn't read it yet (e.g. an interactive session between
      steps);
    - while a key's warm-up or capture is in flight the timeout is
      scaled by ``compile_grace`` (default 10x): a long first run is
      legitimate, but one hung 10x past the stall timeout is itself the
      failure.

    On a stall: dump a postmortem bundle, record a flight event, bump
    ``watchdog_stalls`` on ``/metrics``, call ``on_stall(bundle_path)``
    if given, and latch until progress resumes (one bundle per stall,
    not one per poll)."""

    def __init__(self, timeout_s: Optional[float] = None,
                 poll_s: Optional[float] = None,
                 directory: Optional[str] = None,
                 progress_fn: Optional[Callable[[], Dict]] = None,
                 on_stall: Optional[Callable[[str], None]] = None,
                 compile_grace: float = 10.0):
        t = timeout_s if timeout_s is not None \
            else float(_flags.flag("stall_timeout_s"))
        if t <= 0:
            raise ValueError(
                "StallWatchdog needs timeout_s > 0 (set it or "
                "FLAGS_stall_timeout_s)")
        self.timeout_s = float(t)
        self.poll_s = float(poll_s) if poll_s is not None \
            else max(min(self.timeout_s / 4.0, 10.0), 0.05)
        self.directory = directory
        self.compile_grace = max(float(compile_grace), 1.0)
        self._progress_fn = progress_fn or executor_progress
        self._on_stall = on_stall
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.bundles: List[str] = []
        self.stalls = 0
        self._tripped = False

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "StallWatchdog":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="stall-watchdog", daemon=True)
        self._thread.start()
        _flight.record("health/watchdog_start", timeout_s=self.timeout_s,
                       poll_s=self.poll_s)
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    # -- the loop --------------------------------------------------------
    def _loop(self) -> None:
        last_sig = None
        last_progress = time.perf_counter()
        while not self._stop.wait(self.poll_s):
            try:
                p = self._progress_fn()
            except Exception:  # noqa: BLE001 - keep watching
                continue
            now = time.perf_counter()
            pending = (p.get("inflight", 0) or 0) > 0 or \
                p.get("dispatched", 0) > p.get("drained", 0)
            if p.get("oldest_ready") is True:
                # the next-to-drain step is device-complete: the host
                # simply hasn't read it — idle, not hung (drains are
                # FIFO, so the oldest entry gates everything)
                pending = False
            sig = (p.get("drained", 0), p.get("dispatched", 0))
            if sig != last_sig or not pending:
                last_sig = sig
                last_progress = now
                self._tripped = False  # progress resumed: re-arm
                continue
            grace = self.compile_grace if p.get("compiling") else 1.0
            eff = self.timeout_s * grace
            age = p.get("oldest_inflight_age_s")
            stalled = (now - last_progress) >= eff or \
                (age is not None and age >= eff)
            if stalled and not self._tripped:
                self._tripped = True
                self.stalls += 1
                self._handle_stall(p)

    def _handle_stall(self, progress: Dict) -> None:
        from ..monitor import stat_add

        stat_add("watchdog_stalls")
        _flight.record("health/stall", **progress,
                       timeout_s=self.timeout_s)
        try:
            bundle = dump_postmortem(
                "stall", directory=self.directory,
                extra={"progress": progress,
                       "stall_timeout_s": self.timeout_s})
        except Exception:  # noqa: BLE001 - the dump must not kill the dog
            return
        self.bundles.append(bundle)
        if self._on_stall is not None:
            try:
                self._on_stall(bundle)
            except Exception:  # noqa: BLE001
                pass


_WATCHDOG: Optional[StallWatchdog] = None
_WATCHDOG_LOCK = threading.Lock()


def get_watchdog() -> Optional[StallWatchdog]:
    return _WATCHDOG


def start_watchdog(**kwargs) -> StallWatchdog:
    """Start (or return) the process-wide watchdog singleton."""
    global _WATCHDOG
    with _WATCHDOG_LOCK:
        if _WATCHDOG is not None and _WATCHDOG.running:
            return _WATCHDOG
        _WATCHDOG = StallWatchdog(**kwargs)
        return _WATCHDOG.start()


def stop_watchdog() -> None:
    global _WATCHDOG
    with _WATCHDOG_LOCK:
        wd, _WATCHDOG = _WATCHDOG, None
    if wd is not None:
        wd.stop()


def maybe_start_watchdog() -> Optional[StallWatchdog]:
    """Auto-start hook (Executor construction): a watchdog when
    ``FLAGS_stall_timeout_s`` > 0, else nothing."""
    try:
        if float(_flags.flag("stall_timeout_s")) <= 0:
            return None
    except KeyError:  # pragma: no cover
        return None
    return start_watchdog()


# ---------------------------------------------------------------------------
# crash / atexit hook
# ---------------------------------------------------------------------------

_CRASH_STATE: Dict = {"installed": False, "prev_hook": None,
                      "fh_file": None, "dir": None, "atexit_dump": False,
                      "dumped_at_exit": False}


def install_crash_handler(directory: Optional[str] = None,
                          dump_at_exit: bool = False) -> None:
    """Arm the process so a death leaves a bundle:

    - ``sys.excepthook`` wrapper: an uncaught exception dumps a
      ``crash`` bundle (then chains to the previous hook).
    - ``faulthandler`` on fatal signals (SIGSEGV/SIGABRT/...) writing
      all-thread stacks to ``<dir>/fatal_<pid>.log`` — a hard crash
      can't run Python, but the pre-registered dump still fires.
    - with ``dump_at_exit=True``, an atexit hook dumps a final
      ``exit`` bundle unconditionally (supervisor mode: always leave
      last-known state).

    Idempotent; :func:`uninstall_crash_handler` undoes it (tests)."""
    if _CRASH_STATE["installed"]:
        return
    directory = directory or _flags.flag("postmortem_dir") or "postmortem"
    _CRASH_STATE["dir"] = directory
    _CRASH_STATE["atexit_dump"] = bool(dump_at_exit)
    prev = sys.excepthook

    def hook(tp, val, tb):
        try:
            dump_postmortem("crash", directory=_CRASH_STATE["dir"],
                            exc=(tp, val, tb))
        except Exception:  # noqa: BLE001 - never mask the real error
            pass
        prev(tp, val, tb)

    sys.excepthook = hook
    _CRASH_STATE["prev_hook"] = prev
    try:
        os.makedirs(directory, exist_ok=True)
        f = open(os.path.join(directory, f"fatal_{os.getpid()}.log"), "w")
        faulthandler.enable(file=f, all_threads=True)
        _CRASH_STATE["fh_file"] = f
    except OSError:
        _CRASH_STATE["fh_file"] = None
    _CRASH_STATE["installed"] = True
    _flight.record("health/crash_handler_installed", dir=str(directory))


def uninstall_crash_handler() -> None:
    if not _CRASH_STATE["installed"]:
        return
    if _CRASH_STATE["prev_hook"] is not None:
        sys.excepthook = _CRASH_STATE["prev_hook"]
    if _CRASH_STATE["fh_file"] is not None:
        try:
            faulthandler.disable()
            _CRASH_STATE["fh_file"].close()
        except (OSError, ValueError):
            pass
    _CRASH_STATE.update(installed=False, prev_hook=None, fh_file=None,
                        dir=None, atexit_dump=False)


def _atexit_bundle():  # pragma: no cover - interpreter teardown
    if _CRASH_STATE["installed"] and _CRASH_STATE["atexit_dump"] \
            and not _CRASH_STATE["dumped_at_exit"]:
        _CRASH_STATE["dumped_at_exit"] = True
        try:
            dump_postmortem("exit", directory=_CRASH_STATE["dir"])
        except Exception:  # noqa: BLE001
            pass


import atexit  # noqa: E402

atexit.register(_atexit_bundle)


# ---------------------------------------------------------------------------
# cluster health: per-rank heartbeats over the fleet KV server
# ---------------------------------------------------------------------------


# default cross-scrape rank-epoch book for bare cluster_health() calls
# (serve_cluster_health keeps a per-route book instead)
_CLUSTER_BOOK: Dict[int, Dict] = {}


def _default_rank_stats() -> Dict:
    """What a rank puts in its heartbeat: progress counters + the raw
    step-time p50.  Reads the histogram DIRECTLY (not
    ``StepTimer.summary()``, which quiesces every executor — a
    heartbeat thread must never force drains under the training
    loop)."""
    from .histogram import histogram
    from .step_stats import STEP_TIME_HISTOGRAM

    out = executor_progress()
    h = histogram(STEP_TIME_HISTOGRAM)
    if h.count:
        out["step_time_p50_s"] = round(h.percentile(50), 6)
        out["steps_timed"] = h.count
    try:
        # per-rank comm-exposure share (observe/phases.py): reads the
        # engine's own ledger under its own lock — no drains forced —
        # and gives the cluster straggler gauge a CAUSE column
        from . import phases as _phases

        eng = _phases.phase_engine()
        if eng.steps:
            out["comm_exposed_share"] = round(eng.comm_exposed_share(), 6)
    except Exception:  # noqa: BLE001 - heartbeat must never die here
        pass
    try:
        # live per-card memory sample (observe/xla_stats.py): sets the
        # hbm_free/used/limit gauges on /metrics and rides the heartbeat
        # onto /metrics/cluster; {} on the CPU — the heartbeat itself
        # must never die on a probe
        from . import xla_stats

        out.update(xla_stats.record_device_memory())
    except Exception:  # noqa: BLE001
        pass
    return out


class HealthReporter:
    """Publishes this rank's heartbeat to the fleet KV HTTP server.

    Each beat PUTs one JSON document to ``health/rank/<rank>`` —
    ``{"rank", "ts", "pid", "interval_s", ...stats}`` — overwriting the
    previous one (the KV holds only latest-state; history belongs to
    the flight recorder).  Publish failures are counted
    (``health_heartbeat_failures``) and retried on the next beat: a
    down aggregator must never stall a training rank."""

    def __init__(self, endpoint: str, rank: int,
                 world_size: Optional[int] = None,
                 interval_s: Optional[float] = None,
                 stats_fn: Optional[Callable[[], Dict]] = None,
                 timeout_s: float = 5.0):
        self.endpoint = endpoint.rstrip("/")
        if not self.endpoint.startswith("http"):
            self.endpoint = "http://" + self.endpoint
        self.rank = int(rank)
        self.world_size = world_size
        self.interval_s = float(interval_s) if interval_s is not None \
            else float(_flags.flag("heartbeat_interval_s"))
        self.timeout_s = float(timeout_s)
        self._stats_fn = stats_fn or _default_rank_stats
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.beats = 0
        self.failures = 0

    # -- one beat --------------------------------------------------------
    def payload(self) -> Dict:
        p = {"rank": self.rank, "ts": time.time(), "pid": os.getpid(),
             "interval_s": self.interval_s}
        if self.world_size is not None:
            p["world_size"] = int(self.world_size)
        try:
            p.update(_flight._jsonable(self._stats_fn() or {}))
        except Exception as e:  # noqa: BLE001 - beat anyway
            p["stats_error"] = f"{type(e).__name__}: {e}"
        return p

    def publish_once(self) -> bool:
        """PUT one heartbeat; returns success.  Never raises."""
        import urllib.request

        # chaos hook (fleet.elastic.chaos "heartbeat_blackhole"): drop
        # this rank's beats so the health plane dead-lists a live
        # process — consulted ONLY when the chaos module is already
        # loaded (an unimported armory holds no armed faults)
        _chaos = sys.modules.get(
            "paddle_tpu_torch.distributed.fleet.elastic.chaos")
        if _chaos is not None and \
                _chaos.take("heartbeat_blackhole", rank=self.rank):
            self.failures += 1
            from ..monitor import stat_add

            stat_add("health_heartbeat_blackholed")
            return False
        try:
            body = json.dumps(self.payload()).encode()
            url = f"{self.endpoint}/{HEALTH_KEY_PREFIX}{self.rank}"
            req = urllib.request.Request(url, data=body, method="PUT")
            with urllib.request.urlopen(req, timeout=self.timeout_s):
                pass
        except Exception:  # noqa: BLE001 - URLError, BadStatusLine, a
            # garbage non-HTTP responder, ...: ANY failure is one missed
            # beat, retried next interval — a surprising exception type
            # must not kill the daemon thread and falsely dead-list the
            # rank
            self.failures += 1
            from ..monitor import stat_add

            stat_add("health_heartbeat_failures")
            return False
        self.beats += 1
        return True

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "HealthReporter":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name=f"health-reporter-r{self.rank}",
            daemon=True)
        self._thread.start()
        _flight.record("health/reporter_start", rank=self.rank,
                       endpoint=self.endpoint,
                       interval_s=self.interval_s)
        return self

    def _loop(self) -> None:
        self.publish_once()  # first beat immediately, not one interval in
        while not self._stop.wait(self.interval_s):
            self.publish_once()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def cluster_health(kv: Dict, world_size: Optional[int] = None,
                   now: Optional[float] = None,
                   book: Optional[Dict] = None) -> Dict:
    """Aggregate raw KV heartbeat entries into the cluster-health view
    (pure function: testable without HTTP).

    ``kv`` maps key -> bytes/str as stored by the KV server.  A rank is
    *alive* when its last heartbeat is younger than 3x its own reported
    interval — recomputed per scrape, so a dead-listed rank that
    RESUMES heartbeating re-enters ``alive_ranks`` and leaves
    ``dead_ranks`` on the very next aggregation.  The straggler gauge
    is relative step-time skew among alive ranks: ``(max_p50 - min_p50)
    / min_p50`` — 0.0 when balanced, 1.0 when the slowest rank takes
    twice the fastest's step time.  Liveness/skew are mirrored to
    StatRegistry gauges so the plain ``/metrics`` exposition carries
    them too.

    ``book`` is the cross-scrape bookkeeping dict (``serve_cluster_
    health`` keeps one per route; ``None`` uses a module-global): it
    carries each rank's MONOTONIC restart epoch.  A rank whose pid
    changed or whose cumulative ``dispatched`` counter went BACKWARDS
    has restarted — its epoch bumps, the entry is flagged
    ``restarted`` for this scrape, and it is excluded from the
    straggler-skew computation until its counters move forward again
    (a fresh process's reset step-time histogram is not a straggler
    going backwards; the elastic supervisor reads ``rank_epochs`` to
    tell a restarted rank from a stuck one)."""
    now = time.time() if now is None else now
    book = _CLUSTER_BOOK if book is None else book
    ranks: Dict[int, Dict] = {}
    for key, raw in kv.items():
        m = re.fullmatch(re.escape(HEALTH_KEY_PREFIX) + r"(\d+)", key)
        if not m:
            continue
        try:
            payload = json.loads(
                raw.decode() if isinstance(raw, (bytes, bytearray)) else raw)
        except (ValueError, UnicodeDecodeError):
            continue
        r = int(m.group(1))
        age = max(now - float(payload.get("ts", 0.0)), 0.0)
        interval = float(payload.get("interval_s", 0.0)) or \
            float(_flags.flag("heartbeat_interval_s"))
        entry = dict(payload)
        entry["last_heartbeat_age_s"] = round(age, 3)
        entry["alive"] = age < 3.0 * interval
        # monotonic rank-epoch bookkeeping (see docstring)
        pid = payload.get("pid")
        disp = payload.get("dispatched")
        rec = book.get(r)
        if rec is None:
            book[r] = rec = {"epoch": 0, "pid": pid, "dispatched": disp}
        else:
            new_pid = (pid is not None and rec.get("pid") is not None
                       and pid != rec["pid"])
            went_back = (isinstance(disp, (int, float))
                         and isinstance(rec.get("dispatched"),
                                        (int, float))
                         and disp < rec["dispatched"])
            if new_pid or went_back:
                rec["epoch"] += 1
                # sticky until the fresh process's counters move
                # FORWARD — a restarted rank that has not dispatched
                # a step yet must stay out of the skew gauge on every
                # scrape in between, not only the detection scrape
                rec["cooling"] = True
                from ..monitor import stat_add

                stat_add("cluster_rank_restarts")
            elif rec.get("cooling") and isinstance(disp, (int, float)) \
                    and isinstance(rec.get("dispatched"), (int, float)) \
                    and disp > rec["dispatched"]:
                rec.pop("cooling", None)
            if rec.get("cooling"):
                entry["restarted"] = True
            if pid is not None:
                rec["pid"] = pid
            if disp is not None:
                rec["dispatched"] = disp
        entry["epoch"] = rec["epoch"]
        ranks[r] = entry
        if world_size is None and "world_size" in payload:
            world_size = int(payload["world_size"])
    world = int(world_size) if world_size else \
        (max(ranks) + 1 if ranks else 0)

    alive = sorted(r for r, e in ranks.items() if e["alive"])
    dead = sorted(set(range(world)) - set(alive))
    out: Dict = {
        "ts": now,
        "world_size": world,
        "ranks": {str(r): ranks[r] for r in sorted(ranks)},
        "alive_ranks": len(alive),
        "dead_ranks": dead,
        "max_heartbeat_age_s": round(
            max((ranks[r]["last_heartbeat_age_s"] for r in ranks),
                default=0.0), 3),
    }
    out["rank_epochs"] = {str(r): ranks[r]["epoch"] for r in sorted(ranks)}
    # a just-restarted rank's step-time histogram restarted with it —
    # its p50 must not read as the fleet's fastest (or slowest) rank
    p50s = {r: float(ranks[r]["step_time_p50_s"]) for r in alive
            if float(ranks[r].get("step_time_p50_s") or 0.0) > 0.0
            and not ranks[r].get("restarted")}
    if len(p50s) >= 2:
        lo, hi = min(p50s.values()), max(p50s.values())
        out["step_time_skew"] = round((hi - lo) / lo, 4)
        straggler = max(p50s, key=p50s.get)
        out["straggler_rank"] = straggler
        # the CAUSE column (observe/phases.py heartbeat field): how
        # much of the straggler's priced comm is exposed — "rank 3:
        # 41% exposed-allreduce" instead of a bare rank number
        share = ranks[straggler].get("comm_exposed_share")
        if share is not None:
            from ..monitor import stat_set as _stat_set

            out["straggler_comm_exposed_share"] = float(share)
            out["straggler_cause"] = (
                f"rank {straggler}: {float(share) * 100:.0f}% "
                f"exposed-collective")
            _stat_set("cluster_straggler_comm_exposed_ppm",
                      int(float(share) * 1e6))
    else:
        out["step_time_skew"] = 0.0
    # HBM headroom across the fleet (heartbeat fields fed by
    # xla_stats.record_device_memory): the MIN free — the rank that
    # OOMs first — is the number the budget gate and the sharding
    # planner care about
    frees = {r: int(ranks[r]["hbm_free_bytes"]) for r in alive
             if ranks[r].get("hbm_free_bytes") is not None}
    if frees:
        out["min_hbm_free_bytes"] = min(frees.values())
        out["min_hbm_free_rank"] = min(frees, key=frees.get)

    from ..monitor import stat_set

    stat_set("cluster_ranks_expected", world)
    stat_set("cluster_ranks_alive", len(alive))
    stat_set("cluster_ranks_dead", len(dead))
    stat_set("cluster_step_time_skew_ppm",
             int(out["step_time_skew"] * 1e6))
    stat_set("cluster_max_heartbeat_age_ms",
             int(out["max_heartbeat_age_s"] * 1e3))
    if "min_hbm_free_bytes" in out:
        stat_set("cluster_min_hbm_free_bytes", out["min_hbm_free_bytes"])
    return out


def serve_cluster_health(kv_server, world_size: Optional[int] = None):
    """Register the aggregated ``GET /metrics/cluster`` route on a
    fleet ``KVServer`` (rank 0's).  Heartbeats arrive as ordinary KV
    PUTs under ``health/rank/<k>``; the route aggregates the live
    store on every scrape, so there is no aggregation thread to die.
    The rank-epoch book lives in the route closure — one per server,
    so restart detection survives across scrapes without leaking
    between servers (tests run many)."""
    book: Dict = {}

    def route():
        return cluster_health(kv_server.kv_snapshot(HEALTH_KEY_PREFIX),
                              world_size=world_size, book=book)

    kv_server.add_route("/metrics/cluster", route)
    _flight.record("health/cluster_route", world_size=world_size)
    return route
