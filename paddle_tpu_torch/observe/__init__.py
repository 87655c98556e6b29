"""``paddle_tpu_torch.observe`` — always-on in-process telemetry.

Counterpart of ``paddle_tpu.observe``, module for module:

- ``tracer``     — host-side span ring buffer (``FLAGS_enable_tracer``),
  fed by the Executor phases, graph passes, the serving batch
  lifecycle, and every ``profiler.RecordEvent``.
- ``timeline``   — Chrome trace-event JSON export of that buffer, plus a
  ``python -m paddle_tpu_torch.observe.timeline`` CLI.
- ``histogram``  — log-bucketed ``stat_time`` latency histograms with
  p50/p95/p99, and the Prometheus text exposition behind the fleet KV
  HTTP server's ``/metrics`` route.
- ``step_stats`` — ``StepTimer``: step-time distribution, examples/sec,
  compile-vs-execute split and the MFU estimate.
- ``flight``     — bounded ring of structured lifecycle events, gated by
  ``FLAGS_flight_recorder``, with an optional JSONL file sink.
- ``health``     — stall watchdog (``FLAGS_stall_timeout_s``) dumping
  postmortem bundles, crash/atexit hooks, and the heartbeat/cluster
  health plane over the fleet KV server (``/metrics/cluster``).
- ``request_trace`` / ``slo`` — per-request serving timelines and the
  declarative objectives with their burn rates and goodput.
- ``phases``     — step-phase attribution of each drained step
  (compute / exposed-collective / host / input-wait).
- ``profiler_capture`` — anomaly-triggered + continuous
  ``torch.profiler`` capture into postmortem bundles.
- ``metrics_catalog`` — the name → (type, unit, subsystem) catalog
  behind ``paddle_tpu_torch/observe/METRICS.md``.
- ``xla_stats``  — the compiled step's compile telemetry, the caching
  allocator's memory accounting and the pre-launch memory budget gate
  (``FLAGS_hbm_budget_fraction`` → :class:`~.xla_stats.MemoryBudgetError`).
"""
from . import (flight, health, metrics_catalog, phases, profiler_capture,
               request_trace, slo, xla_stats)
from .flight import FlightRecorder, get_flight_recorder
from .phases import (PhaseEngine, PhasePlan, build_phase_plan,
                     collective_inventory, phase_engine, phases_report,
                     reset_phases)
from .profiler_capture import (CaptureEngine, capture_engine,
                               parse_trace_dir, reset_capture)
from .request_trace import (RequestTrace, TraceStore,
                            export_request_chrome_trace, get_trace_store)
from .slo import Objective, SLOEngine, get_slo_engine
from .health import (HealthReporter, StallWatchdog, cluster_health,
                     dump_postmortem, executor_progress,
                     install_crash_handler, serve_cluster_health,
                     start_watchdog, stop_watchdog)
from .histogram import (Histogram, HistogramRegistry, export_histograms,
                        histogram, prometheus_text, stat_time)
from .step_stats import (StepTimer, mfu_estimate, reset_step_stats,
                         step_timer)
from .xla_stats import (MemoryBudgetError, check_hbm_budget,
                        device_memory_stats, memory_breakdown,
                        memory_report, var_attribution)
from .tracer import (SpanRecord, Tracer, begin, clear, disable, enable,
                     enabled, end, get_tracer, set_span_args, snapshot,
                     span)
from .timeline import chrome_trace, export_chrome_trace

__all__ = [
    # tracer
    "SpanRecord", "Tracer", "get_tracer", "enabled", "enable", "disable",
    "span", "begin", "end", "set_span_args", "snapshot", "clear",
    # timeline
    "chrome_trace", "export_chrome_trace",
    # histograms
    "Histogram", "HistogramRegistry", "histogram", "stat_time",
    "export_histograms", "prometheus_text",
    # step telemetry
    "StepTimer", "step_timer", "reset_step_stats", "mfu_estimate",
    # flight recorder
    "flight", "FlightRecorder", "get_flight_recorder",
    # health plane
    "health", "StallWatchdog", "HealthReporter", "executor_progress",
    "dump_postmortem", "start_watchdog", "stop_watchdog",
    "install_crash_handler", "cluster_health", "serve_cluster_health",
    # XLA introspection
    "xla_stats", "MemoryBudgetError", "memory_breakdown",
    "var_attribution", "check_hbm_budget", "device_memory_stats",
    "memory_report",
    # phase attribution + profiler capture + metrics catalog
    "phases", "PhasePlan", "PhaseEngine", "build_phase_plan",
    "collective_inventory", "phase_engine", "phases_report",
    "reset_phases", "profiler_capture", "CaptureEngine",
    "capture_engine", "parse_trace_dir", "reset_capture",
    "metrics_catalog",
    # per-request tracing + SLO plane
    "request_trace", "RequestTrace", "TraceStore", "get_trace_store",
    "export_request_chrome_trace", "slo", "Objective", "SLOEngine",
    "get_slo_engine",
]
