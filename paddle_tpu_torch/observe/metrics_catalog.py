"""Authoritative metrics catalog: every ``/metrics`` series documented.

Counterpart of ``paddle_tpu/observe/metrics_catalog.py``: the same
rules, plus one for each series only the port exports (the CUDA-graph
counters, the eager runs by ``capture_reason`` kind, the loader's and
``hapi``'s histograms).  The stat plane grew organically (executor
counters, pass stats, serving outcomes, SLO burn gauges, phase
attribution...) and the only inventory was grep.  This module is the
registry of record: an ordered list of prefix rules mapping a series
name (namespace stripped) to its type, unit convention, and owning
subsystem.  Two consumers:

- ``paddle_tpu_torch/observe/METRICS.md`` is *generated* from these
  rules (``python -m paddle_tpu_torch.observe.metrics_catalog
  --write``); the checked-in copy is a drift gate — tier-1 fails when
  the file and the rules disagree.
- ``tests/test_torch_metrics_catalog.py`` scrapes a clean-process
  ``prometheus_text()`` and asserts every exported series matches a
  rule, so a change adding a stat without a catalog row fails loudly.

Units are suffix-encoded by convention (the registry stores ints
only): ``_seconds`` (histogram, float seconds), ``_seconds_micro``
(gauge, integer microseconds), ``_bytes``, ``_ppm`` (parts-per-million
of a ratio), ``_ms``, ``_rps``; bare names are event/object counts.
``unit_of`` resolves a concrete name's unit from its suffix.

Matching is first-rule-wins over the authoring order below, with exact
rules (``exact=True``) checked as whole-name equality and prefix rules
as ``startswith``.
"""
from __future__ import annotations

import sys
from typing import List, NamedTuple, Optional

__all__ = ["Rule", "RULES", "lookup", "unit_of", "catalog_markdown",
           "check_file", "write_file", "main"]


class Rule(NamedTuple):
    prefix: str       # name prefix (or whole name when exact=True)
    type: str         # "gauge" | "histogram" (counters export as gauges)
    subsystem: str    # owning module / plane
    description: str  # one line: what the family measures
    exact: bool = False


# Ordered: exact histogram names first (several share a prefix with
# gauge families), then gauge/counter families grouped by subsystem.
RULES = (
    # -- latency histograms (HistogramRegistry, stat_time) ---------------
    Rule("step_time_seconds", "histogram", "step_stats",
         "Per-step wall time distribution (drained, post-compile)",
         exact=True),
    Rule("compile_seconds", "histogram", "xla_stats",
         "Program compile wall time per cache-miss", exact=True),
    Rule("xla_compile_seconds", "histogram", "xla_stats",
         "XLA-side compile time where introspection exposes it",
         exact=True),
    Rule("input_wait_seconds", "histogram", "io",
         "Executor blocked waiting on the input pipeline", exact=True),
    Rule("fetch_sync_seconds", "histogram", "io",
         "Host-blocking fetch/device-sync sections", exact=True),
    Rule("ckpt_save_blocking_seconds", "histogram", "checkpoint",
         "Train-loop time blocked by a checkpoint save", exact=True),
    Rule("ckpt_write_seconds", "histogram", "checkpoint",
         "Checkpoint shard write+fsync time", exact=True),
    Rule("serving_latency_seconds", "histogram", "serving",
         "End-to-end serving request latency", exact=True),
    Rule("decode_request_latency_seconds", "histogram", "serving",
         "Decode-engine request latency (submit to terminal)",
         exact=True),
    Rule("decode_prefill_seconds", "histogram", "serving",
         "Prefill dispatch time per request/chunk", exact=True),
    Rule("decode_step_seconds", "histogram", "serving",
         "One batched decode step", exact=True),
    Rule("ttft_seconds", "histogram", "slo",
         "Time to first token (SLO input)", exact=True),
    Rule("tpot_seconds", "histogram", "slo",
         "Time per output token (SLO input)", exact=True),
    Rule("emb_lookup_seconds", "histogram", "embedding",
         "Sharded-embedding lookup (gather+alltoall)", exact=True),
    Rule("migrate_seconds", "histogram", "disagg",
         "One KV-page migration install (gather->scatter)",
         exact=True),
    Rule("loader_worker_start_seconds", "histogram", "io",
         "DataLoader worker processes' start-up, once per loader",
         exact=True),
    Rule("hapi_step_time_seconds", "histogram", "hapi",
         "Model.fit batch wall time (BenchmarkCallback)", exact=True),
    # -- executor / compile plane ---------------------------------------
    Rule("executor_eager_", "gauge", "executor",
         "Runs kept eager, by capture_reason kind (host_io, print, "
         "control_flow, py_func, shape_tensor, seeded_random)"),
    Rule("cuda_graph_", "gauge", "executor",
         "CUDA-graph captures and replays of compiled steps "
         "(framework/graphs.py)"),
    Rule("executor_", "gauge", "executor",
         "Dispatch/drain/cache counters of the Executor hot path"),
    Rule("executable_", "gauge", "xla_stats",
         "Compiled-executable size and HLO op counts"),
    Rule("remat_", "gauge", "executor",
         "Rematerialization policy availability/fallbacks"),
    Rule("mfu_", "gauge", "step_stats",
         "Model-FLOPs-utilization estimate bookkeeping"),
    Rule("h2d_", "gauge", "io",
         "Host-to-device transfer bytes (feed path)"),
    # -- graph passes / parallelism -------------------------------------
    Rule("pass_", "gauge", "passes",
         "Graph-pass effect counters (fusion, scan, DCE, quant, TP)"),
    Rule("pipeline_", "gauge", "pipeline",
         "Pipeline-parallel scan/segment counters"),
    Rule("pp_", "gauge", "pipeline",
         "Pipeline-parallel schedule stats (stages, bubble fraction)"),
    Rule("tp_", "gauge", "tensor_parallel",
         "Tensor-parallel constraint/fallback counters"),
    Rule("collective_matmul_", "gauge", "tensor_parallel",
         "Collective-matmul chunking engagement/fallbacks"),
    Rule("ep_", "gauge", "expert_parallel",
         "Expert-parallel ('ep' axis) mesh/plan bookkeeping"),
    Rule("moe_", "gauge", "expert_parallel",
         "Mixture-of-experts routing: expert balance and drop "
         "fractions (ppm), routed-FFN engagement, all-to-all "
         "chunking engagement/fallbacks"),
    Rule("flash_attention_", "gauge", "kernels",
         "Flash-attention kernel engagement"),
    Rule("quant_", "gauge", "quantization",
         "Quantization engagement and quality deltas"),
    # -- phase attribution / profiling ----------------------------------
    Rule("phase_", "gauge", "phases",
         "Step-phase attribution: per-bucket seconds/fractions and "
         "predicted compute/comm split"),
    Rule("comm_", "gauge", "phases",
         "Collective ledger: exposed vs hidden communication time"),
    Rule("prof_", "gauge", "profiler_capture",
         "Anomaly-triggered / continuous profiler capture counters"),
    # -- observability plane --------------------------------------------
    Rule("flight_", "gauge", "flight",
         "Flight-recorder sink bookkeeping (rotations)"),
    Rule("watchdog_", "gauge", "health",
         "Stall-watchdog trips"),
    Rule("postmortem_", "gauge", "health",
         "Postmortem bundles written"),
    Rule("health_", "gauge", "health",
         "Heartbeat delivery failures/blackholes"),
    Rule("cluster_", "gauge", "health",
         "Rank-0 aggregated cluster health (skew, stragglers, HBM)"),
    Rule("hbm_", "gauge", "xla_stats",
         "HBM budget gate and live device memory"),
    Rule("xla_", "gauge", "xla_stats",
         "XLA introspection availability/fallback counters"),
    Rule("slo_", "gauge", "slo",
         "SLO burn rates and remaining error budget per objective"),
    Rule("request_trace", "gauge", "request_trace",
         "Per-request trace store occupancy/retention"),
    # -- training-side subsystems ---------------------------------------
    Rule("ckpt_", "gauge", "checkpoint",
         "Checkpoint save/restore/GC outcomes and bytes"),
    Rule("elastic_", "gauge", "elastic",
         "Elastic restart/reshard lifecycle counters"),
    Rule("chaos_", "gauge", "elastic",
         "Chaos fault injection arming/firing"),
    Rule("emb_", "gauge", "embedding",
         "Sharded-embedding traffic and placement stats"),
    # -- serving ---------------------------------------------------------
    Rule("decode_", "gauge", "serving",
         "Decode-engine lifecycle, paging, speculation, goodput"),
    Rule("serving_", "gauge", "serving",
         "Batching server lifecycle and queue occupancy"),
    Rule("prefill_", "gauge", "serving",
         "Chunked-prefill padding/live token accounting"),
    Rule("spec_", "gauge", "serving",
         "Speculative-decoding acceptance rates"),
    # -- disaggregated serving (serving/disagg.py) ------------------------
    Rule("migrate_", "gauge", "disagg",
         "KV-page migration traffic (pages/bytes, device vs "
         "host-bounce transport)"),
    Rule("disagg_", "gauge", "disagg",
         "Disagg router lifecycle: handoffs, re-dispatches, replica "
         "deaths, role-set sizes"),
    Rule("autoscale_", "gauge", "disagg",
         "SLO-driven re-roling: re-roles, cooldown skips, preflight "
         "failures, observed burn/queue signals"),
)

_UNIT_SUFFIXES = (
    ("_seconds_micro", "microseconds (int)"),
    ("_us_total", "microseconds (int)"),
    ("_seconds", "seconds"),
    ("_bytes", "bytes"),
    ("_ppm", "parts-per-million"),
    ("_micro", "micro-units (int, value x 1e6)"),
    ("_ms", "milliseconds"),
    ("_rps", "requests/second"),
)


def unit_of(name: str) -> str:
    """Unit of a concrete series name by suffix convention."""
    for suffix, unit in _UNIT_SUFFIXES:
        if name.endswith(suffix):
            return unit
    return "count"


def lookup(name: str) -> Optional[Rule]:
    """First rule matching ``name`` (namespace already stripped), or
    None — an undocumented series."""
    for r in RULES:
        if (name == r.prefix) if r.exact else name.startswith(r.prefix):
            return r
    return None


def catalog_markdown() -> str:
    """Deterministic METRICS.md body rendered from ``RULES``."""
    lines = [
        "# Metrics catalog",
        "",
        "Generated by `python -m paddle_tpu_torch.observe."
        "metrics_catalog --write` — do not edit by hand; tier-1 "
        "(`tests/test_torch_metrics_catalog.py`) fails on drift and on "
        "any `/metrics` series of the PyTorch port without a row here.",
        "",
        "Series are exported under the `paddle_tpu_` namespace. "
        "`Match` is a name prefix unless marked `(exact)`. Units are "
        "suffix-encoded per name: `_seconds` (float, histograms), "
        "`_seconds_micro`/`_micro` (integer micro-units), `_bytes`, "
        "`_ppm` (parts-per-million), `_rps`; bare names are counts. "
        "Counters export with Prometheus type `gauge` because the "
        "registry is resettable.",
        "",
        "| Match | Type | Subsystem | Description |",
        "|---|---|---|---|",
    ]
    for r in RULES:
        match = f"`{r.prefix}`" + (" (exact)" if r.exact else "*")
        lines.append(
            f"| {match} | {r.type} | {r.subsystem} | {r.description} |")
    return "\n".join(lines) + "\n"


def write_file(path: str) -> str:
    with open(path, "w") as f:
        f.write(catalog_markdown())
    return path


def check_file(path: str) -> bool:
    """True when the checked-in catalog matches the rules."""
    try:
        with open(path) as f:
            return f.read() == catalog_markdown()
    except OSError:
        return False


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import os

    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.observe.metrics_catalog",
        description="Generate/verify METRICS.md from the catalog rules")
    p.add_argument("--write", action="store_true",
                   help="(re)write METRICS.md")
    p.add_argument("--check", action="store_true",
                   help="exit 1 when METRICS.md drifted from the rules")
    p.add_argument("--path", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "METRICS.md"))
    args = p.parse_args(argv)
    if args.write:
        print(write_file(args.path))
        return 0
    if args.check:
        if check_file(args.path):
            print("METRICS.md: up to date")
            return 0
        print("METRICS.md: DRIFTED — regenerate with --write",
              file=sys.stderr)
        return 1
    print(catalog_markdown(), end="")
    return 0


if __name__ == "__main__":  # pragma: no cover - CLI
    sys.exit(main())
