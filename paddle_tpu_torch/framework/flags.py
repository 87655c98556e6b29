"""Tier-1 config: the FLAGS_* registry (reference platform/flags.cc +
global_value_getter_setter.cc, python paddle.set_flags/get_flags).

Counterpart of ``paddle_tpu/framework/flags.py``.  Flags initialize from
FLAGS_<name> environment variables (reference gflags env behavior) and
are mutable at runtime via set_flags.  The registry holds only the flags
a module of this package reads, with the JAX package's defaults; each
later slice of the port adds its flags with the code that reads them,
so a flag that is defined here always has an effect.
"""
from __future__ import annotations

import os
from typing import Dict

_TRUTHY = {"1", "true", "True", "TRUE", "yes", "on"}


def _parse(raw: str, default):
    if isinstance(default, bool):
        return raw in _TRUTHY
    if isinstance(default, int):
        return int(raw)
    if isinstance(default, float):
        return float(raw)
    return raw


class _Flag:
    __slots__ = ("name", "value", "default", "help")

    def __init__(self, name, default, help_=""):
        self.name = name
        self.default = default
        self.help = help_
        raw = os.environ.get("FLAGS_" + name)
        self.value = _parse(raw, default) if raw is not None else default


_REGISTRY: Dict[str, _Flag] = {}


def define_flag(name: str, default, help_: str = ""):
    if name in _REGISTRY:
        raise KeyError(f"flag {name!r} already defined")
    _REGISTRY[name] = _Flag(name, default, help_)


def get_flags(flags):
    """paddle.get_flags parity: str or list -> {name: value}."""
    names = [flags] if isinstance(flags, str) else list(flags)
    out = {}
    for n in names:
        key = n[6:] if n.startswith("FLAGS_") else n
        if key not in _REGISTRY:
            raise KeyError(f"unknown flag {n!r}")
        out[n] = _REGISTRY[key].value
    return out


def set_flags(flags: Dict):
    """paddle.set_flags parity: {FLAGS_name or name: value}."""
    for n, v in flags.items():
        key = n[6:] if n.startswith("FLAGS_") else n
        if key not in _REGISTRY:
            raise KeyError(f"unknown flag {n!r}")
        f = _REGISTRY[key]
        f.value = _parse(v, f.default) if isinstance(v, str) else type(f.default)(v)


def flag(name: str):
    """Internal fast accessor."""
    return _REGISTRY[name].value


def flags_snapshot() -> Dict:
    """Current value of EVERY registered flag (flight-recorder run
    metadata + postmortem bundles: the config a failure ran under is
    half the diagnosis)."""
    return {n: f.value for n, f in sorted(_REGISTRY.items())}


# ---- observability (observe/tracer.py, flight.py, request_trace.py,
# slo.py) -----------------------------------------------------------------
define_flag("enable_tracer", False,
            "record host-side spans (serving batch lifecycle, "
            "profiler.RecordEvent) into the in-process ring buffer "
            "(paddle_tpu_torch.observe); export any time with "
            "observe.export_chrome_trace()")
define_flag("flight_recorder", True,
            "record structured lifecycle events (run metadata, serving "
            "start/stop) into the bounded in-process flight-recorder "
            "ring (paddle_tpu_torch.observe.flight); ~µs per event, read "
            "back by observe.flight.tail()")
define_flag("flight_recorder_file", "",
            "optional always-on JSONL sink for flight-recorder events: "
            "every event is appended + flushed to this path, so a "
            "process that dies without running any handler still leaves "
            "its event tail on disk; empty = ring buffer only")
define_flag("flight_recorder_max_mb", 0.0,
            "size-based rotation for the FLAGS_flight_recorder_file "
            "JSONL sink: when the active segment exceeds this many MB "
            "it is rotated to <path>.1 (one previous segment kept); "
            "0 = unbounded")
define_flag("request_trace_sample", 1.0,
            "per-request tracing (observe/request_trace.py): "
            "head-sampling fraction of NORMAL completions whose full "
            "timeline is retained in the bounded finished-trace ring "
            "(deterministic exact rate).  Recording itself is always on; "
            "tail retention keeps every SLO violator and abnormal ending "
            "(deadline/abandoned/rejected/error) REGARDLESS of this "
            "flag — 0 retains only the traces you'd page on")
define_flag("request_trace_ring", 512,
            "capacity of the retained finished-trace ring "
            "(request_trace.TraceStore); oldest retained traces fall "
            "off — in-flight timelines are unaffected")
define_flag("slo_ttft_p99_ms", 0.0,
            "SLO objective (observe/slo.py): time-to-first-token p99 "
            "target in ms — a request whose ttft exceeds it (or that "
            "dies before first token) burns the 1% error budget; "
            "0 = objective disabled")
define_flag("slo_tpot_p50_ms", 0.0,
            "SLO objective: per-request MEAN time-per-output-token p50 "
            "target in ms (budget 50%); 0 = disabled")
define_flag("slo_error_rate_ppm", 10000,
            "SLO objective: allowed fraction of requests ending in any "
            "outcome other than 'completed', in parts-per-million "
            "(default 10000 = 1%); 0 = disabled")
define_flag("slo_windows_s", "60,300",
            "comma-separated rolling window lengths (seconds) for the "
            "multi-window burn-rate evaluation; goodput is measured over "
            "the shortest window")

# ---- health, memory accounting, phases and profiler capture
# (observe/health.py, xla_stats.py, phases.py, profiler_capture.py) ---------
define_flag("stall_timeout_s", 0.0,
            "stall watchdog (paddle_tpu_torch.observe.health): when > 0, "
            "a daemon thread samples executor progress (steps dispatched "
            "vs drained, in-flight window age) and dumps a postmortem "
            "bundle (all-thread stacks, Chrome trace, metrics snapshot, "
            "flight-recorder tail, flags) after this many seconds of "
            "no-progress with work pending; 0 = disabled")
define_flag("postmortem_dir", "postmortem",
            "directory postmortem bundles are written under (stall "
            "watchdog, crash hook, anomaly captures); each dump is its "
            "own bundle_<ts>_<pid>_<reason> subdirectory -- read one "
            "with: python -m tools.postmortem <dir>")
define_flag("heartbeat_interval_s", 10.0,
            "cluster health telemetry (observe/health.py): period of "
            "each rank's HealthReporter heartbeat PUT to the fleet KV "
            "HTTP server; a rank is reported dead on /metrics/cluster "
            "after 3 missed intervals")
define_flag("hbm_budget_fraction", 0.0,
            "pre-launch memory budget gate: when > 0, a program whose "
            "estimated footprint on the card (its state and feeds plus "
            "the peak of its live temporaries in the executor's "
            "last-use order, at the run's shapes) exceeds this fraction "
            "of the device's memory is rejected at its key's first run, "
            "before anything launches, with a MemoryBudgetError naming "
            "the largest vars.  0 = gate disabled")
define_flag("hbm_bytes_per_device", 0,
            "explicit per-device memory capacity in bytes for the budget "
            "gate; 0 = the card's total_memory (none on the CPU, where "
            "the gate then skips unless this override is set)")
define_flag("phase_attribution", True,
            "step-phase attribution (paddle_tpu_torch.observe.phases): "
            "decompose each drained step's wall time into compute / "
            "exposed-collective / host-blocked / input-wait buckets "
            "(phase_*_seconds_micro gauges + the per-collective "
            "exposed-vs-hidden ledger on /metrics).  Pure observer: "
            "never affects lowering or numerics -- the measured split "
            "comes from timestamps the drain path already takes, the "
            "predicted split from the program's FLOPs over "
            "FLAGS_device_peak_tflops (none while that is 0)")
define_flag("phase_interconnect_gbps", 0.0,
            "assumed per-device interconnect bandwidth (GB/s) for the "
            "phase-attribution cost model's predicted collective "
            "times (observe/phases.py); 0 (the default) leaves "
            "collectives unpriced: set it to your fabric's number.  "
            "Prediction only: measured phases and step numerics never "
            "read it")
define_flag("prof_trigger_ratio", 0.0,
            "anomaly-triggered profiling (observe/profiler_capture): "
            "when a drained step's wall time exceeds this ratio x the "
            "rolling step-time baseline (or an slo_burn_rate_* gauge "
            "trips past its budget), capture ONE bounded torch.profiler "
            "trace window + phase snapshot into a postmortem bundle "
            "(phases.json section), then latch until the step time "
            "drops back under the threshold; 0 = disabled")
define_flag("prof_cooldown_s", 60.0,
            "minimum seconds between two anomaly-triggered captures "
            "(observe/profiler_capture): after one bundle is written "
            "the trigger stays quiet for this long even if the episode "
            "re-trips -- a sustained regression produces one bundle per "
            "cooldown window, not one per step; the capture itself "
            "perturbs step times, so this also keeps the observer from "
            "triggering on its own overhead")
define_flag("prof_capture_s", 2.0,
            "bound (seconds) of one anomaly/continuous profiler "
            "capture window -- the trace is stopped after this long no "
            "matter what, so a capture can never become the overhead "
            "it is meant to explain")
define_flag("prof_continuous_s", 0.0,
            "continuous low-duty-cycle profiling: every this many "
            "seconds, capture one FLAGS_prof_capture_s torch.profiler "
            "window (duty cycle = capture_s / continuous_s) into a "
            "2-deep rotation of directories; 0 = disabled")

# ---- decode engine (serving/decode.py DecodeConfig defaults) -------------
define_flag("decode_slots", 8,
            "fixed slot-batch capacity of one DecodeEngine replica — the "
            "number of requests decoding jointly in each step; new "
            "requests claim free slots at step boundaries (continuous "
            "batching), finished/expired slots free immediately")
define_flag("decode_max_seq_len", 256,
            "per-slot sequence capacity (prompt + generated), and the "
            "width of the paged KV cache's per-slot page table; must be "
            "a multiple of FLAGS_decode_page_size")
define_flag("decode_page_size", 16,
            "positions per KV-cache page (serving/kv_cache.py) — pages "
            "are the allocation grain, reserved at admission and freed "
            "the moment a request finishes")
define_flag("decode_max_new_tokens", 64,
            "default generation budget when a request does not pass "
            "max_new_tokens; admission reserves cache pages for prompt + "
            "this many positions")
define_flag("decode_prefix_cache", True,
            "share KV-cache pages across requests whose prompts open "
            "with the same token prefix (serving/kv_cache.py "
            "PrefixIndex), with refcounts + copy-on-write at the first "
            "divergent token; finished requests register their pages "
            "for future hits (evicted LRU under pool pressure)")
define_flag("decode_prefill_chunk_pages", 0,
            "chunked prefill — a prompt longer than this many cache "
            "pages fills them across several step boundaries instead of "
            "stalling the slot batch on one long prefill; 0 = off")
define_flag("decode_ragged_prefill", 0,
            "ragged prefill packing -- pack up to this many query rows "
            "of several requests' chunk tails into ONE fixed-width "
            "dispatch of one-row lanes (each lane its own page-table "
            "row and (page, offset) write coords), instead of padding "
            "each prompt's chunk; needs decode_prefill_chunk_pages > 0; "
            "0 = off (per-request padded dispatches)")
define_flag("decode_spec_k", 0,
            "speculative decoding window -- a draft model "
            "(DecodeEngine(draft_model=, draft_weights=)) proposes this "
            "many tokens per round and the target verifies them in ONE "
            "batched step; every emitted token is the target's argmax in "
            "the verify logits; 0 = off, ignored unless a draft model is "
            "configured")
define_flag("decode_kv_quant", False,
            "store KV-cache pages int8 with a parallel per-page scale "
            "pool (serving/kv_cache.py) — scales are per position-in-"
            "page per head; the attention kernels dequantize pages "
            "inline")

# ---- disaggregated serving (serving/disagg.py) -----------------------------
define_flag("disagg_prefill_replicas", 1,
            "replicas in the PREFILL set of a DisaggServer -- they run "
            "only (chunked) prefill + first-token sampling, then hand the "
            "request's KV pages off to a decode replica")
define_flag("disagg_decode_replicas", 1,
            "replicas in the DECODE set -- they admit requests by "
            "INSTALLING migrated KV pages (no prefill compute) and emit "
            "from the first decode step")
define_flag("disagg_migrate_host_bounce", False,
            "force KV-page migration through host memory (.cpu() out, "
            ".to(device) in) even when prefill and decode replicas share "
            "a device; off = device-to-device pool-slice copy when "
            "possible")
define_flag("disagg_handoff_timeout_s", 120.0,
            "how long the router waits for a prefill replica to finish "
            "one request's prefill leg before treating the replica as "
            "failed and re-dispatching the request")
define_flag("disagg_redispatch_retries", 2,
            "how many times the router re-dispatches one request after a "
            "prefill-replica failure before failing it to the client")
define_flag("disagg_autoscale_interval_s", 1.0,
            "seconds between policy ticks of the background Autoscaler "
            "thread; each tick may re-role at most one replica")
define_flag("disagg_autoscale_cooldown_s", 30.0,
            "minimum seconds between two re-roles (the anti-flap floor); "
            "a trigger inside the window is counted "
            "(autoscale_cooldown_skips_total) and dropped")
define_flag("disagg_autoscale_burn_high", 1.0,
            "ttft-objective SLO burn rate at/above which a decode "
            "replica is re-roled into the prefill set")
define_flag("disagg_autoscale_burn_low", 0.25,
            "ttft burn rate at/below which a prefill replica may be "
            "given up to the decode set (the lower half of the "
            "hysteresis band)")
define_flag("disagg_autoscale_queue_high", 4,
            "mean decode-replica queue depth at/above which (with burn "
            "under burn_low) a prefill replica is re-roled into the "
            "decode set")

# ---- elastic training (distributed/fleet/elastic) --------------------------
define_flag("elastic_preflight_timeout_s", 240.0,
            "deadline for ONE subprocess-isolated device preflight probe "
            "(fleet.elastic.preflight_device: a CUDA add and a "
            "synchronize in a CHILD process, so a wedged device can never "
            "hang the caller)")
define_flag("elastic_backoff_s", 10.0,
            "base backoff between preflight attempts; attempt k sleeps "
            "backoff * 2^(k-1)")
define_flag("elastic_max_restarts", 3,
            "elastic training supervisor (distributed/fleet/elastic): "
            "restart budget — how many times ElasticSupervisor.run may "
            "restart (in place) or re-shard (after a dead rank) "
            "following a classified failure before raising a terminal "
            "ElasticTerminated with the full restart history")

# ---- step telemetry (observe/step_stats.py) -------------------------------
define_flag("device_peak_tflops", 0.0,
            "per-card peak TFLOP/s used by the MFU estimate "
            "(observe/step_stats.py, hapi BenchmarkCallback); 0 (the "
            "default) leaves MFU null: set it to your part's peak for the "
            "dtype the step runs in")

# ---- static-graph executor and its lowerings (framework/executor.py,
# ops/fused.py) ------------------------------------------------------------
define_flag("check_nan_inf", False,
            "scan every op output for NaN/Inf after each executor run "
            "(reference operator.cc:1129): one finite flag per floating "
            "op output is computed on the device inside the step (the "
            "captured graph included) and fetched as one tensor; the "
            "host checks it when the step drains and raises RuntimeError "
            "naming the "
            "first non-finite op's type, build site and index.  Every "
            "run drains through itself while it is set, so the raise "
            "happens inside the offending run")
define_flag("benchmark", False,
            "sync + time each executor call: a pipelined run drains "
            "through itself, a synchronous one waits for its step's "
            "event, so the recorded time is the step's")
define_flag("max_inflight_steps", 2,
            "pipelined step dispatch (framework/executor.py): Executor."
            "run returns a lazy StepHandle and up to this many steps may "
            "be in flight on the device before dispatch backpressures "
            "(drains the oldest step).  0 = legacy synchronous fetch "
            "(every run blocks on device->host transfer of its fetch "
            "list).  NaN-scan, FLAGS_benchmark sync, and StepTimer "
            "accounting all happen at window-drain points; "
            "FLAGS_benchmark / FLAGS_check_nan_inf force an immediate "
            "drain per step so their semantics stay per-call")
define_flag("flash_attention", "auto",
            "fused attention kernel engagement: 'auto' (the flash kernel "
            "only on CUDA tensors whose float32 score tensor would pass "
            "2 GB), 'always' (at every aligned shape on CUDA tensors), "
            "'never' (the plain composition).  Also gates the graph pass "
            "that rewrites an unfused attention chain to flash_attention "
            "(framework/passes.py): 'never' no rewrite, 'always' rewrite, "
            "'auto' only when the default device is CUDA")
define_flag("fuse_passes", True,
            "run the program-IR optimization pass pipeline "
            "(framework/passes.py: attention-chain fusion, redundant-cast "
            "and dead-op elimination) on a clone of the program before "
            "the executor lowers it; off runs the program exactly as "
            "built")

# ---- scan-over-layers (framework/passes.py LayerScanPass,
# ops/layer_scan.py) --------------------------------------------------------
define_flag("layer_scan", False,
            "scan-over-layers (framework/passes.py LayerScanPass): detect "
            "maximal runs of isomorphic repeated op segments (the "
            "forward, backward and optimizer regions a repeated-layer "
            "model builder emits), stack their per-layer state on a "
            "leading num_layers axis, and run each run as ONE layer_scan "
            "op whose body lowers one layer's ops once per layer, with "
            "bit-identical step numerics.  Also enabled per program by "
            "DistributedStrategy.recompute_configs={'scan_layers': N}; "
            "non-matching programs are left untouched "
            "(pass_layer_scan_skipped counters name why)")
define_flag("layer_scan_min_layers", 4,
            "minimum isomorphic segment repeat count before "
            "LayerScanPass rewrites a run; "
            "recompute_configs={'scan_layers': N} overrides per program")
define_flag("layer_scan_policy", "",
            "rematerialization policy recorded on each layer_scan op: '' "
            "or one of the JAX package's names ('nothing_saveable', "
            "'dots_saveable', 'checkpoint_dots', 'save_anything', "
            "'everything_saveable', 'dots_with_no_batch_dims_saveable'). "
            "The port's recompute is program-level (recompute_configs "
            "checkpoints); the policy changes no number")
define_flag("layer_scan_unroll", 1,
            "the JAX package's lax.scan unroll= factor; the port's "
            "layer_scan body is a Python loop over the layers, so the "
            "factor is recorded on the op (attr 'unroll') and changes "
            "nothing that runs")

# ---- weight-only quantized inference (slim/quantization.py,
# ops/quant_ops.py) --------------------------------------------------------
define_flag("weight_quant", "",
            "post-training weight-only quantization "
            "(slim/quantization.py PostTrainingWeightQuantPass): rewrite "
            "matmul-family weights to a compact carrier + per-output-"
            "channel scales lowered through the dequant-fused "
            "ops/quant_ops.dequant_matmul kernel.  '' = off; 'int8' = "
            "symmetric int8; 'fp8_e4m3' = float8 e4m3 "
            "(torch.float8_e4m3fn; a torch without it falls back to int8 "
            "with quant_fp8_unavailable counted).  Per-program override: "
            "slim.quantization.mark_weight_quant")

# ---- checkpoints (ckpt/manager.py) -----------------------------------------
define_flag("ckpt_async_save", True,
            "CheckpointManager default (paddle_tpu_torch.ckpt): hand "
            "serialization + shard writes to the background writer "
            "thread so save() blocks only for the device snapshot")
define_flag("ckpt_keep_n", 5,
            "checkpoint retention default: keep the N newest committed "
            "steps (0 = keep everything); keep_every_n_steps multiples "
            "survive GC regardless")
define_flag("ckpt_fsync", True,
            "fsync shard/manifest files and directories at commit -- the "
            "atomicity guarantee against power loss; disable only for "
            "tests/benchmarks on throwaway dirs")
define_flag("ckpt_verify_restore", True,
            "verify the SHA-256 of every shard against the manifest "
            "before restoring (off: existence+size checks only)")

# ---- distributed (distributed/parallel_env.py) -----------------------------
define_flag("pp_degree", 0,
            "default pipeline-parallel degree for a mesh built without a "
            "shape; the port runs one process a card and builds no mesh, "
            "so it refuses a degree above 1 (parallel_env.init_parallel_env)")
define_flag("overlap_grad_allreduce", True,
            "FuseAllReducePass (framework/passes.py): a bucket holding a "
            "layer-scan stacked gradient carrier closes at its scan "
            "boundary instead of taking the unrolled edge layers' "
            "gradients behind it, as in the JAX package")
define_flag("ep_degree", 0,
            "default expert-parallel degree for a mesh built without a "
            "shape; the port refuses a degree above 1, as for pp_degree")
define_flag("moe_alltoall_chunks", 0,
            "MoE (ops/moe_ops.py): run the expert FFN over this many "
            "CAPACITY-axis chunks, concatenated and combined once, so "
            "chunked and sequential schedules stay bitwise-identical; a "
            "capacity the count does not divide runs unchunked, counted "
            "moe_alltoall_fallback.  0/1 = off.  In the JAX package the "
            "chunks overlap the expert-parallel all-to-all; at one "
            "process there is none to overlap")
