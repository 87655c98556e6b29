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
            "ragged prefill packing; any value above 0 raises until a "
            "later slice of the port brings it")
define_flag("decode_spec_k", 0,
            "speculative decoding window; any value above 0 raises "
            "until a later slice of the port brings it")
define_flag("decode_kv_quant", False,
            "store KV-cache pages int8 with a parallel per-page scale "
            "pool (serving/kv_cache.py) — scales are per position-in-"
            "page per head; the attention kernels dequantize pages "
            "inline")

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
            "(reference operator.cc:1129); the port's executor raises "
            "NotImplementedError when it is set: the scan comes with a "
            "later slice of the port")
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
