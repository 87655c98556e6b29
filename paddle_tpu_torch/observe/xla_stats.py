"""Compile telemetry, device-memory accounting and the budget gate of the
executor's compiled step.

Counterpart of ``paddle_tpu/observe/xla_stats.py``, kept under its name
so the JAX package's API resolves here.  The JAX module reads XLA's
compiled executable; the port's compiled step is an ``_Entry`` of
``framework/executor.py``: on the card a CUDA graph captured after one
eager warm-up run, on the CPU the plan run op by op.  So:

- **Compile telemetry** -- :func:`on_compile` is called once a key's
  step is captured (its first run on the CPU and for a program that runs
  eagerly), with the capture's wall time: the ``compile_seconds``
  histogram, an ``executor/compile_done`` flight event and a record in
  a bounded ring (``memory.json`` in postmortem bundles).
- **Device-memory accounting** -- :func:`memory_breakdown` gives the
  JAX keys for the step: ``arguments_bytes`` (state and feeds),
  ``outputs_bytes`` (fetches), ``temporaries_bytes`` (the step's own
  peak above its inputs, less its fetches, read from the caching
  allocator after each op of the eager warm-up), ``generated_code_bytes``
  (0), ``aliased_bytes`` (state updated in place) and ``total_bytes``;
  none on the CPU, which has no caching allocator.  :func:`cost_flops`
  is None, as the JAX function is where XLA cannot say: MFU keeps
  ``program_flops``.  Live ``torch.cuda.memory_stats`` rides the
  heartbeat (observe/health.py) onto ``/metrics/cluster``.
- **Pre-launch budget gate** -- the port has no compiler memory
  analysis, so the executor estimates a key's footprint from its
  program before the first launch (state and feeds, plus the peak of the
  live temporaries in its last-use order at the run's shapes) and calls
  :func:`check_hbm_budget`; over ``FLAGS_hbm_budget_fraction`` of the
  card's memory it raises :class:`MemoryBudgetError` with nothing
  launched.

Nothing here synchronizes the card: the watchdog's thread calls
:func:`record_device_memory`, and ``torch.cuda.memory_stats`` and
``get_device_properties`` read host-side counters.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..framework import flags as _flags
from . import flight as _flight
from .histogram import stat_time

__all__ = ["COMPILE_SECONDS_HISTOGRAM", "MemoryBudgetError",
           "memory_breakdown", "cost_flops", "var_attribution",
           "format_attribution", "device_memory_stats",
           "device_hbm_capacity", "record_device_memory",
           "check_hbm_budget", "on_compile", "compile_records",
           "last_compile", "memory_report", "clear_compile_records"]

COMPILE_SECONDS_HISTOGRAM = "compile_seconds"

# how many vars the attribution table keeps (the error message shows 3)
TOP_N_VARS = 10

# bounded ring of compile records: memory.json in postmortem bundles
# reads it
_RECORDS: "collections.deque[dict]" = collections.deque(maxlen=32)
_LOCK = threading.Lock()


class MemoryBudgetError(RuntimeError):
    """Estimated footprint on the card exceeds the configured budget
    (``FLAGS_hbm_budget_fraction`` × device memory).  Raised BEFORE the
    step launches, with the per-var attribution table attached
    (``.attribution``) and its top rows in the message."""

    def __init__(self, message: str, required_bytes: int = 0,
                 budget_bytes: int = 0, capacity_bytes: int = 0,
                 attribution: Optional[Sequence[dict]] = None):
        super().__init__(message)
        self.required_bytes = int(required_bytes)
        self.budget_bytes = int(budget_bytes)
        self.capacity_bytes = int(capacity_bytes)
        self.attribution = list(attribution or [])


def _mb(nbytes) -> float:
    return round(int(nbytes or 0) / 2 ** 20, 2)


def _itemsize(dtype) -> int:
    """Bytes an element of ``dtype``: a numpy name or a torch dtype (or
    its name, ``bfloat16`` and the float8 types included)."""
    import torch

    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    name = str(dtype)
    name = name[len("torch."):] if name.startswith("torch.") else name
    t = getattr(torch, name, None)
    if isinstance(t, torch.dtype):
        return torch.empty((), dtype=t).element_size()
    return np.dtype(name).itemsize


# ---------------------------------------------------------------------------
# the compiled step's readings
# ---------------------------------------------------------------------------


def memory_breakdown(compiled) -> Optional[Dict[str, int]]:
    """Footprint breakdown of a compiled step (its ``memory`` reading,
    taken by the executor at the warm-up), or None where there is none
    (the CPU).  ``total_bytes`` is the live-at-once need: arguments +
    outputs + temporaries + generated code, minus the aliased (updated
    in place) bytes that would otherwise count twice."""
    m = getattr(compiled, "memory", None)
    if not m:
        return None

    def _get(key):
        try:
            return max(int(m.get(key, 0) or 0), 0)
        except (TypeError, ValueError):
            return 0

    args = _get("arguments_bytes")
    outs = _get("outputs_bytes")
    temps = _get("temporaries_bytes")
    alias = _get("aliased_bytes")
    return {
        "arguments_bytes": args,
        "outputs_bytes": outs,
        "temporaries_bytes": temps,
        "generated_code_bytes": 0,
        "aliased_bytes": alias,
        "total_bytes": max(args + outs + temps - alias, 0),
    }


def cost_flops(compiled) -> Optional[float]:
    """FLOPs of one call as the compiler counts them: None, since a
    captured CUDA graph carries no such count (MFU keeps the program's
    own ``program_flops``)."""
    return None


# ---------------------------------------------------------------------------
# per-var attribution
# ---------------------------------------------------------------------------


def var_attribution(entries: Sequence[Tuple], plan=None, mesh=None,
                    top_n: int = TOP_N_VARS) -> List[dict]:
    """The top-N per-device attribution table of var sizes.

    ``entries`` are ``(name, shape, dtype_str, kind)`` tuples (kind:
    ``"state"`` for scope vars, ``"feed"`` for inputs).  The port runs
    on one card and shards nothing: every var is ``replicated`` and its
    per-device bytes are its bytes (``plan``/``mesh`` are the JAX
    signature's; a plan is refused)."""
    if plan is not None or mesh is not None:
        raise NotImplementedError(
            "a sharding plan waits for ROADMAP Queue A item 8: the "
            "PyTorch port runs one card")
    rows: List[dict] = []
    for name, shape, dtype, kind in entries:
        try:
            itemsize = _itemsize(dtype)
        except TypeError:
            continue
        n = 1
        for s in shape:
            n *= max(int(s), 1)
        nbytes = n * itemsize
        rows.append({
            "name": str(name),
            "kind": str(kind),
            "dtype": str(dtype),
            "shape": [int(s) for s in shape],
            "global_bytes": int(nbytes),
            "per_chip_bytes": int(nbytes),
            "spec": "replicated",
        })
    rows.sort(key=lambda r: (-r["per_chip_bytes"], r["name"]))
    return rows[:max(int(top_n), 1)]


def format_attribution(rows: Sequence[dict], limit: Optional[int] = None
                       ) -> str:
    """Render attribution rows as an aligned text table (error messages
    and logs; the postmortem CLI has its own pure-stdlib renderer)."""
    rows = list(rows)[:limit] if limit else list(rows)
    if not rows:
        return "  (no per-var attribution available)"
    width = max(len(r["name"]) for r in rows)
    out = [f"  {'var':<{width}}  {'per-chip MB':>12}  {'global MB':>10}  "
           f"{'kind':<5}  spec"]
    for r in rows:
        out.append(
            f"  {r['name']:<{width}}  {_mb(r['per_chip_bytes']):>12}  "
            f"{_mb(r['global_bytes']):>10}  {r['kind']:<5}  {r['spec']}")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# live device memory (heartbeat thread -> /metrics + /metrics/cluster)
# ---------------------------------------------------------------------------


def _cuda_index(device) -> Optional[int]:
    """The CUDA index of ``device`` (None: the current one), or None when
    it is not a card or no CUDA context exists yet (a probe must not be
    the call that creates one)."""
    import torch

    if device is not None:
        d = torch.device(device) if not isinstance(device, torch.device) \
            else device
        if d.type != "cuda":
            return None
    if not torch.cuda.is_initialized():
        return None
    if device is None:
        return torch.cuda.current_device()
    return d.index if d.index is not None else torch.cuda.current_device()


def device_memory_stats(device=None) -> Optional[dict]:
    """The caching allocator's counters for a card as a plain dict
    (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_reserved``,
    ``bytes_limit`` and ``torch.cuda.memory_stats``'s own keys), or None
    for the CPU or before the card is in use.  Host-side reads only."""
    import torch

    idx = _cuda_index(device)
    if idx is None:
        return None
    try:
        ms = dict(torch.cuda.memory_stats(idx))
        limit = int(torch.cuda.get_device_properties(idx).total_memory)
    except (RuntimeError, AssertionError):
        return None
    ms.update(bytes_in_use=int(ms.get("allocated_bytes.all.current", 0)),
              peak_bytes_in_use=int(ms.get("allocated_bytes.all.peak", 0)),
              bytes_reserved=int(ms.get("reserved_bytes.all.current", 0)),
              bytes_limit=limit)
    return ms


def device_hbm_capacity(device=None) -> Optional[int]:
    """Per-device memory capacity in bytes for the budget gate:
    ``FLAGS_hbm_bytes_per_device`` when set, else the card's
    ``total_memory``, else None (the gate skips)."""
    override = int(_flags.flag("hbm_bytes_per_device"))
    if override > 0:
        return override
    ms = device_memory_stats(device)
    if ms:
        limit = int(ms.get("bytes_limit", 0) or 0)
        if limit > 0:
            return limit
    return None


def record_device_memory(devices=None) -> dict:
    """One live memory sample across the visible cards, mirrored to
    ``/metrics`` gauges (``hbm_free_bytes`` = the MIN free -- the card
    that runs out first -- plus ``hbm_used_bytes``/``hbm_limit_bytes``)
    and returned as heartbeat payload fields for ``/metrics/cluster``.
    Returns {} where no card reports (the CPU, or before a CUDA context
    exists).  Used is the caching allocator's allocated bytes."""
    if devices is None:
        import torch

        if not torch.cuda.is_initialized():
            return {}
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    free = used = limit = None
    for d in devices:
        ms = device_memory_stats(d)
        if not ms:
            continue
        d_limit = int(ms.get("bytes_limit", 0))
        d_used = int(ms.get("bytes_in_use", 0))
        if d_limit <= 0:
            continue
        d_free = max(d_limit - d_used, 0)
        free = d_free if free is None else min(free, d_free)
        used = d_used if used is None else max(used, d_used)
        limit = d_limit if limit is None else max(limit, d_limit)
    if free is None:
        return {}
    from ..monitor import stat_set

    stat_set("hbm_free_bytes", free)
    stat_set("hbm_used_bytes", used)
    stat_set("hbm_limit_bytes", limit)
    return {"hbm_free_bytes": free, "hbm_used_bytes": used,
            "hbm_limit_bytes": limit}


# ---------------------------------------------------------------------------
# the pre-launch budget gate
# ---------------------------------------------------------------------------


def check_hbm_budget(required_bytes: int,
                     attribution: Sequence[dict] = (),
                     device=None, fingerprint: str = "") -> dict:
    """Judge an estimated footprint against the configured budget.
    Returns a verdict record (``disabled`` / ``skipped`` / ``pass``);
    raises :class:`MemoryBudgetError` on rejection -- the caller (the
    executor at a key's first run) has NOT launched anything yet, so the
    failure is a report, not an out-of-memory mid-step."""
    from ..monitor import stat_add

    fraction = float(_flags.flag("hbm_budget_fraction"))
    if fraction <= 0.0:
        return {"verdict": "disabled"}
    capacity = device_hbm_capacity(device)
    if capacity is None:
        # no way to know this device's memory: skip LOUDLY (counter +
        # flight event) rather than pretend the program fits
        stat_add("hbm_budget_gate_skipped")
        _flight.record("xla/hbm_budget_skipped",
                       reason="device memory capacity unknown "
                              "(no card and no "
                              "FLAGS_hbm_bytes_per_device)")
        return {"verdict": "skipped", "fraction": fraction}
    budget = int(fraction * capacity)
    rec = {"fraction": fraction, "capacity_bytes": int(capacity),
           "budget_bytes": budget, "required_bytes": int(required_bytes)}
    if int(required_bytes) <= budget:
        stat_add("hbm_budget_gate_passed")
        rec["verdict"] = "pass"
        return rec
    stat_add("hbm_budget_gate_rejections")
    top = list(attribution)[:3]
    _flight.record("xla/hbm_budget_reject", fingerprint=fingerprint[:16],
                   required_bytes=int(required_bytes),
                   budget_bytes=budget, capacity_bytes=int(capacity),
                   top_vars=[r.get("name") for r in top])
    raise MemoryBudgetError(
        f"estimated device memory footprint {_mb(required_bytes)} MB "
        f"exceeds the budget {_mb(budget)} MB "
        f"(FLAGS_hbm_budget_fraction={fraction} x {_mb(capacity)} MB "
        f"device memory); rejected BEFORE launch.  Largest "
        f"allocations:\n"
        + format_attribution(attribution, limit=TOP_N_VARS)
        + "\nShrink the batch, or raise FLAGS_hbm_budget_fraction.  "
          "Full breakdown: memory.json in the postmortem bundle / "
          "observe.xla_stats.memory_report().",
        required_bytes=int(required_bytes), budget_bytes=budget,
        capacity_bytes=int(capacity), attribution=attribution)


def judge_program(required_bytes: int, size_entries: Sequence[Tuple],
                  device=None, fingerprint: str = "",
                  n_steps: int = 1) -> dict:
    """The executor's gate at a key's first run: the attribution table
    and :func:`check_hbm_budget`'s verdict on the estimate.  A rejected
    program lands in the compile ring with its numbers (``memory.json``
    shows why) before :class:`MemoryBudgetError` propagates."""
    attribution = var_attribution(size_entries)
    try:
        return check_hbm_budget(required_bytes, attribution, device=device,
                                fingerprint=str(fingerprint))
    except MemoryBudgetError as e:
        rec = {"ts": time.time(), "fingerprint": str(fingerprint)[:16],
               "n_steps": int(n_steps), "attribution": attribution,
               "estimated_bytes": int(required_bytes),
               "budget": {"verdict": "rejected",
                          "fraction": float(
                              _flags.flag("hbm_budget_fraction")),
                          "required_bytes": e.required_bytes,
                          "budget_bytes": e.budget_bytes,
                          "capacity_bytes": e.capacity_bytes}}
        with _LOCK:
            _RECORDS.append(rec)
        raise


# ---------------------------------------------------------------------------
# the per-compile entry point (Executor, once a key's step is captured)
# ---------------------------------------------------------------------------


def on_compile(compiled, *, fingerprint: str = "", seconds: float = 0.0,
               size_entries: Sequence[Tuple] = (), plan=None, mesh=None,
               n_steps: int = 1, program_flops: float = 0.0,
               device=None) -> dict:
    """Record one compiled step: telemetry and memory accounting.
    ``compiled`` is the executor's entry: its ``memory`` reading, the
    ``estimated_bytes`` the gate judged and the gate's ``budget``
    verdict.  Returns the compile record (also kept in the bounded ring
    behind :func:`compile_records` / ``memory.json``)."""
    from ..monitor import stat_add, stat_set

    stat_time(COMPILE_SECONDS_HISTOGRAM, max(float(seconds), 0.0))
    rec: dict = {
        "ts": time.time(),
        "fingerprint": str(fingerprint)[:16],
        "compile_seconds": round(float(seconds), 6),
        "n_steps": int(n_steps),
        # a CUDA graph's code is the kernels' modules, loaded once per
        # process and shared by every graph: none of it is the step's
        "executable_size_bytes": 0,
    }
    rec["attribution"] = var_attribution(size_entries, plan=plan,
                                         mesh=mesh)
    breakdown = memory_breakdown(compiled)
    required = 0
    if breakdown is None:
        stat_add("xla_memory_analysis_unavailable")
    else:
        rec["memory"] = breakdown
        required = breakdown["total_bytes"]
        stat_set("hbm_required_bytes", required)
    estimate = getattr(compiled, "estimated_bytes", None)
    if estimate is not None:
        rec["estimated_bytes"] = int(estimate)
    budget = getattr(compiled, "budget", None)
    if budget is not None:
        rec["budget"] = dict(budget)
    _flight.record("executor/compile_done",
                   fingerprint=rec["fingerprint"],
                   seconds=rec["compile_seconds"],
                   executable_size_bytes=0,
                   hbm_required_bytes=required, n_steps=int(n_steps))
    with _LOCK:
        _RECORDS.append(rec)
    return rec


# ---------------------------------------------------------------------------
# reading back (postmortem memory.json, tests, dashboards)
# ---------------------------------------------------------------------------


def compile_records() -> List[dict]:
    with _LOCK:
        return list(_RECORDS)


def last_compile() -> Optional[dict]:
    with _LOCK:
        return _RECORDS[-1] if _RECORDS else None


def clear_compile_records() -> None:
    with _LOCK:
        _RECORDS.clear()


def memory_report(probe_devices: bool = False) -> dict:
    """The ``memory.json`` postmortem section: every recorded compile
    (footprint breakdown + estimate + attribution + budget verdicts)
    plus the heartbeat's CACHED hbm gauges and, with
    ``probe_devices=True``, the caching allocator's live counters (host
    reads: they never wait on the card).  Pure data --
    ``tools/postmortem.py`` renders it without importing the
    framework."""
    from ..monitor import stat_get

    report: dict = {"ts": time.time(), "compiles": compile_records()}
    gauges = {k: stat_get(k) for k in
              ("hbm_free_bytes", "hbm_used_bytes", "hbm_limit_bytes")}
    if any(gauges.values()):
        report["hbm_gauges"] = gauges
    devices = []
    if probe_devices:
        import torch

        if torch.cuda.is_initialized():
            for i in range(torch.cuda.device_count()):
                ms = device_memory_stats(f"cuda:{i}")
                if ms:
                    devices.append({"device": f"cuda:{i}", **{
                        k: ms[k] for k in ("bytes_in_use",
                                           "peak_bytes_in_use",
                                           "bytes_reserved",
                                           "bytes_limit")}})
    report["device_memory"] = devices
    return report
