"""Step-phase attribution: where a drained step's wall time goes.

Counterpart of ``paddle_tpu/observe/phases.py``.  Every drained step of
the executor's window is decomposed into four buckets that sum exactly
to its wall time:

- **compute**      -- device time spent in the program's math,
- **comm_exposed** -- device time stalled on collectives NOT hidden
  under compute,
- **host**         -- dispatch-side host work (pass pipeline, state
  analysis, feed conversion) measured on the dispatch path, the wait
  for backpressure left out,
- **input_wait**   -- everything else between drains: the data loader
  and user code between ``run`` calls.

Two sources feed the split, and both are reported:

- **Measured** (``phase_*``): the window-drain timestamps the executor
  already takes -- ``host`` is the dispatch-side host seconds carried on
  the in-flight step, the drain's wait on the step's CUDA event is the
  device-bound share, and the remainder of the inter-drain wall is
  input wait.  The device-bound share is split compute : exposed-comm
  by the cost model's predicted ratio (a host cannot see inside one
  event wait; a ``torch.profiler`` capture -- see
  ``observe/profiler_capture.py`` -- is the ground truth on the card).
- **Predicted** (``phase_predicted_*``): a deterministic cost model --
  the program's FLOPs (``hapi/model_stat.program_flops``) over
  ``FLAGS_device_peak_tflops``, plus per-collective byte transfer times
  over ``FLAGS_phase_interconnect_gbps``.  Both flags default to 0 in
  the port: at a peak of 0 there is no predicted split, and at a
  bandwidth of 0 collectives are left unpriced.  At one process the
  port's collectives are the one-rank ``c_*`` identities, so
  ``comm_exposed`` is 0 whatever the bandwidth says of their bytes'
  prediction.

The **collective ledger** prices every collective individually, keyed
by its ``__comm_id__`` op attr (else ``<op type>:<first input>``):
per-key ``exposed_s`` vs ``hidden_s``.  Cumulative totals ride
``/metrics`` as ``comm_exposed_seconds_micro`` /
``comm_hidden_seconds_micro`` / ``comm_exposed_share_ppm``.

Pure observer: gated by ``FLAGS_phase_attribution`` (no lowering
effect) and fed only from timestamps the drain path already takes.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ..framework import flags as _flags
from ..monitor import stat_add, stat_set

__all__ = ["PhasePlan", "PhaseEngine", "phase_engine", "build_phase_plan",
           "collective_inventory", "on_step_drained", "phases_report",
           "reset_phases"]

_MICRO = 1e6

# measured bucket names, in report order; fractions are published as
# phase_<bucket>_fraction_ppm and totals as phase_<bucket>_seconds_micro
BUCKETS = ("compute", "comm_exposed", "host", "input_wait")

# the ops the inventory prices (the JAX executor's COLLECTIVE_OPS)
COLLECTIVE_OPS = {"c_allreduce_sum", "c_allreduce_max", "c_allreduce_min",
                  "c_allreduce_prod", "allreduce", "mp_allreduce_sum",
                  "c_broadcast", "c_allgather", "c_reducescatter",
                  "c_reduce_sum", "c_reduce_max", "c_reduce_min",
                  "c_scatter", "c_concat", "c_split", "c_shard_slice",
                  "send_v2", "partial_send", "recv_v2", "partial_recv",
                  "barrier"}

# op attrs the JAX package's passes stamp on collectives (FuseAllReducePass,
# LayerScanPass); a program built for either package may carry them
COMM_ID_ATTR = "__comm_id__"
COMM_OVERLAP_ATTR = "__comm_overlap__"
LAYER_STACK_ATTR = "__layer_stack__"


# ---------------------------------------------------------------------------
# compile-time collective inventory
# ---------------------------------------------------------------------------


def collective_inventory(block, op_list, mesh=None, tp_plan=None,
                         cm_chunks: int = 0,
                         moe_chunks: int = 0) -> List[dict]:
    """Per-collective entries from the post-pass op stream, in program
    order: ``{"id", "op", "dtype", "bytes", "overlap"}``.

    A LayerScanPass-stacked collective moves ``__layer_stack__`` x its
    var's declared bytes.  The JAX signature's ``mesh``/``tp_plan``
    (mp-sharded reduces, the plan's implicit grad reduces) and
    ``cm_chunks``/``moe_chunks`` (collective-matmul and expert-parallel
    chunks) act only over a device mesh, which the port does not have: a
    mesh or a plan is refused, and the chunk counts change nothing at
    one process, as in the JAX package without a mesh."""
    from ..framework import dtypes as _dtypes
    from .xla_stats import _itemsize

    if mesh is not None or tp_plan is not None:
        raise NotImplementedError(
            "a device mesh or a sharding plan waits for ROADMAP Queue A "
            "item 8: the PyTorch port runs one card")

    def _var_bytes(name):
        var = block._find_var_recursive(name)
        if var is None or not var.shape or any(int(s) <= 0
                                               for s in var.shape):
            return 0, ""
        try:
            dt = _dtypes.to_str(var.dtype)
            itemsize = _itemsize(dt)
        except (KeyError, ValueError, TypeError):
            return 0, ""
        n = 1
        for s in var.shape:
            n *= int(s)
        return n * itemsize, dt

    entries: List[dict] = []
    for op in op_list:
        if op.type not in COLLECTIVE_OPS:
            continue
        names = op.input_arg_names()
        if not names:
            continue
        nbytes, dt = _var_bytes(names[0])
        if not nbytes:
            continue
        stack = max(int(op.attr(LAYER_STACK_ATTR, 0) or 0), 1)
        nbytes *= stack
        comm_id = str(op.attr(COMM_ID_ATTR, "") or "") \
            or f"{op.type}:{names[0]}"
        entries.append({
            "id": comm_id,
            "op": op.type,
            "dtype": dt,
            "bytes": int(nbytes),
            "overlap": bool(op.attr(COMM_OVERLAP_ATTR, False)),
        })
    return entries


class PhasePlan:
    """Deterministic per-step cost model for one compiled program:
    predicted compute seconds + per-collective exposed/hidden seconds.

    The overlap model is a single hide-under-compute walk in program
    order: an overlap-stamped collective hides ``min(its transfer
    time, remaining compute budget)``; everything else (and any
    overflow) is exposed.  Inputs are all static — IR FLOPs, declared
    var bytes, two flags — so tier-1 CPU runs reproduce the same
    fractions every time (the "deterministic predicted phases" half of
    the contract; real-device refinement is the profiler capture's
    job)."""

    def __init__(self, flops_per_step: float, collectives: List[dict]):
        self.flops_per_step = float(flops_per_step or 0.0)
        self.collectives = list(collectives)
        self._recost()

    def _recost(self) -> None:
        peak = float(_flags.flag("device_peak_tflops") or 0.0) * 1e12
        bw = float(_flags.flag("phase_interconnect_gbps") or 0.0) * 1e9
        self.compute_s = (self.flops_per_step / peak) if peak > 0 else 0.0
        budget = self.compute_s
        self.comm_exposed_s = 0.0
        self.comm_hidden_s = 0.0
        self.ledger: List[dict] = []
        per_id: Dict[str, dict] = {}
        for c in self.collectives:
            t = (c["bytes"] / bw) if bw > 0 else 0.0
            if c.get("overlap"):
                hidden = min(t, budget)
                budget -= hidden
            else:
                hidden = 0.0
            exposed = t - hidden
            self.comm_exposed_s += exposed
            self.comm_hidden_s += hidden
            row = per_id.get(c["id"])
            if row is None:
                row = per_id[c["id"]] = {
                    "id": c["id"], "op": c["op"], "dtype": c["dtype"],
                    "bytes_per_step": 0, "exposed_s": 0.0, "hidden_s": 0.0,
                    "overlap": bool(c.get("overlap"))}
                self.ledger.append(row)
            row["bytes_per_step"] += int(c["bytes"])
            row["exposed_s"] += exposed
            row["hidden_s"] += hidden

    def update_flops(self, flops_per_step: float) -> None:
        """Re-cost with another FLOP count for the step."""
        self.flops_per_step = float(flops_per_step or 0.0)
        self._recost()

    # -- reading ---------------------------------------------------------
    @property
    def predicted_step_s(self) -> float:
        return self.compute_s + self.comm_exposed_s

    def predicted_fractions(self) -> Dict[str, float]:
        total = self.predicted_step_s
        if total <= 0.0:
            return {"compute": 0.0, "comm_exposed": 0.0}
        return {"compute": self.compute_s / total,
                "comm_exposed": self.comm_exposed_s / total}

    def to_dict(self) -> Dict:
        return {
            "flops_per_step": self.flops_per_step,
            "compute_s": self.compute_s,
            "comm_exposed_s": self.comm_exposed_s,
            "comm_hidden_s": self.comm_hidden_s,
            "predicted_step_s": self.predicted_step_s,
            "predicted_fractions": self.predicted_fractions(),
            "ledger": [dict(r) for r in self.ledger],
        }


def build_phase_plan(block, op_list, mesh=None, tp_plan=None,
                     flops_per_step: float = 0.0,
                     cm_chunks: int = 0,
                     moe_chunks: int = 0) -> Optional["PhasePlan"]:
    """Build a :class:`PhasePlan` for one compiled program (called at a
    key's first run, ``Executor._entry``); None when attribution is
    off.  Never raises
    — a cost-model failure must not fail a compile."""
    if not _flags.flag("phase_attribution"):
        return None
    try:
        inv = collective_inventory(block, op_list, mesh=mesh,
                                   tp_plan=tp_plan, cm_chunks=cm_chunks,
                                   moe_chunks=moe_chunks)
        return PhasePlan(flops_per_step, inv)
    except Exception:  # noqa: BLE001 - telemetry only
        stat_add("phase_plan_errors")
        return None


# ---------------------------------------------------------------------------
# the engine: per-drain decomposition + cumulative ledger
# ---------------------------------------------------------------------------


class PhaseEngine:
    """Accumulates the four-bucket split + collective ledger across
    drained steps; one instance per process (the executor drain feeds
    the module singleton; tests may build their own)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._zero()

    def _zero(self):
        self.steps = 0
        self.totals = {b: 0.0 for b in BUCKETS}
        self.ledger: Dict[str, dict] = {}
        self.last_plan: Optional[PhasePlan] = None

    # -- feeding (executor window drain) ---------------------------------
    def on_step_drained(self, wall_s: float, sync_s: float, host_s: float,
                        steps: int = 1, plan: Optional[PhasePlan] = None,
                        compiled: bool = False) -> Optional[Dict[str, float]]:
        """Decompose one drained step's inter-drain wall time; returns
        the per-bucket seconds (None when skipped).  Compile steps
        (``compiled``: a key's warm-up and capture) are skipped like
        the StepTimer's histogram — a capture is not a phase profile.
        The four buckets sum
        exactly to ``wall_s`` by construction."""
        if not _flags.flag("phase_attribution") or compiled:
            return None
        wall = max(float(wall_s), 0.0)
        host = min(max(float(host_s), 0.0), wall)
        rest = wall - host
        sync = min(max(float(sync_s), 0.0), rest)
        input_wait = rest - sync
        # the drain block is device-bound time; split it compute vs
        # exposed comm by the model's predicted ratio (all-compute when
        # the model has nothing to say — no collectives, no flags)
        comm_frac = 0.0
        if plan is not None and plan.predicted_step_s > 0.0:
            comm_frac = plan.comm_exposed_s / plan.predicted_step_s
        comm = sync * comm_frac
        compute = sync - comm
        split = {"compute": compute, "comm_exposed": comm, "host": host,
                 "input_wait": input_wait}
        with self._lock:
            self.steps += int(steps)
            for k, v in split.items():
                self.totals[k] += v
            if plan is not None:
                self.last_plan = plan
                n = max(int(steps), 1)
                for row in plan.ledger:
                    agg = self.ledger.get(row["id"])
                    if agg is None:
                        agg = self.ledger[row["id"]] = {
                            "id": row["id"], "op": row["op"],
                            "dtype": row["dtype"],
                            "bytes_per_step": row["bytes_per_step"],
                            "overlap": row["overlap"],
                            "calls": 0, "exposed_s": 0.0, "hidden_s": 0.0}
                    agg["calls"] += n
                    agg["exposed_s"] += row["exposed_s"] * n
                    agg["hidden_s"] += row["hidden_s"] * n
            self._publish_locked()
        stat_add("phase_steps_attributed", int(steps))
        return split

    def _publish_locked(self) -> None:
        wall = sum(self.totals.values())
        for b in BUCKETS:
            stat_set(f"phase_{b}_seconds_micro",
                     int(self.totals[b] * _MICRO))
            stat_set(f"phase_{b}_fraction_ppm",
                     int(self.totals[b] / wall * 1e6) if wall > 0 else 0)
        if self.last_plan is not None:
            pf = self.last_plan.predicted_fractions()
            stat_set("phase_predicted_compute_fraction_ppm",
                     int(pf["compute"] * 1e6))
            stat_set("phase_predicted_comm_fraction_ppm",
                     int(pf["comm_exposed"] * 1e6))
        exposed = sum(r["exposed_s"] for r in self.ledger.values())
        hidden = sum(r["hidden_s"] for r in self.ledger.values())
        stat_set("comm_exposed_seconds_micro", int(exposed * _MICRO))
        stat_set("comm_hidden_seconds_micro", int(hidden * _MICRO))
        total = exposed + hidden
        stat_set("comm_exposed_share_ppm",
                 int(exposed / total * 1e6) if total > 0 else 0)

    # -- reading ---------------------------------------------------------
    def report(self) -> Dict:
        """The ``phases.json`` document: measured totals + fractions,
        the latest plan's predicted split, and the cumulative
        per-collective ledger sorted by exposed seconds."""
        with self._lock:
            wall = sum(self.totals.values())
            out: Dict = {
                "steps": self.steps,
                "wall_s": round(wall, 6),
                "measured_s": {b: round(self.totals[b], 6)
                               for b in BUCKETS},
                "measured_fractions": {
                    b: round(self.totals[b] / wall, 6) if wall > 0 else 0.0
                    for b in BUCKETS},
                "ledger": sorted(
                    (dict(r) for r in self.ledger.values()),
                    key=lambda r: -r["exposed_s"]),
            }
            exposed = sum(r["exposed_s"] for r in self.ledger.values())
            hidden = sum(r["hidden_s"] for r in self.ledger.values())
            out["comm_exposed_s"] = round(exposed, 6)
            out["comm_hidden_s"] = round(hidden, 6)
            out["comm_exposed_share"] = round(
                exposed / (exposed + hidden), 6) \
                if (exposed + hidden) > 0 else 0.0
            if self.last_plan is not None:
                out["predicted"] = self.last_plan.to_dict()
        return out

    def comm_exposed_share(self) -> float:
        """Exposed fraction of all priced comm, 0..1 (the heartbeat
        field behind the cluster straggler *cause* column)."""
        with self._lock:
            exposed = sum(r["exposed_s"] for r in self.ledger.values())
            hidden = sum(r["hidden_s"] for r in self.ledger.values())
        total = exposed + hidden
        return exposed / total if total > 0 else 0.0

    def reset(self) -> None:
        with self._lock:
            self._zero()
            self._publish_locked()


_ENGINE = PhaseEngine()


def phase_engine() -> PhaseEngine:
    return _ENGINE


def on_step_drained(wall_s: float, sync_s: float, host_s: float,
                    steps: int = 1, plan: Optional[PhasePlan] = None,
                    compiled: bool = False) -> None:
    """Drain-path hook (framework/executor.py): never raises — the
    attribution plane must not be able to fail a training step."""
    try:
        _ENGINE.on_step_drained(wall_s, sync_s, host_s, steps=steps,
                                plan=plan, compiled=compiled)
    except Exception:  # noqa: BLE001 - observer only
        stat_add("phase_attribution_errors")


def phases_report() -> Dict:
    return _ENGINE.report()


def reset_phases() -> None:
    _ENGINE.reset()
