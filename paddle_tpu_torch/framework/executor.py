"""Executor: runs a program's global block on one device, compiled once
per shape and replayed.

Counterpart of ``paddle_tpu/framework/executor.py``, with the same
``run(program, feed, fetch_list, scope, return_numpy)``,
``run_steps(..., steps)``, ``warmup(program, feed_specs, fetch_list,
scope)`` and ``run_persistent(fn, state_names, args, scope)`` contract.
The JAX executor traces the block once into one jitted XLA computation
per key; this one keeps one compiled step (``_Entry``, the counterpart
of ``_Compiled``) per key, and on the card that step is a CUDA graph
(``framework/graphs.py``):

- **The key** is the pass-rewritten program's fingerprint, the feeds'
  shapes and dtypes, the fetch names, the state's shapes and dtypes, the
  scope, the device and the lowering flags (``FLAGS_flash_attention``,
  ``FLAGS_weight_quant``, ``FLAGS_fuse_passes``,
  ``FLAGS_moe_alltoall_chunks``).  The scope joins the
  key because the graph's state buffers are that scope's tensors.
  ``executor_compile``, ``executor_cache_hit`` and ``executor_run`` move
  as in the JAX package.
- **On the card**, a key's first run is eager (the warm-up torch needs
  before a capture, the JAX package's "first call traces"); its second
  captures the block into a graph and replays it once; every later run
  copies the feeds into the graph's static buffers and replays.
- **State** is the port's form of donation: the scope holds the graph's
  state tensors, and the graph writes each new state value back into
  them in place.  A scope var that was rebound since (``set_var``, a
  load, the startup, an eager run) is found by identity and copied into
  its buffer before the replay; the RNG generator likewise.  A caller
  who keeps a state tensor across a step sees it change, as a donated
  JAX array is gone.
- **Fetches** are copies: the next replay rewrites the graph's outputs.
- **Eager for a reason.**  A program runs eagerly only for a reason
  found in its op list (``capture_reason``): a random op with a fixed
  nonzero ``seed`` (it seeds a fresh generator on each call, which a
  replay could not repeat), host I/O, a ``print`` op (it writes its
  value to the host's stdout at each run), control flow (``while``,
  ``conditional_block``, ``cond_pair`` and the tensor-array index ops
  read a value on the host to choose what runs: a graph cannot branch on
  data), a shape tensor (``reshape2`` / ``fill_constant`` reading their
  shape from a tensor), a ``py_func`` or an op whose CUDA library call
  synchronizes with the host (``inverse`` and its gradient: torch.linalg's
  batched LU).  Each such run counts
  ``executor_eager_<kind>`` and runs in an ``executor/eager`` span that
  names the reason.  A capture or replay that fails raises; nothing
  falls back.
- **Last-use frees.**  The block drops each value from its environment
  after the op that uses it last (not a feed, not state written back,
  not a fetch), as the reference's eager garbage collection and XLA's
  buffer reuse do: eagerly the memory returns to the allocator, under
  capture to the graph's private pool.  A block holding an op that owns
  a sub-block frees nothing.  On the CPU (``CPUPlace()``, the kernels'
  plain versions) an entry is the plan without a graph.

Other behaviour, as in the JAX package:

- feeds are coerced to their declared dtypes (int64 stays int64);
- a static use/def walk finds the state the block reads from the scope
  (parameters, optimizer slots; what a sub-block reads counts as a read
  of the op that owns it) and raises, naming the op and where it
  was built, when the startup program has not initialized it;
- outputs that persist (persistable vars, or names already in the scope)
  are written back to the scope after the block;
- random ops draw from one ``torch.Generator`` on the device, kept in the
  scope under ``RNG_VAR`` and seeded from ``program.random_seed`` the
  first time a program runs in that scope (a nonzero ``seed`` attr wins,
  see ``ops/common.op_generator``).

Pipelined dispatch (``FLAGS_max_inflight_steps``, default 2), as in the
JAX package: ``run`` and ``run_steps`` return a lazy :class:`StepHandle`
(a ``list``) and up to that many steps stay in flight; a dispatch at the
cap drains the oldest.  A step's fetches are its own copies (the next
replay rewrites the graph's outputs); with ``return_numpy=True`` their
device-to-host copies are issued without blocking into pinned memory,
and a ``torch.cuda.Event`` recorded after them marks the step's end.  A
drain waits on that event only (never ``torch.cuda.synchronize()``,
which would also wait for other work of the process, a decode replica's
stream included), records the step into ``observe/step_stats`` with the
wall time since the previous drain, moves ``executor_steps_drained``
and ``fetch_sync_seconds``, and checks the NaN scan's flags.  Reading an
item of a handle drains through its step; ``drain``, ``close``,
``warmup``, host I/O programs and checkpoint snapshots drain everything
first.  ``FLAGS_max_inflight_steps=0`` keeps the synchronous path, where
``run`` returns after its fetches reached the host and records its step
there; a key's warm-up run and its capture count as compiles either way.

The rest of ``run``, as in the JAX package: ``use_prune=True`` runs only
the ops the fetches need (``_prune_ops``, cached per fingerprint and
fetches; the pruned program's fingerprint keys its compiled step);
``FLAGS_benchmark`` syncs every run; ``FLAGS_check_nan_inf`` computes one
finite flag per floating op output on the device, inside the captured
step, fetched as one tensor (``NAN_FLAGS_VAR``) and checked at the
drain, which raises naming the op; auto-checkpoint
(``PADDLE_RUNNING_ENV=PADDLE_EDL_AUTO_CHECKPOINT`` or
``incubate.checkpoint.auto_checkpoint.configure``) resumes before and
saves after each fed run.

``run_steps`` runs the entry K times, with the fetches stacked on a
leading K dimension.  Host I/O programs (``save``/``load``/
``save_combine``/``load_combine`` ops, built by ``fluid.io``) are
interpreted on the host: ``framework/var_io.py`` writes and reads the
files, and loaded values go straight to the executor's device.

Several processes (a live ``torch.distributed`` group,
``distributed/parallel_env.py``): each rank runs its own program on its
own card, the feeds its own slice of the batch, and the program's
``c_*`` ops call the group (``ops/collective.py``).  The fetches follow
the JAX executor's ``step_once``, from the same static dp-variance
analysis (``dp_varying``): a feed with a batch dim above 1 varies across
ranks, an op with a varying input makes its outputs vary, and an
allreduce, broadcast or allgather (``_CLEARING``) or the split-back of a
fused allreduced buffer makes them the same again.  A fetch that is the
same on every rank is the local copy, a varying scalar is the cross-rank
mean, a varying batched value is all-gathered on dim 0, and the NaN
flags are the cross-rank minimum.  Under NCCL a program holding
collectives is captured like any other (NCCL calls on the step's stream
are legal in a CUDA graph); under gloo a collective is a host call, so
``capture_reason`` gives ``host_collective`` and the program runs
eagerly, as does any program holding a ``barrier`` op.  Each collective
op runs in a ``collective/<type>`` span with its bytes, and the step
timer counts the post-pass program's allreduce bytes a step.

ZeRO-1 (``__sharded_accumulators__`` on a program's optimizer ops, from
``fleet``'s ``ShardingMetaOptimizer``): the startup creates every
accumulator at full shape on each rank; before a dispatch reads the
state (``_prepare_state``), each such scope var still at its declared
dim 0 is cut to this rank's rows ``[r*d0/n, (r+1)*d0/n)`` and the full
tensor freed, and the scope records the block's global shape and origin
(``Scope.zero_blocks``), from which a checkpoint snapshot writes it as a
``ckpt.LocalShard``.  A restored full value is cut again at the next
dispatch, at the rank count of that run: a checkpoint resumes at any
rank count.  A fetch of such a var is all-gathered, as any batched
dp-varying fetch.  LocalSGD (``program._localsgd``): after each ``run``
of the main program, ``average_step`` runs the average program every
``k_steps`` runs; ``run_steps`` refuses such a program, as in the JAX
package.  Its ranks train apart between averages, so its fetches are
this rank's own values, and the main program, holding no collective, is
captured at each rank even under gloo.

Not in the port yet (each raises ``NotImplementedError`` when asked for):
meshes and tensor parallelism, and pipeline programs.

Observability, as in the JAX package, all of it a pure observer (losses
and fetches are bit-equal with every flag of it on or off): each drain
feeds ``observe/phases.py`` (the step's inter-drain wall, its wait on
the event and the dispatch-side host seconds carried on the in-flight
step, the wait for backpressure left out) and
``observe/profiler_capture.py``'s anomaly trigger.  A key's first run
prices its phase plan (``program_flops`` over
``FLAGS_device_peak_tflops``), estimates its footprint (state and
feeds, plus the peak of the live temporaries in the free plan's order
at the run's shapes) and puts it to ``FLAGS_hbm_budget_fraction``'s gate
before anything launches (``observe/xla_stats.py``; a rejected key is
not cached); on the card its warm-up reads the caching allocator after
each op, and once its step is captured (its first run on the CPU or
when it runs eagerly) ``xla_stats.on_compile`` records it.  A
constructed Executor records run metadata and ``executor/created`` to
the flight recorder and starts the stall watchdog
(``FLAGS_stall_timeout_s``) and continuous profiling
(``FLAGS_prof_continuous_s``) when their flags ask for them; the key's
warm-up and capture count as a compile in flight for the watchdog
(``_ACTIVE_COMPILES``).

Graph passes: before a program's block runs, ``_apply_graph_passes``
hands it to the ``framework/passes.py`` pipeline (attention-chain fusion
to ``flash_attention``, redundant-cast and dead-op elimination), which
rewrites a clone and leaves the caller's program as built, cached per
(fingerprint, pass list, fetch and feed names, scope, and the pass
flags); ``FLAGS_fuse_passes=0`` runs the program as built, but for
scan-over-layers, which answers to its own flag and stamps.  A
layer-scanned program's per-layer state lives in ``@LAYER_STACK@``
carriers: ``LayerScanPlan.ensure_stacked`` packs it before each
dispatch's analysis, and a member the block reads or writes (a
``StackedParamRef`` in the scope) is its carrier's slice in the step,
never a state buffer of its own.  State read
from the scope reaches the device with its own dtype, never cast to the
var's declared one: a float8 weight-quant carrier is declared ``int8``
in the block (the IR has no float8 type) and the op's ``mode`` attr says
what it holds.
"""
from __future__ import annotations

import collections
import os
import sys
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import dtypes
from ..monitor import stat_add, stat_max, stat_set
from ..observe import flight as _flight
from ..observe import health as _health
from ..observe import phases as _phases
from ..observe import profiler_capture as _prof
from ..observe import step_stats
from ..observe import tracer as otrace
from ..observe import xla_stats as _xla_stats
from . import passes as passes_mod
from .flags import flag
from .graphs import StepGraph
from .lowering import PSEUDO_OPS, LoweringContext, get_lowering
from .place import Place, _default_place
from .program import Program, Variable, default_main_program
from .scope import (Scope, StackedParamRef, global_scope, to_numpy,
                    to_tensor)

RNG_VAR = "@RNG_KEY@"
NAN_FLAGS_VAR = "@NAN_FLAGS@"

# ops the JAX executor runs host-side (file I/O)
HOST_OPS = {"save", "load", "save_combine", "load_combine"}

# ops whose effect is not visible through their outputs (p2p send/recv
# pairs match POSITIONALLY per ring, so dropping either end corrupts the
# pairing; barrier is a rendezvous; print emits a host debug callback) --
# the pass-pipeline DCE must never slice them away
SIDE_EFFECT_OPS = {"send_v2", "partial_send", "recv_v2", "partial_recv",
                   "barrier", "print"}

# communication ops (the JAX executor's set, kept with the phase model's
# inventory): each lowering runs in a tracer span of its own with its
# payload's bytes and dtype, and the allreduce subset feeds the step
# timer's bytes a step
COLLECTIVE_OPS = _phases.COLLECTIVE_OPS
_ALLREDUCE_OPS = {"c_allreduce_sum", "c_allreduce_max", "c_allreduce_min",
                  "c_allreduce_prod", "allreduce", "mp_allreduce_sum"}
# collective ops whose lowering takes only this rank's tile: no traffic
_LOCAL_COLLECTIVES = {"c_split", "c_shard_slice"}
# ops after which a value is the same on every rank (the JAX executor's
# dp-variance analysis)
_CLEARING = {"c_allreduce_sum", "c_allreduce_max", "c_allreduce_min",
             "c_allreduce_prod", "c_broadcast", "c_allgather", "allreduce"}


def _later(what: str):
    return NotImplementedError(
        f"{what} is not in the PyTorch port's executor yet: it comes with "
        f"a later slice of the port")


def _feed_tensors(block, feed: Dict, device: torch.device):
    """Feeds as tensors on ``device``.  Host arrays are cast to the var's
    declared dtype; tensors keep theirs, as the JAX executor keeps device
    arrays untouched."""
    out = {}
    for name in sorted(feed):
        val = feed[name]
        var = block._find_var_recursive(name)
        want = dtypes.to_str(var.dtype) if var is not None and var.dtype \
            else None
        if not isinstance(val, torch.Tensor):
            val = np.asarray(val)
            if want is not None and want != "bfloat16" \
                    and val.dtype != np.dtype(want):
                val = val.astype(want)
            val = to_tensor(val)
            if want is not None and val.dtype != dtypes.to_torch(want):
                val = val.to(dtypes.to_torch(want))
        out[name] = val.to(device, non_blocking=True)
    return out


# ops whose lowering reads a value on the host to decide what runs: a
# branch or a loop's trip count, a tensor array's index
CONTROL_FLOW_OPS = {"while", "conditional_block", "cond_pair",
                    "write_to_array", "read_from_array"}

SUB_BLOCK_ATTRS = ("sub_block", "sub_block_t", "sub_block_f")

# ops whose CUDA library call synchronizes with the host inside it, which a
# graph cannot capture: torch.linalg's batched LU (MAGMA, or cuSOLVER
# matrix by matrix), which ``inverse`` and its gradient run
HOST_SYNC_OPS = {"inverse", "inverse_grad"}


def capture_reason(program: Program) -> Optional[Tuple[str, str]]:
    """Why ``program`` cannot run as a captured graph, from its op list
    and the live process group's backend: ``(kind, text)``, or None when
    it can.  ``kind`` names the ``executor_eager_<kind>`` counter its
    runs move."""
    from ..distributed.parallel_env import backend

    group = backend()
    for op in program.global_block.ops:
        if group is not None and op.type in COLLECTIVE_OPS \
                and op.type not in _LOCAL_COLLECTIVES:
            if group == "gloo":
                return ("host_collective",
                        f"op {op.type!r} calls the gloo process group, a "
                        f"host library: a host call at each run, which a "
                        f"graph cannot hold")
            if op.type == "barrier":
                return ("host_collective",
                        "op 'barrier' waits on the host for every rank "
                        "at each run, which a graph cannot hold")
        if op.type in HOST_OPS:
            return ("host_io", f"op {op.type!r} reads or writes files on "
                               f"the host")
        if op.type == "print":
            return ("print", "op 'print' writes its value to the host's "
                             "stdout at each run, which a replay would not "
                             "repeat")
        if op.type in CONTROL_FLOW_OPS:
            return ("control_flow",
                    f"op {op.type!r} reads a value on the host to choose "
                    f"what runs, which a graph cannot branch on")
        if op.type == "py_func":
            return ("py_func", "op 'py_func' calls a Python function on "
                               "the host at each run")
        if op.type in HOST_SYNC_OPS:
            return ("host_sync", f"op {op.type!r} runs a CUDA library call "
                                 f"that synchronizes with the host, which a "
                                 f"graph cannot capture")
        if (op.type in ("reshape", "reshape2")
                and (op.inputs.get("ShapeTensor") or op.inputs.get("Shape"))) \
                or (op.type == "fill_constant"
                    and (op.inputs.get("ShapeTensor")
                         or op.inputs.get("ShapeTensorList"))):
            return ("shape_tensor",
                    f"op {op.type!r} takes its shape from a tensor, read on "
                    f"the host at each run")
        if op.type in ("crop", "crop_tensor") and op.inputs.get("Offsets"):
            return ("shape_tensor",
                    f"op {op.type!r} takes its offsets from a tensor, read "
                    f"on the host at each run")
        if op.type == "sequence_slice":
            return ("shape_tensor",
                    "op 'sequence_slice' takes its offset and length from "
                    "tensors, read on the host at each run")
        if op.type == "affine_grid" and op.inputs.get("OutputShape"):
            return ("shape_tensor",
                    "op 'affine_grid' takes its output shape from a tensor, "
                    "read on the host at each run")
        seed = int(op.attr("seed", 0) or 0)
        if seed:
            return ("seeded_random",
                    f"op {op.type!r} has seed={seed}: it draws from a "
                    f"generator seeded afresh at each call, which a replay "
                    f"cannot repeat")
    return None


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


@dataclass
class _Entry:
    """One compiled step (the JAX package's ``_Compiled``): the block's
    state analysis and free plan, the reason it runs eagerly if it must,
    and on the card its graph once captured."""
    program: Program
    fetch_names: Tuple[str, ...]
    state_in: Tuple[str, ...]
    state_out: Tuple[str, ...]
    frees: Tuple[Tuple[str, ...], ...]
    eager_reason: Optional[Tuple[str, str]]
    batch: int = 0                        # the first feed's leading dim
    flops_per_step: float = 0.0           # program_flops at that batch
    runs: int = 0                         # warmup's included
    phase_plan: Optional[object] = None   # observe/phases.PhasePlan
    # the pre-launch footprint estimate, the budget gate's verdict on it,
    # the size entries it was judged on, and the warm-up's allocator
    # reading (observe/xla_stats.memory_breakdown)
    estimated_bytes: int = 0
    budget: Optional[dict] = None
    size_entries: Tuple[tuple, ...] = ()
    memory: Optional[dict] = None
    nan_scan: bool = False                # FLAGS_check_nan_inf at compile
    # (op type, build site, index in the block) per scanned op, in the
    # order of the NAN_FLAGS_VAR fetch
    nan_ops: Tuple[Tuple[str, str, int], ...] = ()
    # with a live process group: the names whose values differ across
    # ranks (dp_varying), which decide how each fetch is assembled
    varying: Optional[frozenset] = None
    allreduce_bytes: int = 0              # the post-pass program's, a step
    step: Optional[StepGraph] = None      # on the card, from the 1st run
    graph: Optional["_GraphStep"] = None  # from the 2nd run


class _GraphStep:
    """An entry's captured graph and its static buffers: the feeds, the
    state it reads (the scope's own tensors), the state it only writes
    and the fetches (tensors of the graph's pool)."""

    def __init__(self, step: StepGraph, feeds, state, generator, seed):
        self.step = step
        self.feeds: Dict[str, torch.Tensor] = feeds
        self.state: Dict[str, torch.Tensor] = state
        self.generator = generator
        self.seed = seed
        self.written: Dict[str, torch.Tensor] = {}

    def bind(self, feeds, scope) -> None:
        """Copy the run's feeds, and every scope var rebound since the
        last run, into the graph's buffers."""
        for n, t in feeds.items():
            self.feeds[n].copy_(t)
        for n, buf in self.state.items():
            v = scope.get_var(n)
            if v is not buf:
                buf.copy_(v)
                scope.set_var(n, buf)
        gen = scope.get_var(RNG_VAR) if scope.has_var(RNG_VAR) else None
        if gen is None:   # the scope's first run: the program's seed
            self.generator.manual_seed(self.seed)
            scope.set_var(RNG_VAR, self.generator)
        elif gen is not self.generator:
            self.generator.set_state(gen.get_state())
            scope.set_var(RNG_VAR, self.generator)

    def replay(self, scope) -> List[torch.Tensor]:
        self.step.replay()
        for n, t in self.written.items():
            scope.set_var(n, t)
        return self.step.outputs


class _InflightStep:
    """One dispatched step of the window: its fetches on the device, their
    pinned host copies (``return_numpy=True`` on the card), the NaN
    scan's flags, and the event recorded after all of it."""

    __slots__ = ("fetches", "host", "nan_flags", "nan_ops", "event",
                 "t_dispatch", "steps", "examples", "compiled",
                 "flops_per_step", "scope", "drained", "host_s",
                 "phase_plan", "allreduce_bytes")

    def __init__(self, fetches, host, nan_flags, nan_ops, event,
                 t_dispatch, steps, examples, compiled, flops_per_step,
                 scope=None, host_s=0.0, phase_plan=None,
                 allreduce_bytes=0):
        self.fetches = fetches
        self.host = host
        self.nan_flags = nan_flags
        self.nan_ops = nan_ops
        self.event = event
        self.t_dispatch = t_dispatch
        self.steps = steps
        self.examples = examples
        self.compiled = compiled
        self.flops_per_step = flops_per_step
        self.scope = scope
        self.drained = False
        self.host_s = host_s
        self.phase_plan = phase_plan
        self.allreduce_bytes = allreduce_bytes


class _InflightWindow:
    """Bounded FIFO of in-flight steps (``FLAGS_max_inflight_steps``).

    Dispatch pushes; ``backpressure`` drains the oldest entries until the
    window is under the cap.  A drain waits on the step's event (the
    ``dispatch/drain`` span, ``fetch_sync_seconds``), feeds the step
    timer with the wall time since the previous drain (the loop's period
    in steady state), checks the NaN scan's flags and updates the
    ``executor_inflight_steps`` gauge.  A failure met on a drain that
    must not raise (``StepTimer.summary``'s) is parked and re-raised at
    the next raising drain point.  One re-entrant lock guards it all:
    the one-shot ``Server`` runs a ``Predictor`` on its batcher's
    thread."""

    def __init__(self):
        self._entries = collections.deque()
        self._lock = threading.RLock()
        self._last_drain: Optional[float] = None
        self._failed: Optional[BaseException] = None

    def __len__(self):
        with self._lock:
            return len(self._entries)

    def push(self, entry: _InflightStep):
        with self._lock:
            self._entries.append(entry)
        _update_inflight_gauge()

    def _raise_pending(self):
        if self._failed is not None:
            e, self._failed = self._failed, None
            raise e

    def backpressure(self, cap: int):
        """Block until fewer than ``cap`` steps are in flight."""
        with self._lock:
            self._raise_pending()
            while len(self._entries) >= max(cap, 1):
                self._drain_oldest()

    def drain_through(self, entry: _InflightStep):
        """Drain, in order, every entry up to and including ``entry``."""
        with self._lock:
            self._raise_pending()
            while not entry.drained and self._entries:
                self._drain_oldest()

    def drain_all(self, raise_errors: bool = True):
        """Drain everything; ``raise_errors=False`` parks a failure."""
        with self._lock:
            if raise_errors:
                self._raise_pending()
            while self._entries:
                self._drain_oldest(raise_errors=raise_errors)

    def _drain_oldest(self, raise_errors: bool = True):
        from ..observe.histogram import stat_time

        # the entry stays in the deque while its drain blocks
        e = self._entries[0]
        t0 = time.perf_counter()
        try:
            with otrace.span("dispatch/drain", steps=e.steps,
                             n=len(e.fetches)):
                if e.event is not None:
                    e.event.synchronize()
        except BaseException as err:
            # a drain that raises is still progress: the step is gone
            if raise_errors:
                raise
            if self._failed is None:
                self._failed = err
            return
        finally:
            self._entries.popleft()
            e.drained = True
            stat_add("executor_steps_drained", e.steps)
            _update_inflight_gauge()
        now = time.perf_counter()
        stat_time("fetch_sync_seconds", now - t0)
        start = e.t_dispatch if self._last_drain is None \
            else max(self._last_drain, e.t_dispatch)
        self._last_drain = now
        step_stats.step_timer().record_run(
            max(now - start, 0.0), steps=e.steps, examples=e.examples,
            compiled=e.compiled, flops_per_step=e.flops_per_step,
            allreduce_bytes_per_step=e.allreduce_bytes)
        # step-phase attribution and the anomaly trigger: wall = the
        # inter-drain loop period, sync = this drain's wait, host = the
        # dispatch-side host seconds carried on the step
        _phases.on_step_drained(
            wall_s=max(now - start, 0.0), sync_s=now - t0, host_s=e.host_s,
            steps=e.steps, plan=e.phase_plan, compiled=e.compiled)
        _prof.on_step_drained(max(now - start, 0.0) / max(e.steps, 1),
                              compiled=e.compiled)
        if e.nan_flags is not None:
            try:
                _raise_on_nan(e.nan_flags, e.nan_ops, e.scope)
            except BaseException as err:
                if raise_errors:
                    raise
                if self._failed is None:
                    self._failed = err


def _raise_on_nan(nan_flags, nan_ops, scope=None):
    """Host check of the NaN scan's flags (one per scanned op output,
    stacked on a leading step dimension by ``run_steps``): raise naming
    the first op whose output was not finite.  The scope that step wrote is marked,
    so no checkpoint is taken of it (``ckpt.snapshot_scope``) until a
    restore replaces its state."""
    if not nan_ops:
        return
    flags = to_numpy(nan_flags).astype(bool)
    ok = flags.reshape(-1, len(nan_ops)).all(axis=0)
    if not ok.all():
        op_type, site, i = min((nan_ops[j] for j in np.flatnonzero(~ok)),
                               key=lambda o: o[2])
        msg = (f"FLAGS_check_nan_inf: op {op_type!r} (built at {site}) "
               f"produced NaN/Inf (op #{i} of the compiled block)")
        if scope is not None:
            scope._nan_poisoned = msg
        raise RuntimeError(msg)


class StepHandle(list):
    """Lazy fetch list of one pipelined ``Executor.run``/``run_steps``.

    A ``list`` subclass, so indexing, iteration, unpacking and ``len``
    work as before, but the wait for the step is deferred: reading an
    item drains the executor's window through this step.  With
    ``materialize=True`` (``run(return_numpy=True)``) an item reads as a
    cached ``np.ndarray``; otherwise it is the step's device tensor.
    ``numpy()`` materializes everything; ``block_until_ready()`` waits
    without converting; ``device_arrays()`` returns the device tensors
    without waiting."""

    def __init__(self, fetches, window=None, entry=None, materialize=True):
        list.__init__(self, fetches)
        self._window = window
        self._entry = entry
        self._materialize = materialize

    def block_until_ready(self):
        """Wait for this step (and every older one in flight)."""
        if self._window is not None and self._entry is not None:
            self._window.drain_through(self._entry)
        return self

    def numpy(self):
        """Every fetch as host numpy (one wait); a plain list."""
        return [self._host(i) for i in range(list.__len__(self))]

    def device_arrays(self):
        """The stored values, no wait (device tensors until an item has
        been materialized through access)."""
        return list(list.__iter__(self))

    def _host(self, i):
        v = list.__getitem__(self, i)
        if isinstance(v, np.ndarray):
            return v
        self.block_until_ready()
        host = self._entry.host if self._entry is not None else None
        with otrace.span("executor/fetch", n=1):
            arr = to_numpy(host[i] if host is not None else v)
        if self._materialize:
            list.__setitem__(self, i, arr)
        return arr

    def _resolve(self, i):
        if self._materialize:
            return self._host(i)
        self.block_until_ready()
        return list.__getitem__(self, i)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return [self._resolve(i)
                    for i in range(*idx.indices(list.__len__(self)))]
        return self._resolve(idx)

    def __iter__(self):
        for i in range(list.__len__(self)):
            yield self._resolve(i)

    def __array__(self, dtype=None, copy=None):
        arr = np.asarray(self.numpy())
        return arr.astype(dtype) if dtype is not None else arr


# every constructed Executor, for the process-wide drain points
# (checkpoint snapshots, StepTimer.summary) and the stall watchdog
_LIVE_EXECUTORS: "weakref.WeakSet[Executor]" = weakref.WeakSet()

# thread id -> perf_counter start of a key's warm-up or capture in
# flight (observe/health.executor_progress reads it without a lock)
_ACTIVE_COMPILES: Dict[int, float] = {}


_GAUGE_LOCK = threading.Lock()


def _update_inflight_gauge():
    """``executor_inflight_steps`` = in-flight steps over every live
    Executor (deque lengths read without their windows' locks).  The
    read and the write are one step under ``_GAUGE_LOCK``: every change
    of a window is followed by an update, so the last update reads the
    last state, where a stale sum written late could otherwise stick."""
    with _GAUGE_LOCK:
        try:
            total = sum(len(exe._window._entries)
                        for exe in list(_LIVE_EXECUTORS))
        except RuntimeError:  # the WeakSet changed under a construction
            return
        stat_set("executor_inflight_steps", total)
        stat_max("executor_inflight_steps_max", total)


def drain_all(raise_errors: bool = True):
    """Drain the window of every live Executor (a checkpoint snapshot and
    a telemetry summary only ever see completed steps);
    ``raise_errors=False`` parks a failure for the next raising drain."""
    for exe in list(_LIVE_EXECUTORS):
        exe._window.drain_all(raise_errors=raise_errors)


def quiesce_all(raise_errors: bool = True):
    """Drain every live Executor's window and every pending asynchronous
    checkpoint save."""
    drain_all(raise_errors=raise_errors)
    from ..ckpt import wait_all as _ckpt_wait_all

    _ckpt_wait_all(raise_errors=raise_errors)


def close_all() -> int:
    """Close every live Executor (drain, then drop its caches); returns
    how many were closed."""
    n = 0
    for exe in list(_LIVE_EXECUTORS):
        try:
            exe.close()
        except Exception:  # noqa: BLE001 - a failing drain must not
            pass           # stop the others from closing
        _LIVE_EXECUTORS.discard(exe)
        n += 1
    _update_inflight_gauge()
    return n


def _acp_on() -> bool:
    """Whether auto-checkpoint hooks run: the environment asks for them,
    or ``auto_checkpoint.configure`` was called."""
    if os.environ.get("PADDLE_RUNNING_ENV") == "PADDLE_EDL_AUTO_CHECKPOINT":
        return True
    acp = sys.modules.get(
        "paddle_tpu_torch.incubate.checkpoint.auto_checkpoint")
    return acp is not None and acp._cfg is not None


class Executor:
    def __init__(self, place: Optional[Place] = None, mesh=None):
        if mesh is not None:
            raise _later("running over a device mesh")
        self.place = place if place is not None else _default_place()
        self.device = self.place.torch_device()
        # (program fingerprint, feed names, scope serial) -> (in, out)
        self._analysis_cache: Dict[tuple, tuple] = {}
        # (program fingerprint, feed and fetch names, scope serial) ->
        # per-op names dropped after it
        self._free_cache: Dict[tuple, tuple] = {}
        # (program fingerprint, pass config, fetch/feed names, scope
        # serial, pass flags) -> pass-rewritten program (or the original
        # when no pass applied)
        self._pass_cache: Dict[tuple, Program] = {}
        # the compiled-step cache (see the module docstring for the key)
        self._cache: Dict[tuple, _Entry] = {}
        # most values the last eager or captured block held at once
        self.env_peak = 0
        # (program fingerprint, fetch names) -> the pruned program
        self._prune_cache: Dict[tuple, Program] = {}
        # entries become graphs on the card; on the CPU they stay plans
        self._captures = self.device.type == "cuda"
        # the steps dispatched and not yet drained
        self._window = _InflightWindow()
        _LIVE_EXECUTORS.add(self)
        _flight.record_run_metadata()
        _flight.record("executor/created", place=type(self.place).__name__,
                       device=str(self.device))
        _health.maybe_start_watchdog()
        _prof.maybe_start_continuous()

    # ------------------------------------------------------------------
    def run(
        self,
        program: Optional[Program] = None,
        feed: Optional[Dict] = None,
        fetch_list: Optional[Sequence] = None,
        scope: Optional[Scope] = None,
        return_numpy: bool = True,
        use_program_cache: bool = True,  # always cached; kept for API parity
        use_prune: bool = False,
    ):
        program = program if program is not None else default_main_program()
        scope = scope if scope is not None else global_scope()
        fetch_names = _names(fetch_list)
        if any(op.type in HOST_OPS for op in program.global_block.ops):
            return self._run_host_ops(program, scope, fetch_names,
                                      return_numpy)
        acp = _acp_on()
        if acp:
            from ..incubate.checkpoint import auto_checkpoint as _acp

            _acp.maybe_resume(self, program, scope, fed=bool(feed))
        out = self._dispatch(program, feed, fetch_names, scope,
                             return_numpy, use_prune)
        # localsgd: the periodic cross-rank parameter average
        localsgd = getattr(program, "_localsgd", None)
        if localsgd is not None:
            localsgd.average_step(self, scope=scope)
        if acp:
            _acp.on_executor_run(self, program, scope, fed=bool(feed))
        return out

    def _dispatch(self, program, feed, fetch_names, scope, return_numpy,
                  use_prune):
        """One step of ``run``: pipelined into the window (a
        ``StepHandle``) when ``FLAGS_max_inflight_steps`` > 0, else
        synchronous (a list)."""
        cap = int(flag("max_inflight_steps"))
        if cap > 0:
            self._window.backpressure(cap)
        t0 = time.perf_counter()
        fetches, entry, t_exec0 = self._run(program, feed, fetch_names,
                                            scope, use_prune)
        if self._owns(entry):
            fetches = [_own(v) for v in fetches]
        return self._finish(entry, fetches, scope, return_numpy, t0, 1,
                            cap, t_exec0 - t0)

    def _finish(self, entry, fetches, scope, return_numpy, t0, n_steps,
                cap, host_s=0.0):
        """The dispatched step's fetches: into the window and a handle
        (``cap`` > 0), or waited for and recorded here.  ``host_s``: the
        host seconds from the dispatch (past backpressure) to the step's
        launch."""
        nan_flags = None
        if entry.nan_scan:
            nan_flags, fetches = fetches[-1], fetches[:-1]
        compiled = self._compiled(entry, n_steps)
        if cap > 0:
            host = None
            on_card = self.device.type == "cuda"
            if on_card and return_numpy:
                host = [_pinned_copy(v) if isinstance(v, torch.Tensor)
                        else v for v in fetches]
            if on_card and nan_flags is not None:
                nan_flags = _pinned_copy(nan_flags)
            event = None
            if on_card:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
            inflight = _InflightStep(
                fetches, host, nan_flags, entry.nan_ops, event, t0,
                n_steps, entry.batch * n_steps, compiled,
                entry.flops_per_step, scope, max(host_s, 0.0),
                entry.phase_plan, entry.allreduce_bytes)
            self._window.push(inflight)
            stat_add("executor_steps_dispatched", n_steps)
            if flag("benchmark") or entry.nan_scan:
                # per-call semantics: the recorded time is the step's,
                # and the scan raises inside the offending run
                self._window.drain_through(inflight)
            return StepHandle(fetches, window=self._window, entry=inflight,
                              materialize=return_numpy)
        if return_numpy:
            with otrace.span("executor/fetch", n=len(fetches)):
                fetches = [to_numpy(v) for v in fetches]
        elif flag("benchmark") and self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        stat_add("executor_steps_dispatched", n_steps)
        stat_add("executor_steps_drained", n_steps)
        step_stats.step_timer().record_run(
            time.perf_counter() - t0, steps=n_steps,
            examples=entry.batch * n_steps, compiled=compiled,
            flops_per_step=entry.flops_per_step,
            allreduce_bytes_per_step=entry.allreduce_bytes)
        if nan_flags is not None:
            _raise_on_nan(nan_flags, entry.nan_ops, scope)
        return list(fetches)

    def _run(self, program, feed, fetch_names, scope, use_prune=False):
        """One step: the pass pipeline, the pruning, the entry's lookup,
        its run.  Returns the fetches (the graph's own buffers when the
        entry is captured), the entry and the ``perf_counter`` time its
        run began."""
        self._refuse_left_out(program)
        # a localsgd program's ranks train apart between averages: its
        # fetches are this rank's own (a cross-rank mean would put a
        # collective in every step)
        local = getattr(program, "_localsgd", None) is not None
        feeds = _feed_tensors(program.global_block, dict(feed or {}),
                              self.device)
        program = self._apply_graph_passes(program, fetch_names, feeds,
                                           scope)
        self._prepare_state(program, scope)
        if use_prune and fetch_names:
            program = self._pruned(program, fetch_names)
        entry = self._entry(program, feeds, fetch_names, scope,
                            local_fetches=local)
        stat_add("executor_run")
        t_exec0 = time.perf_counter()
        return self._run_entry(entry, feeds, scope), entry, t_exec0

    # ------------------------------------------------------------------
    def run_steps(
        self,
        program: Optional[Program] = None,
        feed: Optional[Dict] = None,
        fetch_list: Optional[Sequence] = None,
        scope: Optional[Scope] = None,
        return_numpy: bool = False,
        steps: Optional[int] = None,
    ):
        """Run the program K times, back to back on the device.

        Two feed modes, as in the JAX package:
        - ``steps=None``: every feed carries a leading step dimension of
          equal extent K (one batch per step);
        - ``steps=K``: feeds are single-step shaped and the same batch is
          reused for all K steps.

        The feeds reach the device once, before the loop; the K steps
        are K runs of one entry (replays, once it is captured); each
        fetch comes back stacked with a leading K dim, as tensors by
        default.
        """
        program = program if program is not None else default_main_program()
        feed = dict(feed or {})
        if not feed:
            raise ValueError("run_steps requires at least one feed")
        scope = scope if scope is not None else global_scope()
        if getattr(program, "_localsgd", None) is not None:
            raise NotImplementedError(
                "run_steps does not support localsgd programs: the periodic "
                "parameter averaging hook runs between executor calls and "
                "would be skipped inside the K-step loop; use exe.run")
        self._refuse_left_out(program)
        cap = int(flag("max_inflight_steps"))
        if cap > 0:
            self._window.backpressure(cap)
        t0 = time.perf_counter()
        if steps is None:
            step_dims = {int(np.shape(v)[0]) for v in feed.values()}
            if len(step_dims) != 1:
                raise ValueError(
                    f"all run_steps feeds must share the same leading step "
                    f"dim; got {sorted(step_dims)}")
            n_steps = step_dims.pop()
            if n_steps == 0:
                raise ValueError("run_steps needs at least one step")
        else:
            if steps < 1:
                raise ValueError(f"steps must be >= 1, got {steps}")
            n_steps = int(steps)
        feeds = _feed_tensors(program.global_block, feed, self.device)
        fetch_names = _names(fetch_list)
        program = self._apply_graph_passes(program, fetch_names, feeds,
                                           scope)
        self._prepare_state(program, scope)
        entry = None
        for i in range(n_steps):
            step_feed = feeds if steps is not None else \
                {n: t[i] for n, t in feeds.items()}
            if entry is None:
                entry = self._entry(program, step_feed, fetch_names, scope)
                stat_add("executor_run")
                t_exec0 = time.perf_counter()
                # the entry's fetches: the NaN flags last when it scans
                per_step: List[List[torch.Tensor]] = \
                    [[] for _ in entry.fetch_names]
            for acc, v in zip(per_step,
                              self._run_entry(entry, step_feed, scope)):
                acc.append(_own(v) if self._owns(entry) else v)
        fetches = [torch.stack(vs) for vs in per_step]
        return self._finish(entry, fetches, scope, return_numpy, t0,
                            n_steps, cap, t_exec0 - t0)

    # ------------------------------------------------------------------
    def warmup(
        self,
        program: Optional[Program] = None,
        feed_specs: Optional[Sequence[Dict]] = None,
        fetch_list: Optional[Sequence] = None,
        scope: Optional[Scope] = None,
    ) -> int:
        """Compile one step per feed spec before traffic arrives (the
        serving layer's warm start).

        ``feed_specs`` is an iterable of feed descriptions: each one a
        dict mapping feed name -> ``(shape, dtype)`` (or a concrete
        array used as-is).  Every spec runs on zero-filled feeds through
        the normal cache path, on the card until its graph is captured,
        so later ``run`` calls with the same shapes replay.  The whole
        scope chain, the RNG generator's state included, is restored
        afterwards, even when a run raises: warmup is state-neutral.
        The graph passes run first, outside that window: what they write
        into the scope (the weight-quant pass's carriers and scales) is
        part of the cached rewritten program, not of a step's state, and
        stays.  Returns the number of entries freshly compiled (0 if
        every spec was already cached).
        """
        program = program if program is not None else default_main_program()
        scope = scope if scope is not None else global_scope()
        if fetch_list is None:
            names = getattr(program, "_fetch_names", None)
            if not names:
                raise ValueError(
                    "warmup needs fetch_list= (or a program that records "
                    "its fetch contract, e.g. via load_inference_model)")
            fetch_list = list(names)
        fetch_names = _names(fetch_list)
        # in-flight steps write the state in place: let them finish
        # before the scope is snapshotted
        self.drain()
        n0 = len(self._cache)
        for spec in (feed_specs or []):
            # the pass cache is keyed by the feed names, not their values;
            # the layer-scan carriers, like the weight-quant ones, stay
            self._prepare_state(self._apply_graph_passes(
                program, fetch_names, dict.fromkeys(spec), scope), scope)
        snapshots = []
        s = scope
        while s is not None:
            snapshots.append((s, dict(s._vars), {
                k: (v.clone() if isinstance(v, torch.Tensor) else
                    v.get_state() if isinstance(v, torch.Generator) else v)
                for k, v in s._vars.items()}))
            s = s._parent
        try:
            for spec in (feed_specs or []):
                feed = {}
                for name, sd in spec.items():
                    if isinstance(sd, (np.ndarray, torch.Tensor)):
                        feed[name] = sd
                    else:
                        shape, dtype = sd
                        feed[name] = np.zeros(
                            tuple(int(d) for d in shape), dtype)
                while True:
                    entry = self._run(program, feed, fetch_names, scope)[1]
                    if entry.eager_reason is not None or \
                            not self._captures or entry.graph is not None:
                        break
        finally:
            for s, held, snap in snapshots:
                s._vars.clear()
                for k, v in snap.items():
                    if isinstance(held[k], torch.Generator):
                        held[k].set_state(v)
                        v = held[k]
                    s._vars[k] = v
        return len(self._cache) - n0

    # ------------------------------------------------------------------
    def run_persistent(
        self,
        fn,
        state_names: Sequence[str],
        args: Sequence = (),
        scope: Optional[Scope] = None,
    ):
        """Run one step of an externally built function whose persistent
        state lives in ``scope`` as device tensors.

        ``fn(state_tuple, *args) -> (outputs, new_state_tuple)`` where
        ``state_tuple`` is the current value of every name in
        ``state_names`` (in order).  The caller owns capture, as the JAX
        caller owns ``jit`` (``framework/graphs.StepGraph`` captures a
        fixed-shape step).  After the call the scope holds the new state,
        and ``executor_run``, ``executor_steps_dispatched`` and
        ``executor_steps_drained`` move as for any other step.
        """
        scope = scope if scope is not None else global_scope()
        missing = [n for n in state_names if not scope.has_var(n)]
        if missing:
            raise KeyError(
                f"run_persistent state vars not in scope: {missing}")
        state = tuple(scope.get_var(n) for n in state_names)
        with otrace.span("executor/persistent", state=len(state)):
            outputs, new_state = fn(state, *args)
        if len(new_state) != len(state):
            raise ValueError(
                f"run_persistent fn returned {len(new_state)} state "
                f"values for {len(state)} state vars")
        for n, v in zip(state_names, new_state):
            scope.set_var(n, v)
        stat_add("executor_run")
        stat_add("executor_steps_dispatched")
        stat_add("executor_steps_drained")
        return outputs

    def drain(self):
        """Block until every in-flight step has completed: its telemetry
        recorded, its NaN flags checked, the scope quiescent.  A no-op
        when nothing is in flight."""
        self._window.drain_all()

    def close(self):
        """Drain the window and pending checkpoint saves, then drop every
        cache, the captured graphs with them (their pools go once the
        scopes let go of the state they hold)."""
        self.drain()
        from ..ckpt import wait_all as _ckpt_wait_all

        _ckpt_wait_all(raise_errors=False)
        self._prune_cache.clear()
        self._analysis_cache.clear()
        self._free_cache.clear()
        self._pass_cache.clear()
        self._cache.clear()

    # ------------------------------------------------------------------
    def _run_host_ops(self, program, scope, fetch_names, return_numpy):
        """Interpret a host I/O block (save/load programs).  A block that
        mixes compute and I/O is refused: build a separate save program,
        as ``fluid.io`` does.  Loaded values land on this executor's
        device."""
        from . import var_io

        # a save must see a quiescent pipeline (in-flight steps' NaN
        # checks fire before any file is written)
        self.drain()
        kind, why = capture_reason(program)
        stat_add("executor_eager_" + kind)
        with otrace.span("executor/eager", reason=why):
            for op in program.global_block.ops:
                if op.type in PSEUDO_OPS:
                    continue
                if op.type not in HOST_OPS:
                    raise NotImplementedError(
                        f"op {op.type!r} cannot run in a host I/O program; "
                        f"save/load programs must contain only save/load "
                        f"ops (build them via fluid.io helpers)")
                path = op.attr("file_path")
                if op.type == "save":
                    name = op.inputs["X"][0]
                    var_io.save_var(to_numpy(scope.get_var(name)), path)
                elif op.type == "load":
                    name = op.outputs["Out"][0]
                    scope.set_var(name, var_io.load_var(path), self.place)
                elif op.type == "save_combine":
                    names = list(op.inputs["X"])
                    var_io.save_combine(
                        {n: to_numpy(scope.get_var(n)) for n in names},
                        names, path)
                else:  # load_combine
                    names = list(op.outputs["Out"])
                    loaded = var_io.load_combine(path)
                    missing = [n for n in names if n not in loaded]
                    if missing:
                        raise KeyError(f"load_combine: vars {missing} not "
                                       f"present in {path!r}")
                    for n in names:
                        scope.set_var(n, loaded[n], self.place)
        if not fetch_names:
            return []
        vals = [scope.get_var(n) for n in fetch_names]
        return [to_numpy(v) for v in vals] if return_numpy else vals

    # ------------------------------------------------------------------
    def _refuse_left_out(self, program):
        if any(op.type in HOST_OPS for op in program.global_block.ops):
            raise ValueError("a host I/O program (save/load ops) runs "
                             "through Executor.run, not run_steps")
        if getattr(program, "_pipeline", None) is not None:
            raise _later("a pipeline program")
        if passes_mod.has_tp_marks(program) or \
                passes_mod.has_ep_marks(program):
            # its dp loss-grad scale was removed for a sharded run: one
            # device would compute wrong gradients, not just slow ones
            raise _later("a tensor- or expert-parallel program")

    def _pruned(self, program, fetch_names) -> Program:
        """``program`` with only the ops the fetches need (a clone whose
        fingerprint keys its compiled step), cached per (fingerprint,
        fetches)."""
        key = (program.fingerprint(), fetch_names)
        pruned = self._prune_cache.get(key)
        if pruned is not None:
            stat_add("executor_prune_cache_hit")
            return pruned
        keep = {id(op) for op in _prune_ops(program, fetch_names)}
        pruned = program._copy()
        pruned.global_block.ops = [
            nop for op, nop in zip(program.global_block.ops,
                                   pruned.global_block.ops)
            if id(op) in keep or op.type in PSEUDO_OPS]
        pruned._bump()
        self._prune_cache[key] = pruned
        return pruned

    def _apply_graph_passes(self, program, fetch_names, feed, scope):
        """Run the framework.passes pipeline over ``program`` before
        lowering (reference build-strategy graph passes).  The result --
        a rewritten clone, or the original object when no pass changed
        anything -- is cached per (fingerprint, pass config, fetch/feed
        names, scope serial) and the values of the flags the passes
        read (FLAGS_weight_quant and the layer-scan flags among them:
        flipping one back serves the program it gave before, not a stale
        rewrite).  FLAGS_fuse_passes gates the optimization passes; with
        it off, scan-over-layers still runs when FLAGS_layer_scan or a
        ``recompute_configs`` scan stamp asks for it (its own gate)."""
        if flag("fuse_passes"):
            pipeline = passes_mod.default_pipeline()
        elif passes_mod.LayerScanPass._config(program)[0]:
            pipeline = passes_mod.PassPipeline([passes_mod.LayerScanPass()])
        else:
            return program
        with otrace.span("executor/pass_pipeline"):
            key = (program.fingerprint(), pipeline.config_key(),
                   fetch_names, frozenset(feed), scope.serial,
                   str(flag("flash_attention")), str(flag("weight_quant")),
                   bool(flag("fuse_passes"))) + _scan_flags()
            cached = self._pass_cache.get(key)
            if cached is not None:
                stat_add("executor_pass_cache_hit")
                return cached
            ctx = passes_mod.PassContext(fetch_names=fetch_names,
                                         feed_names=tuple(feed),
                                         scope=scope)
            out = self._pass_cache[key] = pipeline.apply(program, ctx)
            return out

    def _prepare_state(self, program, scope):
        """Before the state analysis: a layer-scanned program's per-layer
        state packed into the carriers once, and anything written over a
        member since (a restore) copied into its slice in place
        (``LayerScanPlan.ensure_stacked``); a ZeRO-1 program's sharded
        accumulators cut to this rank's rows (``_cut_zero_blocks``).  A
        no-op in steady state."""
        plan = getattr(program, "_layer_plan", None)
        if plan is not None:
            plan.ensure_stacked(scope, self.device)
        _cut_zero_blocks(program, scope)

    def _generator(self, scope, program) -> torch.Generator:
        gen = scope.get_var(RNG_VAR) if scope.has_var(RNG_VAR) else None
        if gen is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(program.random_seed or 0))
            scope.set_var(RNG_VAR, gen)
        return gen

    # -- the compiled-step cache ----------------------------------------
    def _entry(self, program, feeds, fetch_names, scope,
               local_fetches=False) -> _Entry:
        state_in, state_out = self._analysis(program, set(feeds), scope)
        scan = bool(flag("check_nan_inf"))
        if scan:   # the flags ride as the last fetch
            fetch_names = fetch_names + (NAN_FLAGS_VAR,)
        key = (program.fingerprint(),
               tuple((n, tuple(t.shape), t.dtype) for n, t in feeds.items()),
               fetch_names,
               tuple((tuple(v.shape), v.dtype,
                      isinstance(v, StackedParamRef)) for v in
                     (scope.get_var(n) for n in state_in)),
               scope.serial, self.device,
               str(flag("flash_attention")), str(flag("weight_quant")),
               bool(flag("fuse_passes")), int(flag("moe_alltoall_chunks")),
               local_fetches) + _scan_flags()
        entry = self._cache.get(key)
        if entry is not None:
            stat_add("executor_cache_hit")
            return entry
        stat_add("executor_compile")
        if self.device.type == "cuda":
            _flight.record_device_topology()
        _flight.record("executor/compile",
                       fingerprint=program.fingerprint()[:16],
                       fetches=len(fetch_names))
        frees = self._frees(program, feeds, fetch_names, scope)
        batch, flops = _batch_flops(program, feeds)
        # the budget gate judges the estimate before anything launches;
        # a rejected key is not cached, so its next run is judged again
        estimate, sizes = _footprint(program, feeds, state_in, scope,
                                     frees, batch)
        budget = _xla_stats.judge_program(
            estimate, sizes, device=self.device,
            fingerprint=program.fingerprint())
        block = program.global_block
        entry = self._cache[key] = _Entry(
            program, fetch_names, state_in, state_out, frees,
            capture_reason(program), batch, flops, nan_scan=scan,
            phase_plan=_phases.build_phase_plan(block, block.ops,
                                                flops_per_step=flops),
            estimated_bytes=estimate, budget=budget, size_entries=sizes,
            varying=None if local_fetches
            else self._varying(program, feeds),
            allreduce_bytes=_program_allreduce_bytes(block, block.ops))
        return entry

    def _compiled(self, entry, n_steps) -> bool:
        """Whether the last ``n_steps`` runs of ``entry`` count as
        compiles in the step timer: the runs before its first replay
        (its warm-up and capture; its first run on the CPU)."""
        warm_runs = 2 if self._owns(entry) else 1
        return entry.runs - n_steps < warm_runs

    def _owns(self, entry) -> bool:
        """Whether ``entry``'s fetches may be buffers a later replay
        rewrites (the graph's outputs, or state that becomes the graph's
        input), so that the caller gets copies."""
        return self._captures and entry.eager_reason is None

    def _run_entry(self, entry, feeds, scope) -> List[torch.Tensor]:
        """Run ``entry`` once; its runs before its first replay (the
        warm-up and the capture; the first run on the CPU or when it
        runs eagerly) count as a compile in flight, and the last of them
        is recorded by ``xla_stats.on_compile``."""
        warm_runs = 2 if self._owns(entry) else 1
        if entry.runs >= warm_runs:
            return self._run_entry_once(entry, feeds, scope)
        tid = threading.get_ident()
        t0 = _ACTIVE_COMPILES[tid] = time.perf_counter()
        try:
            out = self._run_entry_once(entry, feeds, scope)
        finally:
            _ACTIVE_COMPILES.pop(tid, None)
        if entry.runs == warm_runs:
            _xla_stats.on_compile(
                entry, fingerprint=entry.program.fingerprint(),
                seconds=time.perf_counter() - t0,
                size_entries=entry.size_entries,
                program_flops=entry.flops_per_step, device=self.device)
        return out

    def _run_entry_once(self, entry, feeds, scope) -> List[torch.Tensor]:
        entry.runs += 1
        if entry.eager_reason is not None:
            kind, why = entry.eager_reason
            stat_add("executor_eager_" + kind)
            with otrace.span("executor/eager", reason=why):
                return self._run_block(entry.program, feeds,
                                       entry.fetch_names, scope, entry)
        if not self._captures:
            return self._run_block(entry.program, feeds, entry.fetch_names,
                                   scope, entry)
        if entry.graph is not None:
            entry.graph.bind(feeds, scope)
        elif entry.step is None:   # the first run: eager, the warm-up
            entry.step = StepGraph(self.device)
            return entry.step.on_side_stream(lambda: self._run_block(
                entry.program, feeds, entry.fetch_names, scope, entry))
        else:
            entry.graph = self._capture(entry, feeds, scope)
        with otrace.span("executor/replay"):
            return entry.graph.replay(scope)

    def _capture(self, entry, feeds, scope) -> _GraphStep:
        """Record the entry's block into a graph over static copies of
        ``feeds`` and the scope's state tensors; the state the block
        writes back lands in those tensors in place."""
        block = entry.program.global_block
        gen = self._generator(scope, entry.program)
        static_feeds = {n: t.clone() for n, t in feeds.items()}
        # members of a layer-scan carrier are slices of it inside the
        # step, never state buffers of their own: a second buffer on
        # the carrier's storage would be cloned off it below, and an
        # edge layer's update would never reach the carrier
        views_in, views_out, carriers = _stacked_views(
            scope, entry.state_in, entry.state_out)
        state, held = {}, set()
        for n in tuple(n for n in entry.state_in if n not in views_in) \
                + tuple(c for c in carriers if c not in entry.state_in):
            v = scope.get_var(n)
            if v.device != self.device or _storage(v) in held:
                # each state buffer its own: an update in place must not
                # reach a second name that shared the tensor
                v = v.to(self.device, copy=True)
                scope.set_var(n, v)
            held.add(_storage(v))
            state[n] = v
        inputs = held | {_storage(t) for t in static_feeds.values()}
        graph = _GraphStep(entry.step, static_feeds, state, gen,
                           int(entry.program.random_seed or 0))

        read = set(entry.state_in)

        def step():
            env = {n: v for n, v in state.items() if n in read}
            env.update((n, state[c][i]) for n, (c, i) in views_in.items())
            env.update(static_feeds)
            self._run_ops(LoweringContext(block, env, self.device, gen),
                          entry.frees, entry)
            _check_fetches(entry.fetch_names, env)
            copies = []
            for n in entry.state_out:
                if n in views_out:
                    continue
                v = env[n]
                if n in state and v is state[n]:
                    continue
                if _storage(v) in inputs:  # an alias of an input buffer
                    v = v.clone()          # (assign): take the value now
                if n in state:
                    copies.append((state[n], v))
                else:
                    graph.written[n] = v
            for n, (c, i) in views_out.items():
                # after the carrier's own write-back
                copies.append((state[c][i], env[n]))
            for buf, v in copies:
                buf.copy_(v)
            return _assemble_fetches(entry.fetch_names,
                                     [env[n] for n in entry.fetch_names],
                                     entry.varying)

        with otrace.span("executor/capture", ops=len(block.ops)):
            entry.step.capture(step, generators=(gen,))
        return graph

    # -- the eager block --------------------------------------------------
    def _run_block(self, program, feeds, fetch_names, scope, entry=None):
        """Run the block op by op (every lowering called eagerly), each
        value dropped after its last use; write the state back to the
        scope and return the fetches (``entry``'s NaN flags last when it
        scans)."""
        block = program.global_block
        state_in, state_out = self._analysis(program, set(feeds), scope)
        # a key's first run on the card reads the caching allocator
        # (xla_stats.memory_breakdown)
        probe = entry is not None and entry.runs == 1 \
            and self.device.type == "cuda"
        if probe:
            args = sum(_nbytes(scope.get_var(n)) for n in state_in) + \
                sum(_nbytes(t) for t in feeds.values())
            written = set(state_out)
            aliased = sum(_nbytes(scope.get_var(n)) for n in state_in
                          if n in written)
        views_in, views_out, _ = _stacked_views(scope, state_in, state_out)
        env = {}
        for n in state_in:
            v = scope.get_var(n)
            if n in views_in:   # a layer-scan member: its carrier's slice
                v = v.device_value()
            # a tensor array (a Python list) passes through as it is
            env[n] = v.to(self.device) if isinstance(v, torch.Tensor) \
                and v.device != self.device else v
        env.update(feeds)
        ctx = LoweringContext(block, env, self.device,
                              self._generator(scope, program))
        peak = self._run_ops(
            ctx, self._frees(program, feeds, fetch_names, scope), entry,
            probe)
        _check_fetches(fetch_names, env)
        if probe:
            outs = sum(_nbytes(env[n]) for n in fetch_names)
            entry.memory = {"arguments_bytes": args, "outputs_bytes": outs,
                            "temporaries_bytes": max(peak - outs, 0),
                            "aliased_bytes": aliased}
        for n in state_out:
            if n not in views_out:
                scope.set_var(n, env[n])
        with torch.no_grad():
            for n, (c, i) in views_out.items():
                scope.get_var(c)[i].copy_(env[n])
        varying = entry.varying if entry is not None \
            else self._varying(program, feeds)
        return _assemble_fetches(fetch_names, [env[n] for n in fetch_names],
                                 varying)

    def _run_ops(self, ctx, frees, entry=None, probe=False) -> int:
        """Every op of the block through its lowering, raising with the
        op's type and build site; ``frees[i]`` names the values dropped
        after op i.  When ``entry`` scans for NaN/Inf, each floating
        output adds one flag, computed on the device (whether all its
        elements are finite), and the flags land in the environment as
        one tensor, ``NAN_FLAGS_VAR``; ``entry.nan_ops`` names the op of
        each flag, in the flags' order.  With ``probe`` (on the card)
        returns the most bytes the caching allocator held above its
        count at the start, read after each op (host counters: no
        wait), else 0."""
        env = ctx.env
        peak = len(env)
        base = top = torch.cuda.memory_allocated(ctx.device) if probe else 0
        scan = entry is not None and entry.nan_scan
        groups = {}   # dtype -> ([min, max, ...], [(type, site, index)])
        k = -1                      # the op's index among non-pseudo ops
        with torch.no_grad():
            for i, op in enumerate(ctx.block.ops):
                if op.type in PSEUDO_OPS:
                    continue
                k += 1
                try:
                    if op.type in COLLECTIVE_OPS:
                        with otrace.span(f"collective/{op.type}",
                                         **_collective_span_args(env, op)):
                            get_lowering(op.type)(ctx, op)
                    else:
                        get_lowering(op.type)(ctx, op)
                except Exception as e:
                    site = op.callstack[-1] if op.callstack else "<unknown>"
                    msg = f"while lowering op {op.type!r} (built at " \
                          f"{site}): {e}"
                    try:
                        err = type(e)(msg)
                    except Exception:  # noqa: BLE001 - odd constructors
                        err = RuntimeError(msg)
                    raise err from e
                if scan:
                    site = op.callstack[-1] if op.callstack else "?"
                    for n in op.output_arg_names():
                        v = env.get(n)
                        if isinstance(v, torch.Tensor) \
                                and v.is_floating_point() and v.numel():
                            # one reduction an output, no copy of it: its
                            # min and max (NaN propagates) are finite
                            # exactly when every element is
                            vals, ops = groups.setdefault(v.dtype, ([], []))
                            vals.extend(torch.aminmax(v))
                            ops.append((op.type, site, k))
                peak = max(peak, len(env))
                if probe:
                    top = max(top, torch.cuda.memory_allocated(ctx.device))
                for n in frees[i]:
                    env.pop(n, None)
            if scan:
                # one flag an output, grouped by dtype (a stack needs one)
                env[NAN_FLAGS_VAR] = torch.cat(
                    [torch.isfinite(torch.stack(vals)).view(-1, 2).all(1)
                     for vals, _ in groups.values()]) if groups else \
                    torch.ones((0,), dtype=torch.bool, device=ctx.device)
                entry.nan_ops = tuple(o for _, ops in groups.values()
                                      for o in ops)
        self.env_peak = peak
        return top - base

    def _analysis(self, program, feed_names, scope):
        key = (program.fingerprint(), frozenset(feed_names), scope.serial)
        cached = self._analysis_cache.get(key)
        if cached is not None and all(scope.has_var(n) for n in cached[0]):
            return cached
        cached = self._analysis_cache[key] = _analyze_state(
            program, feed_names, scope)
        return cached

    def _varying(self, program, feeds) -> Optional[frozenset]:
        """``dp_varying`` of ``program`` with these feeds when a process
        group is live, else None (every fetch is the local value)."""
        from ..distributed.parallel_env import group_live

        if not group_live():
            return None
        return dp_varying(program, feeds)

    def _frees(self, program, feeds, fetch_names, scope):
        key = (program.fingerprint(), frozenset(feeds), fetch_names,
               scope.serial)
        cached = self._free_cache.get(key)
        if cached is None:
            state_out = self._analysis(program, set(feeds), scope)[1]
            cached = self._free_cache[key] = _free_plan(
                program, set(feeds) | set(state_out) | set(fetch_names))
        return cached


# program fingerprint -> its ZeRO-1 sharded accumulators
_ZERO_ACCS: Dict[str, Tuple[str, ...]] = {}


def zero_accumulators(program) -> Tuple[str, ...]:
    """The ZeRO-1 sharded optimizer state of ``program``: the names in
    its optimizer ops' ``__sharded_accumulators__``, in op order (cached
    per fingerprint)."""
    key = program.fingerprint()
    out = _ZERO_ACCS.get(key)
    if out is None:
        names = []
        for op in program.global_block.ops:
            for n in op.attr("__sharded_accumulators__", None) or ():
                if n not in names:
                    names.append(n)
        out = _ZERO_ACCS[key] = tuple(names)
    return out


def _cut_zero_blocks(program, scope) -> None:
    """Each of ``program``'s sharded accumulators that the scope holds at
    its declared dim 0 becomes this rank's rows ``[r*d0/n, (r+1)*d0/n)``
    (a tensor of its own; the full one is freed), recorded in the owning
    scope's ``zero_blocks`` as (global shape, origin).  Without a group
    above one rank nothing is cut: a one-rank program holds every row."""
    from ..distributed.parallel_env import get_rank, get_world_size

    n = get_world_size()
    if n <= 1:
        return
    names = zero_accumulators(program)
    r = get_rank()
    block = program.global_block
    for name in names:
        var = block._find_var_recursive(name)
        if var is None or not var.shape or not scope.has_var(name):
            continue
        v = scope.get_var(name)
        d0 = int(var.shape[0])
        if not isinstance(v, torch.Tensor) or v.dim() == 0 \
                or int(v.shape[0]) != d0:
            continue
        if d0 % n:
            raise ValueError(
                f"sharded accumulator {name!r}: dim 0 ({d0}) is not "
                f"divisible by the {n} ranks of the group")
        rows = d0 // n
        owner = scope
        while name not in owner._vars:
            owner = owner._parent
        owner._vars[name] = v[r * rows:(r + 1) * rows].clone()
        owner.zero_blocks[name] = (tuple(int(d) for d in v.shape),
                                   (r * rows,) + (0,) * (v.dim() - 1))


def dp_varying(program, feeds) -> frozenset:
    """The names whose values differ across data-parallel ranks (the JAX
    executor's static dp-variance analysis, ``_build_sharded_fn``): a
    feed with a batch dim above 1 is each rank's own shard, as is ZeRO's
    sharded optimizer state (``__sharded_accumulators__``); an op with a
    varying input makes its outputs vary; the ``_CLEARING`` collectives
    make theirs the same everywhere, ``c_shard_slice`` makes its output
    vary, and ``uncoalesce_tensor`` hands its fused buffer's variance to
    every member.  ``feeds``: name -> tensor (or anything with a
    ``shape``)."""
    varying = {n for n, t in feeds.items()
               if len(t.shape) > 0 and int(t.shape[0]) > 1}
    for op in program.global_block.ops:
        accs = op.attr("__sharded_accumulators__", None)
        if accs:
            varying.update(accs)
    for op in program.global_block.ops:
        if op.type in PSEUDO_OPS:
            continue
        if op.type in _CLEARING:
            varying.difference_update(op.output_arg_names())
            continue
        if op.type == "c_shard_slice":
            varying.update(op.output_arg_names())
            continue
        if op.type == "uncoalesce_tensor":
            if any(n in varying for n in op.input_arg_names()):
                varying.update(op.output_arg_names())
            else:
                varying.difference_update(op.output_arg_names())
            continue
        if any(n in varying for n in op.input_arg_names()):
            varying.update(op.output_arg_names())
    return frozenset(varying)


def _assemble_fetches(fetch_names, values, varying):
    """Each fetch as the JAX executor's ``step_once`` hands it back
    across ranks (``varying`` None: no group, the local values)."""
    if varying is None:
        return values
    import torch.distributed as dist

    from ..ops.collective import _all_gather, _all_reduce

    out = []
    for n, v in zip(fetch_names, values):
        if not isinstance(v, torch.Tensor):
            out.append(v)
        elif n == NAN_FLAGS_VAR:
            # every rank's flags, ANDed: the minimum of the 0/1 values
            out.append(_all_reduce(dist, v.to(torch.uint8), "min").bool())
        elif n not in varying:
            out.append(v)   # the same on every rank: the local copy
        elif v.numel() == 1:
            # a varying scalar (a loss, a metric): the cross-rank mean,
            # the full batch's value for a mean-reduced loss
            out.append(_all_reduce(dist, v, "sum") / dist.get_world_size())
        else:
            # a varying batched value: the full batch, in rank order
            out.append(_all_gather(dist, v, 0))
    return out


def _collective_span_args(env, op) -> dict:
    """The bytes and dtype of a collective's payload, for its span."""
    names = op.input_arg_names()
    v = env.get(names[0]) if names else None
    if not isinstance(v, torch.Tensor):
        return {"var": names[0] if names else ""}
    return {"bytes": v.numel() * v.element_size(),
            "dtype": str(v.dtype).replace("torch.", ""), "var": names[0]}


def _program_allreduce_bytes(block, op_list) -> int:
    """Allreduce payload a step, from the post-pass op stream's declared
    shapes (a fused bucket counts once, at its coalesced size); a
    layer-scan stacked collective moves ``__layer_stack__`` x its var's
    per-layer bytes."""
    total = 0
    for op in op_list:
        if op.type not in _ALLREDUCE_OPS:
            continue
        names = op.input_arg_names()
        var = block._find_var_recursive(names[0]) if names else None
        if var is None or not var.shape or any(int(s) <= 0
                                               for s in var.shape):
            continue
        try:
            itemsize = dtypes.to_torch(var.dtype).itemsize
        except (KeyError, ValueError, TypeError):
            continue
        n = 1
        for d in var.shape:
            n *= int(d)
        total += n * itemsize * max(
            int(op.attr(passes_mod.LAYER_STACK_ATTR, 0) or 0), 1)
    return total


def _batch_flops(program, feeds) -> Tuple[int, float]:
    """(the first feed's leading dim, FLOPs of one run at it).
    ``program_flops`` counts a -1 dim as 1, so a program whose first
    feed has a symbolic batch is priced per sample and scaled by the
    feed's, as the JAX executor does."""
    from ..hapi.model_stat import program_flops

    flops = float(program_flops(program))
    if not feeds:
        return 0, flops
    name, val = next(iter(feeds.items()))
    batch = int(val.shape[0]) if val.dim() else 1
    var = program.global_block._find_var_recursive(name)
    if var is not None and var.shape and int(var.shape[0]) <= 0:
        flops *= batch
    return batch, flops


def _nbytes(v) -> int:
    """Bytes of a tensor (0 for anything else: a generator, a tensor
    array, a layer-scan member, whose bytes its carrier holds)."""
    return v.numel() * v.element_size() if isinstance(v, torch.Tensor) \
        else 0


def _scan_flags() -> tuple:
    """The layer-scan flags, which decide the pass's rewrite: they key
    the pass cache and the compiled-step cache."""
    return (bool(flag("layer_scan")), int(flag("layer_scan_min_layers")),
            str(flag("layer_scan_policy")), int(flag("layer_scan_unroll")))


def _stacked_views(scope, state_in, state_out):
    """The state names that are layer-scan members in ``scope``
    (``StackedParamRef`` views): ``(read, written, carriers)``, the
    first two mapping a name to its (carrier, index).  A step reads such
    a member as its carrier's slice and writes it back into that slice,
    so the carrier stays the one copy of the layer's state."""
    def views(names):
        out = {}
        for n in names:
            v = scope.get_var(n) if scope.has_var(n) else None
            if isinstance(v, StackedParamRef):
                out[n] = (v.stack_name, v.index)
        return out

    vin, vout = views(state_in), views(state_out)
    carriers = tuple(dict.fromkeys(
        c for c, _ in list(vin.values()) + list(vout.values())))
    return vin, vout, carriers


def _footprint(program, feeds, state_in, scope, frees, batch):
    """(estimated bytes the step holds at once, size entries): its state
    and feeds as they are, plus the peak of the live temporaries when
    the block runs in its free plan's order, each sized from its
    declared shape (a -1 dim taken as the run's ``batch``) and dtype; a
    var without a known shape counts 0.  The size entries are
    ``(name, shape, dtype, kind)`` for ``xla_stats.var_attribution``."""
    block = program.global_block
    sizes = []
    for n in state_in:
        v = scope.get_var(n)
        if isinstance(v, torch.Tensor):
            sizes.append((n, tuple(v.shape), str(v.dtype)[6:], "state"))
    for n, t in feeds.items():
        sizes.append((n, tuple(t.shape), str(t.dtype)[6:], "feed"))
    held = sum(_nbytes(scope.get_var(n)) for n in state_in) + \
        sum(_nbytes(t) for t in feeds.values())
    have = set(state_in) | set(feeds)
    itemsize: Dict[object, int] = {}
    live: Dict[str, int] = {}
    cur = peak = 0
    for i, op in enumerate(block.ops):
        if op.type in PSEUDO_OPS:
            continue
        for n in op.output_arg_names():
            if n in have or n in live:
                continue
            var = block._find_var_recursive(n)
            b = 0
            if var is not None and var.shape and var.dtype is not None:
                if var.dtype not in itemsize:
                    try:
                        itemsize[var.dtype] = torch.empty(
                            (), dtype=dtypes.to_torch(var.dtype)
                        ).element_size()
                    except (KeyError, TypeError, ValueError):
                        itemsize[var.dtype] = 0
                b = itemsize[var.dtype]
                for d in var.shape:
                    b *= batch if int(d) < 0 else int(d)
            live[n] = b
            cur += b
        peak = max(peak, cur)
        for n in frees[i]:
            cur -= live.pop(n, 0)
    return held + peak, tuple(sizes)


def _check_fetches(fetch_names, env):
    missing = [n for n in fetch_names if n not in env]
    if missing:
        raise KeyError(f"fetch vars not produced by program: {missing}")


def _free_plan(program, keep) -> Tuple[Tuple[str, ...], ...]:
    """For each op of the global block, the names whose last use (read
    or write) it is, ``keep`` (feeds, state written back, fetches)
    excepted: the block drops them after the op.  Gradient ops read the
    forward values they need through their inputs, so those count.  A
    block with an op that owns a sub-block frees nothing (its reads are
    not all in its op's slots)."""
    ops = program.global_block.ops
    frees: List[List[str]] = [[] for _ in ops]
    if any(op.has_attr(a) for op in ops for a in SUB_BLOCK_ATTRS):
        return tuple(tuple(f) for f in frees)
    last = {}
    for i, op in enumerate(ops):
        if op.type in PSEUDO_OPS:
            continue
        for n in op.input_arg_names() + op.output_arg_names():
            last[n] = i
    for n, i in last.items():
        if n not in keep:
            frees[i].append(n)
    return tuple(tuple(f) for f in frees)


def _own(v):
    """A copy of a fetch a later replay would rewrite; a tensor array (a
    Python list) copied element by element."""
    if isinstance(v, list):
        return [_own(x) for x in v]
    return v.clone()


def _pinned_copy(t: torch.Tensor) -> torch.Tensor:
    """A host copy of card tensor ``t`` into pinned memory, issued
    without blocking on the current stream (ready at the step's event)."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


def _names(fetch_list) -> tuple:
    return tuple(v.name if isinstance(v, Variable) else str(v)
                 for v in (fetch_list or []))


def _block_written(program, block_idx: int) -> set:
    """All names written anywhere inside a block (nested blocks too)."""
    out: set = set()
    for sop in program.blocks[block_idx].ops:
        out.update(sop.output_arg_names())
        for aname in SUB_BLOCK_ATTRS:
            if sop.has_attr(aname):
                out |= _block_written(program, int(sop.attr(aname)))
    return out


def _ctrl_attr_reads(program, op) -> List[str]:
    """``cond_pair`` branch-output names that are NOT produced inside the
    branch (a branch returning an unchanged outer var or a captured
    constant): the lowering reads them from the environment."""
    reads: List[str] = []
    if op.type == "cond_pair":
        for aname, sb in (("t_outs", "sub_block_t"),
                          ("f_outs", "sub_block_f")):
            written = _block_written(program, int(op.attr(sb)))
            reads.extend(n for n in (op.attr(aname, []) or [])
                         if n not in written)
    return reads


def _sub_external_reads(program, block_idx: int) -> List[str]:
    """Names a sub-block reads from its surroundings."""
    local_written: set = set()
    ext: List[str] = []
    for sop in program.blocks[block_idx].ops:
        reads = sop.input_arg_names() + _ctrl_attr_reads(program, sop)
        for aname in SUB_BLOCK_ATTRS:
            if sop.has_attr(aname):
                reads += _sub_external_reads(program, int(sop.attr(aname)))
        for n in reads:
            if n not in local_written and n not in ext:
                ext.append(n)
        local_written.update(sop.output_arg_names())
    return ext


def op_reads(program, op) -> List[str]:
    """What ``op`` reads: its input slots, and for an op that owns
    sub-blocks what they read from its surroundings."""
    reads = list(op.input_arg_names()) + _ctrl_attr_reads(program, op)
    for aname in SUB_BLOCK_ATTRS:
        if op.has_attr(aname):
            reads += _sub_external_reads(program, int(op.attr(aname)))
    return reads


def _prune_ops(program, fetch_names, keep_side_effect_ops=False):
    """Backward slice: keep only ops whose outputs (transitively) feed the
    fetch list (reference framework/prune.h).  An op that owns a
    sub-block also needs what the sub-block reads from its surroundings.

    ``keep_side_effect_ops`` (the pass-pipeline DCE caller) additionally
    keeps ops with no outputs and the SIDE_EFFECT_OPS unconditionally."""
    block = program.global_block
    needed = set(fetch_names)
    keep = []
    for op in reversed(block.ops):
        if op.type in PSEUDO_OPS:
            continue
        keep_this = bool(set(op.output_arg_names()) & needed)
        if keep_side_effect_ops and (
                op.type in SIDE_EFFECT_OPS or not op.output_arg_names()):
            keep_this = True
        if keep_this:
            keep.append(op)
            needed.update(op_reads(program, op))
    keep.reverse()
    return keep


def _analyze_state(program: Program, feed_names: set, scope: Scope):
    """Static use/def analysis of the global block, an op that owns
    sub-blocks reading what they read from its surroundings.

    state_in  = names read before written that are not feeds (must come
                from the scope: parameters, optimizer state, ...)
    state_out = names written that should persist back into the scope
                (persistable vars, or anything already living in scope).
    """
    block = program.global_block
    written: set = set()
    state_in: List[str] = []
    state_out: List[str] = []
    for op in block.ops:
        if op.type in PSEUDO_OPS:
            continue
        for name in op_reads(program, op):
            if name in feed_names or name in written or name in state_in:
                continue
            if not scope.has_var(name) or scope.get_var(name) is None:
                raise RuntimeError(
                    f"op {op.type!r} reads {name!r} which is neither a "
                    f"feed nor initialized in the scope. Did you run the "
                    f"startup program? (op built at: "
                    f"{op.callstack[-1] if op.callstack else '?'})")
            state_in.append(name)
        for name in op.output_arg_names():
            written.add(name)
            var = block._find_var_recursive(name)
            if ((var is not None and var.persistable) or scope.has_var(name)) \
                    and name not in state_out:
                state_out.append(name)
    return tuple(state_in), tuple(state_out)


def run_startup(startup_program=None, place=None, scope=None):
    """Run a startup program (the default one without an argument) on
    ``place`` (the card without one); returns the executor."""
    from .program import default_startup_program

    exe = Executor(place)
    exe.run(startup_program or default_startup_program(), scope=scope)
    return exe

