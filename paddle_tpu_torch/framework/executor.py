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
  ``FLAGS_weight_quant``, ``FLAGS_fuse_passes``).  The scope joins the
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
  replay could not repeat) or host I/O.  Each such run counts
  ``executor_eager_<kind>`` and runs in an ``executor/eager`` span that
  names the reason.  A capture or replay that fails raises; nothing
  falls back.
- **Last-use frees.**  The block drops each value from its environment
  after the op that uses it last (not a feed, not state written back,
  not a fetch), as the reference's eager garbage collection and XLA's
  buffer reuse do: eagerly the memory returns to the allocator, under
  capture to the graph's private pool.  On the CPU (``CPUPlace()``, the
  kernels' plain versions) an entry is the plan without a graph.

Other behaviour, as in the JAX package:

- feeds are coerced to their declared dtypes (int64 stays int64);
- a static use/def walk finds the state the block reads from the scope
  (parameters, optimizer slots) and raises, naming the op and where it
  was built, when the startup program has not initialized it;
- outputs that persist (persistable vars, or names already in the scope)
  are written back to the scope after the block;
- random ops draw from one ``torch.Generator`` on the device, kept in the
  scope under ``RNG_VAR`` and seeded from ``program.random_seed`` the
  first time a program runs in that scope (a nonzero ``seed`` attr wins,
  see ``ops/common.op_generator``).

Step telemetry: each ``run`` and ``run_steps`` call records its wall time,
steps, examples (the first feed's leading dim) and the program's FLOPs
(``hapi/model_stat.program_flops``, scaled by that batch when the
program's batch dim is -1) into ``observe/step_stats.step_timer()``, as
the JAX executor's ``record_run`` calls do; a key's warm-up run and its
capture count as compiles.  ``run`` returns after its fetches reached the
host (``return_numpy=True``), so its recorded time is the step's.

``run_steps`` runs the entry K times, with the fetches stacked on a
leading K dimension.  Host I/O programs (``save``/``load``/
``save_combine``/``load_combine`` ops, built by ``fluid.io``) are
interpreted on the host: ``framework/var_io.py`` writes and reads the
files, and loaded values go straight to the executor's device.

Not in the port yet (each raises ``NotImplementedError`` when asked for):
meshes and tensor parallelism, ``use_prune``, auto-checkpoint, localsgd,
pipeline programs, and the NaN scan (``FLAGS_check_nan_inf``).  Runs are
synchronous: the JAX executor's pipelined window of in-flight steps
(``StepHandle``) is not ported, so ``drain`` has nothing to wait for.

Graph passes: before a program's block runs, ``_apply_graph_passes``
hands it to the ``framework/passes.py`` pipeline (attention-chain fusion
to ``flash_attention``, redundant-cast and dead-op elimination), which
rewrites a clone and leaves the caller's program as built, cached per
(fingerprint, pass list, fetch and feed names, scope, and the pass
flags); ``FLAGS_fuse_passes=0`` runs the program as built.  State read
from the scope reaches the device with its own dtype, never cast to the
var's declared one: a float8 weight-quant carrier is declared ``int8``
in the block (the IR has no float8 type) and the op's ``mode`` attr says
what it holds.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import dtypes
from ..monitor import stat_add
from ..observe import step_stats
from ..observe import tracer as otrace
from . import passes as passes_mod
from .flags import flag
from .graphs import StepGraph
from .lowering import PSEUDO_OPS, LoweringContext, get_lowering
from .place import Place, _default_place
from .program import Program, Variable, default_main_program
from .scope import Scope, global_scope, to_numpy, to_tensor

RNG_VAR = "@RNG_KEY@"

# ops the JAX executor runs host-side (file I/O)
HOST_OPS = {"save", "load", "save_combine", "load_combine"}

# ops whose effect is not visible through their outputs (p2p send/recv
# pairs match POSITIONALLY per ring, so dropping either end corrupts the
# pairing; barrier is a rendezvous; print emits a host debug callback) --
# the pass-pipeline DCE must never slice them away
SIDE_EFFECT_OPS = {"send_v2", "partial_send", "recv_v2", "partial_recv",
                   "barrier", "print"}


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


def capture_reason(program: Program) -> Optional[Tuple[str, str]]:
    """Why ``program`` cannot run as a captured graph, from its op list
    alone: ``(kind, text)``, or None when it can.  ``kind`` names the
    ``executor_eager_<kind>`` counter its runs move."""
    for op in program.global_block.ops:
        if op.type in HOST_OPS:
            return ("host_io", f"op {op.type!r} reads or writes files on "
                               f"the host")
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
        # entries become graphs on the card; on the CPU they stay plans
        self._captures = self.device.type == "cuda"

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
        if use_prune:
            raise _later("Executor.run(use_prune=True)")
        if any(op.type in HOST_OPS for op in program.global_block.ops):
            return self._run_host_ops(program, scope, _names(fetch_list),
                                      return_numpy)
        t0 = time.perf_counter()
        fetches, entry = self._run(program, feed, _names(fetch_list), scope)
        if return_numpy:
            out = [to_numpy(v) for v in fetches]
        else:
            out = [v.clone() for v in fetches] if self._owns(entry) \
                else fetches
        self._record(entry, time.perf_counter() - t0, 1)
        return out

    def _run(self, program, feed, fetch_names, scope):
        """One step: the pass pipeline, the entry's lookup, its run.
        Returns the fetches (the graph's own buffers when the entry is
        captured) and the entry."""
        self._refuse_left_out(program)
        feeds = _feed_tensors(program.global_block, dict(feed or {}),
                              self.device)
        program = self._apply_graph_passes(program, fetch_names, feeds,
                                           scope)
        entry = self._entry(program, feeds, fetch_names, scope)
        stat_add("executor_run")
        return self._run_entry(entry, feeds, scope), entry

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
        self._refuse_left_out(program)
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
        per_step: List[List[torch.Tensor]] = [[] for _ in fetch_names]
        entry = None
        for i in range(n_steps):
            step_feed = feeds if steps is not None else \
                {n: t[i] for n, t in feeds.items()}
            if entry is None:
                entry = self._entry(program, step_feed, fetch_names, scope)
                stat_add("executor_run")
            for acc, v in zip(per_step,
                              self._run_entry(entry, step_feed, scope)):
                acc.append(v.clone() if self._owns(entry) else v)
        fetches = [torch.stack(vs) for vs in per_step]
        out = [to_numpy(v) for v in fetches] if return_numpy else fetches
        self._record(entry, time.perf_counter() - t0, n_steps)
        return out

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
        Returns the number of entries freshly compiled (0 if every spec
        was already cached).
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
        n0 = len(self._cache)
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
        """Wait for in-flight steps: none, since every run is
        synchronous (kept for the JAX package's API)."""

    def close(self):
        """Drop every cache, the captured graphs with them (their pools
        go once the scopes let go of the state they hold)."""
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
        if getattr(program, "_localsgd", None) is not None:
            raise _later("the localsgd strategy")
        if getattr(program, "_pipeline", None) is not None:
            raise _later("a pipeline program")
        if os.environ.get("PADDLE_RUNNING_ENV") == \
                "PADDLE_EDL_AUTO_CHECKPOINT":
            raise _later("auto-checkpoint (PADDLE_RUNNING_ENV)")
        if flag("check_nan_inf"):
            raise _later("the NaN/Inf scan (FLAGS_check_nan_inf)")

    def _apply_graph_passes(self, program, fetch_names, feed, scope):
        """Run the framework.passes pipeline over ``program`` before
        lowering (reference build-strategy graph passes).  The result --
        a rewritten clone, or the original object when no pass changed
        anything -- is cached per (fingerprint, pass config, fetch/feed
        names, scope serial) and the values of the flags the passes
        read (FLAGS_weight_quant among them: flipping it back serves the
        float program again, not a stale rewrite); FLAGS_fuse_passes
        gates the whole pipeline."""
        if not flag("fuse_passes"):
            return program
        with otrace.span("executor/pass_pipeline"):
            pipeline = passes_mod.default_pipeline()
            key = (program.fingerprint(), pipeline.config_key(),
                   fetch_names, frozenset(feed), scope.serial,
                   str(flag("flash_attention")), str(flag("weight_quant")),
                   bool(flag("fuse_passes")))
            cached = self._pass_cache.get(key)
            if cached is not None:
                stat_add("executor_pass_cache_hit")
                return cached
            ctx = passes_mod.PassContext(fetch_names=fetch_names,
                                         feed_names=tuple(feed),
                                         scope=scope)
            out = self._pass_cache[key] = pipeline.apply(program, ctx)
            return out

    def _generator(self, scope, program) -> torch.Generator:
        gen = scope.get_var(RNG_VAR) if scope.has_var(RNG_VAR) else None
        if gen is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(program.random_seed or 0))
            scope.set_var(RNG_VAR, gen)
        return gen

    # -- the compiled-step cache ----------------------------------------
    def _entry(self, program, feeds, fetch_names, scope) -> _Entry:
        state_in, state_out = self._analysis(program, set(feeds), scope)
        key = (program.fingerprint(),
               tuple((n, tuple(t.shape), t.dtype) for n, t in feeds.items()),
               fetch_names,
               tuple((tuple(v.shape), v.dtype) for v in
                     (scope.get_var(n) for n in state_in)),
               scope.serial, self.device,
               str(flag("flash_attention")), str(flag("weight_quant")),
               bool(flag("fuse_passes")))
        entry = self._cache.get(key)
        if entry is not None:
            stat_add("executor_cache_hit")
            return entry
        stat_add("executor_compile")
        entry = self._cache[key] = _Entry(
            program, fetch_names, state_in, state_out,
            self._frees(program, feeds, fetch_names, scope),
            capture_reason(program), *_batch_flops(program, feeds))
        return entry

    def _record(self, entry, seconds, n_steps):
        """One call into the step timer: the runs before the entry's
        first replay (its warm-up and capture; its first run on the CPU)
        count as compiles."""
        warm_runs = 2 if self._owns(entry) else 1
        compiled = entry.runs - n_steps < warm_runs
        step_stats.step_timer().record_run(
            seconds, steps=n_steps, examples=entry.batch * n_steps,
            compiled=compiled, flops_per_step=entry.flops_per_step)

    def _owns(self, entry) -> bool:
        """Whether ``entry``'s fetches may be buffers a later replay
        rewrites (the graph's outputs, or state that becomes the graph's
        input), so that the caller gets copies."""
        return self._captures and entry.eager_reason is None

    def _run_entry(self, entry, feeds, scope) -> List[torch.Tensor]:
        entry.runs += 1
        if entry.eager_reason is not None:
            kind, why = entry.eager_reason
            stat_add("executor_eager_" + kind)
            with otrace.span("executor/eager", reason=why):
                return self._run_block(entry.program, feeds,
                                       entry.fetch_names, scope)
        if not self._captures:
            return self._run_block(entry.program, feeds, entry.fetch_names,
                                   scope)
        if entry.graph is not None:
            entry.graph.bind(feeds, scope)
        elif entry.step is None:   # the first run: eager, the warm-up
            entry.step = StepGraph(self.device)
            return entry.step.on_side_stream(lambda: self._run_block(
                entry.program, feeds, entry.fetch_names, scope))
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
        state, held = {}, set()
        for n in entry.state_in:
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

        def step():
            env = dict(state)
            env.update(static_feeds)
            self._run_ops(LoweringContext(block, env, self.device, gen),
                          entry.frees)
            _check_fetches(entry.fetch_names, env)
            copies = []
            for n in entry.state_out:
                v = env[n]
                if n in state and v is state[n]:
                    continue
                if _storage(v) in inputs:  # an alias of an input buffer
                    v = v.clone()          # (assign): take the value now
                if n in state:
                    copies.append((state[n], v))
                else:
                    graph.written[n] = v
            for buf, v in copies:
                buf.copy_(v)
            return [env[n] for n in entry.fetch_names]

        with otrace.span("executor/capture", ops=len(block.ops)):
            entry.step.capture(step, generators=(gen,))
        return graph

    # -- the eager block --------------------------------------------------
    def _run_block(self, program, feeds, fetch_names, scope):
        """Run the block op by op (every lowering called eagerly), each
        value dropped after its last use; write the state back to the
        scope and return the fetches."""
        block = program.global_block
        state_in, state_out = self._analysis(program, set(feeds), scope)
        env = {}
        for n in state_in:
            v = scope.get_var(n)
            env[n] = v.to(self.device) if v.device != self.device else v
        env.update(feeds)
        ctx = LoweringContext(block, env, self.device,
                              self._generator(scope, program))
        self._run_ops(ctx, self._frees(program, feeds, fetch_names, scope))
        _check_fetches(fetch_names, env)
        for n in state_out:
            scope.set_var(n, env[n])
        return [env[n] for n in fetch_names]

    def _run_ops(self, ctx, frees):
        """Every op of the block through its lowering, raising with the
        op's type and build site; ``frees[i]`` names the values dropped
        after op i."""
        env = ctx.env
        peak = len(env)
        with torch.no_grad():
            for i, op in enumerate(ctx.block.ops):
                if op.type in PSEUDO_OPS:
                    continue
                try:
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
                peak = max(peak, len(env))
                for n in frees[i]:
                    env.pop(n, None)
        self.env_peak = peak

    def _analysis(self, program, feed_names, scope):
        key = (program.fingerprint(), frozenset(feed_names), scope.serial)
        cached = self._analysis_cache.get(key)
        if cached is not None and all(scope.has_var(n) for n in cached[0]):
            return cached
        cached = self._analysis_cache[key] = _analyze_state(
            program, feed_names, scope)
        return cached

    def _frees(self, program, feeds, fetch_names, scope):
        key = (program.fingerprint(), frozenset(feeds), fetch_names,
               scope.serial)
        cached = self._free_cache.get(key)
        if cached is None:
            state_out = self._analysis(program, set(feeds), scope)[1]
            cached = self._free_cache[key] = _free_plan(
                program, set(feeds) | set(state_out) | set(fetch_names))
        return cached


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
    if any(op.has_attr(a) for op in ops
           for a in ("sub_block", "sub_block_t", "sub_block_f")):
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


def _names(fetch_list) -> tuple:
    return tuple(v.name if isinstance(v, Variable) else str(v)
                 for v in (fetch_list or []))


def _prune_ops(program, fetch_names, keep_side_effect_ops=False):
    """Backward slice: keep only ops whose outputs (transitively) feed the
    fetch list (reference framework/prune.h).

    ``keep_side_effect_ops`` (the pass-pipeline DCE caller) additionally
    keeps ops with no outputs and the SIDE_EFFECT_OPS unconditionally.

    An op that owns a sub-block also reads what the sub-block reads from
    its surroundings.  The port lowers no control flow yet, so such a
    program raises here instead of being sliced by its visible reads
    alone."""
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
        if any(op.has_attr(a)
               for a in ("sub_block", "sub_block_t", "sub_block_f")):
            raise _later(f"pruning a program with control flow (op "
                         f"{op.type!r} owns a sub-block)")
        if keep_this:
            keep.append(op)
            needed.update(op.input_arg_names())
    keep.reverse()
    return keep


def _analyze_state(program: Program, feed_names: set, scope: Scope):
    """Static use/def analysis of the global block.

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
        for name in op.input_arg_names():
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

