"""Executor: runs a program's global block op by op on one device.

Counterpart of ``paddle_tpu/framework/executor.py``, with the same
``run(program, feed, fetch_list, scope, return_numpy)`` and
``run_steps(..., steps)`` contract.  The JAX executor traces the block
once into one jitted XLA computation; this one runs the lowering rules
eagerly, every step, over a dict of tensors on its device (the card by
default, ``CPUPlace()`` for the plain versions on the CPU):

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

``run_steps`` is a loop of K steps on the device with the fetches stacked
on a leading K dimension: nothing in it waits for the device.

Not in this slice (each raises ``NotImplementedError`` when asked for):
meshes and tensor parallelism, host I/O ops (save/load), ``use_prune``,
``warmup``, ``run_persistent``, auto-checkpoint, localsgd, pipeline
programs, and the NaN scan (``FLAGS_check_nan_inf``).  Runs are
synchronous: the JAX executor's pipelined window of in-flight steps
(``StepHandle``) is not ported either.

Graph passes: before a program's block runs, ``_apply_graph_passes``
hands it to the ``framework/passes.py`` pipeline (attention-chain fusion
to ``flash_attention``, redundant-cast and dead-op elimination), which
rewrites a clone and leaves the caller's program as built.  The result
is cached per (fingerprint, pass list, fetch and feed names, scope, and
the values of ``FLAGS_flash_attention`` and ``FLAGS_fuse_passes``, the
two flags the passes read); ``FLAGS_fuse_passes=0`` runs the program as
built.  The startup program goes through the same call, where no pass
finds anything to do.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import dtypes
from ..monitor import stat_add
from ..observe import tracer as otrace
from . import passes as passes_mod
from .flags import flag
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


class Executor:
    def __init__(self, place: Optional[Place] = None, mesh=None):
        if mesh is not None:
            raise _later("running over a device mesh")
        self.place = place if place is not None else _default_place()
        self.device = self.place.torch_device()
        # (program fingerprint, feed names, scope serial) -> (in, out)
        self._analysis_cache: Dict[tuple, tuple] = {}
        # (program fingerprint, pass config, fetch/feed names, scope
        # serial, pass flags) -> pass-rewritten program (or the original
        # when no pass applied)
        self._pass_cache: Dict[tuple, Program] = {}

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
        self._refuse_left_out(program)
        feeds = _feed_tensors(program.global_block, dict(feed or {}),
                              self.device)
        fetch_names = _names(fetch_list)
        program = self._apply_graph_passes(program, fetch_names, feeds,
                                           scope)
        fetches = self._run_block(program, feeds, fetch_names, scope)
        return [to_numpy(v) for v in fetches] if return_numpy else fetches

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

        The feeds reach the device once, before the loop; each fetch
        comes back stacked with a leading K dim, as tensors by default.
        """
        program = program if program is not None else default_main_program()
        feed = dict(feed or {})
        if not feed:
            raise ValueError("run_steps requires at least one feed")
        scope = scope if scope is not None else global_scope()
        self._refuse_left_out(program)
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
        for i in range(n_steps):
            step_feed = feeds if steps is not None else \
                {n: t[i] for n, t in feeds.items()}
            for acc, v in zip(per_step,
                              self._run_block(program, step_feed,
                                              fetch_names, scope)):
                acc.append(v)
        fetches = [torch.stack(vs) for vs in per_step]
        return [to_numpy(v) for v in fetches] if return_numpy else fetches

    # ------------------------------------------------------------------
    def warmup(self, *args, **kwargs):
        raise _later("Executor.warmup")

    def run_persistent(self, *args, **kwargs):
        raise _later("Executor.run_persistent")

    def close(self):
        self._analysis_cache.clear()
        self._pass_cache.clear()

    # ------------------------------------------------------------------
    def _refuse_left_out(self, program):
        if any(op.type in HOST_OPS for op in program.global_block.ops):
            raise _later("a host I/O program (save/load ops)")
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
        read; FLAGS_fuse_passes gates the whole pipeline."""
        if not flag("fuse_passes"):
            return program
        with otrace.span("executor/pass_pipeline"):
            pipeline = passes_mod.default_pipeline()
            key = (program.fingerprint(), pipeline.config_key(),
                   fetch_names, frozenset(feed), scope.serial,
                   str(flag("flash_attention")), bool(flag("fuse_passes")))
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

    def _run_block(self, program, feeds, fetch_names, scope):
        block = program.global_block
        state_in, state_out = self._analysis(program, set(feeds), scope)
        env = {}
        for n in state_in:
            v = scope.get_var(n)
            env[n] = v.to(self.device) if v.device != self.device else v
        env.update(feeds)
        ctx = LoweringContext(block, env, self.device,
                              self._generator(scope, program))
        with torch.no_grad():
            for op in block.ops:
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
        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise KeyError(f"fetch vars not produced by program: {missing}")
        for n in state_out:
            scope.set_var(n, env[n])
        return [env[n] for n in fetch_names]

    def _analysis(self, program, feed_names, scope):
        key = (program.fingerprint(), frozenset(feed_names), scope.serial)
        cached = self._analysis_cache.get(key)
        if cached is not None and all(scope.has_var(n) for n in cached[0]):
            return cached
        cached = self._analysis_cache[key] = _analyze_state(
            program, feed_names, scope)
        return cached


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

