"""Elastic training supervisor: preemption as a recoverable event.

PyTorch port of ``paddle_tpu/distributed/fleet/elastic/supervisor.py``,
statement for statement over the port's own parts: the asynchronous
checkpoint manager and ``ResumableIterator`` (``ckpt``), the stall
watchdog, postmortem bundles and the cluster heartbeat plane
(``observe/health.py``), the executor's ``quiesce_all`` / ``close_all``
and the memory budget gate (``observe/xla_stats.py``).

``ElasticSupervisor.run(train_fn, manager, loader)`` drives a step
loop and, when a device or rank disappears, classifies the failure,
dumps a postmortem bundle, and restarts — rebuilding on the surviving
topology when the world shrank — instead of dying:

1. **Preflight with a deadline** (:mod:`.preflight`): a subprocess-
   isolated probe so a wedged card can never hang the supervisor.
2. **Supervised step loop**: steps run inside an in-flight window the
   :class:`~paddle_tpu_torch.observe.health.StallWatchdog` samples (a
   supervisor-local progress feed — one counter pair + the current
   step's dispatch time); a trip dumps the bundle and restarts the
   attempt.  The loop also polls the health plane
   (``/metrics/cluster`` or an injected ``cluster_fn``) for dead
   ranks, and fires :mod:`.chaos` hook points.
3. **Failure classification** — ``transient`` (restart in place),
   ``topology_change`` (drop the dead ranks, re-shard, restore), or
   ``poison_step`` (the same step failed identically twice, or the
   budget gate refused it: replaying cannot help — terminal).
4. **Elastic restore**: every (re)start restores the latest *intact*
   checkpoint through the manager (a ZeRO-1 rank's ``LocalShard``
   blocks re-assemble at any rank count), fast-forwards the
   ``ResumableIterator``, and continues on the new world.
5. **Retry budget**: ``FLAGS_elastic_max_restarts`` attempts with
   ``FLAGS_elastic_backoff_s * 2^k`` backoff, then a loud
   :class:`ElasticTerminated` carrying the whole restart history —
   never a silent hang, never a silent 0.0.

``train_fn(topology)`` builds the model/executor for the given
:class:`Topology` and returns a program object exposing
``step(batch) -> loss`` plus either a ``scope`` (device state the
checkpoint manager snapshots/restores) or ``state()``/``load_state()``
(host-state dict), optionally ``components`` (extra checkpoint
components, e.g. an LR scheduler), ``device`` (where a restore puts the
state: the card unless it names another, such as ``"cpu"``) and
``close()``.  A bare callable is wrapped as a stateless step function.

Several processes: the port runs one process per rank, each under its
own supervisor (the layout the JAX module names for several hosts: the
launcher starts processes, this loop restarts *topologies*).  A rank's
``train_fn`` re-forms the ``torch.distributed`` group over
``topology.ranks`` (the survivors) before it builds its program; a
peer's death reaches a survivor as a failed collective (gloo fails at
once on a closed connection) and as its dead-listed heartbeat.

Honest limitation: this is in-process supervision — a host thread
wedged *forever* inside a device call can be diagnosed (watchdog →
bundle) but not preempted from the same process.  That is exactly why
preflight is subprocess-isolated, and why several ranks run one
supervised process each.
"""
from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, Optional, Sequence

from ....framework import flags as _flags
from ....monitor import stat_add, stat_set
from ....observe import flight as _flight
from . import chaos
from .preflight import PreflightVerdict, preflight_device

__all__ = ["Topology", "ElasticSupervisor", "SupervisorResult",
           "ElasticTerminated", "PreflightError", "StallDetected",
           "DeadRankDetected", "classify_failure", "is_device_failure",
           "dead_ranks_from_cluster", "FAILURE_TRANSIENT",
           "FAILURE_TOPOLOGY", "FAILURE_POISON"]

FAILURE_TRANSIENT = "transient"
FAILURE_TOPOLOGY = "topology_change"
FAILURE_POISON = "poison_step"


class ElasticTerminated(RuntimeError):
    """Loud terminal failure: the retry budget is exhausted or the
    failure is poison.  Carries the restart history so the terminal
    record is a diagnosis, not a shrug."""

    def __init__(self, msg: str, history: Optional[List[dict]] = None):
        super().__init__(msg)
        self.history = list(history or [])


class PreflightError(RuntimeError):
    """A preflight verdict other than ``ok`` (always transient: its
    own bounded retries already ran)."""

    def __init__(self, verdict: PreflightVerdict):
        super().__init__(
            f"device preflight failed: {verdict.verdict} "
            f"after {verdict.attempts} attempt(s): {verdict.diag}")
        self.verdict = verdict


class StallDetected(RuntimeError):
    """The stall watchdog tripped on this attempt's step window."""

    def __init__(self, step: int, bundle: Optional[str] = None):
        super().__init__(
            f"stall watchdog tripped at step {step}"
            + (f" (postmortem: {bundle})" if bundle else ""))
        self.step = int(step)
        self.bundle = bundle


class DeadRankDetected(RuntimeError):
    """The health plane dead-listed rank(s) this topology depends on."""

    def __init__(self, ranks: Sequence[int]):
        self.ranks = sorted(int(r) for r in ranks)
        super().__init__(f"health plane dead-listed rank(s) {self.ranks}")


# message markers that make a generic exception read as the DEVICE
# failing rather than the program: the JAX package's, then the card's
# and its collectives' (CUDA errors, the allocator's out of memory,
# NCCL, gloo losing a peer, torch.distributed's error types)
_DEVICE_MARKERS = ("device", "backend", "tpu", "pjrt", "xla",
                   "resource_exhausted", "deadline_exceeded",
                   "unavailable", "init did not complete", "preflight",
                   "stall watchdog", "heartbeat", "dead-listed",
                   "cuda error", "cudaerror", "out of memory", "nccl",
                   "gloo", "connection closed by peer",
                   "connection reset by peer", "distbackenderror",
                   "distnetworkerror", "diststoreerror")


def is_device_failure(exc: BaseException) -> bool:
    """Does this exception look like the device/cluster failing (worth
    a retry) rather than the program being wrong (not)?"""
    if isinstance(exc, (PreflightError, StallDetected, DeadRankDetected,
                        chaos.RankKilled)):
        return True
    msg = f"{type(exc).__name__}: {exc}".lower()
    return any(m in msg for m in _DEVICE_MARKERS)


def classify_failure(exc: BaseException,
                     dead_ranks: Optional[Sequence[int]] = None,
                     repeat: bool = False) -> str:
    """transient | topology_change | poison_step (module docstring §3).

    ``dead_ranks`` is the health plane's word at failure time;
    ``repeat`` means the SAME step already failed with the SAME
    exception once — replaying is provably useless."""
    if isinstance(exc, (chaos.RankKilled, DeadRankDetected)) or dead_ranks:
        return FAILURE_TOPOLOGY
    if isinstance(exc, PreflightError):
        return FAILURE_TRANSIENT
    try:
        from ....observe.xla_stats import MemoryBudgetError

        if isinstance(exc, MemoryBudgetError):
            # deterministic refusal: the program does not fit — a
            # replay on the same topology refuses identically
            return FAILURE_POISON
    except ImportError:  # pragma: no cover - partial installs
        pass
    if repeat:
        return FAILURE_POISON
    return FAILURE_TRANSIENT


def dead_ranks_from_cluster(url: str, timeout_s: float = 2.0
                            ) -> Callable[[], List[int]]:
    """Build a ``dead_ranks_fn`` (for :class:`ElasticSupervisor` or
    :class:`~paddle_tpu_torch.ckpt.KVBarrier`) polling rank 0's aggregated
    ``GET /metrics/cluster`` route.  Unreachable aggregator = no
    verdict (empty list): liveness decisions need positive evidence."""
    import urllib.request

    base = url.rstrip("/")
    if not base.startswith("http"):
        base = "http://" + base

    def fn() -> List[int]:
        try:
            with urllib.request.urlopen(f"{base}/metrics/cluster",
                                        timeout=timeout_s) as r:
                doc = json.load(r)
            return [int(x) for x in (doc.get("dead_ranks") or [])]
        except Exception:  # noqa: BLE001 - no evidence, no verdict
            return []

    return fn


class Topology:
    """The live world the current attempt runs on: which ranks exist.
    Mesh/axis layout is ``train_fn``'s business (it knows its model);
    the supervisor only tracks membership."""

    def __init__(self, world_size: Optional[int] = None,
                 ranks: Optional[Sequence[int]] = None):
        if ranks is not None:
            self.ranks = sorted(int(r) for r in ranks)
        else:
            self.ranks = list(range(int(world_size or 1)))
        self.world_size = len(self.ranks)

    def without(self, dead: Sequence[int]) -> "Topology":
        gone = {int(r) for r in dead}
        return Topology(ranks=[r for r in self.ranks if r not in gone])

    def __repr__(self) -> str:
        return f"Topology(world_size={self.world_size}, ranks={self.ranks})"


class SupervisorResult:
    """What a survived run looks like: the full loss trajectory
    (replayed steps overwrite their first emission, so it matches an
    uninterrupted run), restart accounting, and the last-built train
    program (``.train`` — read final state from it)."""

    def __init__(self):
        self.losses: List[float] = []
        self.restarts = 0
        self.reshards = 0
        self.preflight_retries = 0
        self.status = "ok"            # "ok" | "recovered"
        self.history: List[dict] = []
        self.final_world_size = 0
        self.final_step = 0
        self.steps_per_sec = 0.0      # of the final (successful) attempt
        self.train = None

    def to_dict(self) -> dict:
        return {"status": self.status, "restarts": self.restarts,
                "reshards": self.reshards,
                "preflight_retries": self.preflight_retries,
                "final_world_size": self.final_world_size,
                "final_step": self.final_step,
                "steps_per_sec": round(self.steps_per_sec, 3),
                "history": self.history}


class _FnProgram:
    """Adapter: a bare ``fn(step_index, batch) -> loss`` as a program
    with no checkpointable state."""

    def __init__(self, fn):
        self._fn = fn
        self._step = 0

    def step(self, batch):
        self._step += 1
        return self._fn(self._step, batch)


class ElasticSupervisor:
    """See module docstring.  ``max_restarts`` / ``backoff_s`` /
    ``preflight_timeout_s`` default from ``FLAGS_elastic_max_restarts``
    / ``FLAGS_elastic_backoff_s`` / ``FLAGS_elastic_preflight_timeout_s``.

    ``manager`` (on :meth:`run`) may be a
    :class:`~paddle_tpu_torch.ckpt.CheckpointManager`, a factory
    ``f(topology) -> CheckpointManager`` (rebuilt per attempt — the
    multi-rank case, where world size is part of the manager), or
    ``None`` (no checkpointing: a failure replays from step 1).
    ``cluster_fn`` (a zero-arg callable returning the
    ``/metrics/cluster`` document) or ``cluster_url`` wires dead-rank
    detection; ``watchdog_timeout_s > 0`` arms the stall watchdog over
    the supervisor's own step window."""

    def __init__(self, total_steps: Optional[int] = None,
                 world_size: int = 1,
                 max_restarts: Optional[int] = None,
                 backoff_s: Optional[float] = None,
                 preflight: bool = True,
                 preflight_attempts: int = 2,
                 preflight_timeout_s: Optional[float] = None,
                 preflight_probe_code: Optional[str] = None,
                 watchdog_timeout_s: float = 0.0,
                 cluster_fn: Optional[Callable[[], dict]] = None,
                 cluster_url: Optional[str] = None,
                 cluster_poll_s: float = 1.0,
                 save_every: int = 1,
                 postmortem_dir: Optional[str] = None,
                 sleep_fn: Callable[[float], None] = time.sleep):
        self.total_steps = total_steps
        self.initial_world_size = int(world_size)
        self.max_restarts = int(_flags.flag("elastic_max_restarts")
                                if max_restarts is None else max_restarts)
        self.backoff_s = float(_flags.flag("elastic_backoff_s")
                               if backoff_s is None else backoff_s)
        self.preflight = bool(preflight)
        self.preflight_attempts = int(preflight_attempts)
        self.preflight_timeout_s = preflight_timeout_s
        self.preflight_probe_code = preflight_probe_code
        self.watchdog_timeout_s = float(watchdog_timeout_s)
        if cluster_fn is None and cluster_url:
            url_fn = dead_ranks_from_cluster(cluster_url)
            cluster_fn = lambda: {"dead_ranks": url_fn()}  # noqa: E731
        self.cluster_fn = cluster_fn
        self.cluster_poll_s = float(cluster_poll_s)
        self.save_every = int(save_every)
        self.postmortem_dir = postmortem_dir
        self.sleep_fn = sleep_fn
        # per-attempt step-window progress the watchdog samples
        self._progress = {"dispatched": 0, "drained": 0}
        self._step_t0: Optional[float] = None
        self._current_step = 0
        self._watchdog = None
        self._stall_bundles: List[str] = []
        self._stalled = None

    # -- watchdog over the supervisor's own step window -----------------
    def _progress_fn(self) -> Dict:
        p = dict(self._progress)
        inflight = max(p["dispatched"] - p["drained"], 0)
        out = {"dispatched": p["dispatched"], "drained": p["drained"],
               "inflight": inflight}
        t0 = self._step_t0
        if inflight and t0 is not None:
            out["oldest_inflight_age_s"] = round(
                time.perf_counter() - t0, 3)
        return out

    def _start_watchdog(self) -> None:
        if self.watchdog_timeout_s <= 0:
            return
        import threading

        from ....observe.health import StallWatchdog

        self._stalled = threading.Event()

        def on_stall(bundle: str) -> None:
            self._stall_bundles.append(bundle)
            self._stalled.set()

        self._watchdog = StallWatchdog(
            timeout_s=self.watchdog_timeout_s,
            directory=self.postmortem_dir,
            progress_fn=self._progress_fn, on_stall=on_stall)
        self._watchdog.start()

    def _stop_watchdog(self) -> None:
        if self._watchdog is not None:
            self._watchdog.stop()
            self._watchdog = None

    # -- cluster / dead-rank polling ------------------------------------
    def _poll_dead_ranks(self) -> List[int]:
        if self.cluster_fn is None:
            return []
        try:
            doc = self.cluster_fn() or {}
        except Exception:  # noqa: BLE001 - no evidence, no verdict
            return []
        return [int(r) for r in (doc.get("dead_ranks") or [])]

    # -- per-attempt plumbing -------------------------------------------
    @staticmethod
    def _wrap_program(obj):
        if hasattr(obj, "step"):
            return obj
        if callable(obj):
            return _FnProgram(obj)
        raise TypeError(
            f"train_fn must return an object with .step(batch) or a "
            f"callable, got {type(obj).__name__}")

    @staticmethod
    def _fresh_iterator(loader):
        if loader is None:
            return None
        from ....ckpt import ResumableIterator

        it = loader if isinstance(loader, ResumableIterator) \
            else ResumableIterator(loader)
        # reset BEFORE restore: a failed attempt left the iterator
        # mid-epoch, and without a checkpoint to fast-forward from the
        # replay must start at batch 0, not wherever the crash left it
        it.set_state_dict(None)
        return it

    def _manager_for(self, manager, topo):
        if manager is None:
            return None, False
        if callable(manager) and not hasattr(manager, "save"):
            return manager(topo), True
        return manager, False

    @staticmethod
    def _quiesce() -> None:
        """Drain every live executor window and pending async save:
        the next attempt must observe completed steps and committed
        (or cleanly failed) checkpoints only."""
        try:
            from ....framework.executor import quiesce_all

            quiesce_all(raise_errors=False)
        except ImportError:  # pragma: no cover - partial installs
            pass

    def _cleanup_attempt(self, prog, mgr, owns_mgr: bool,
                         reshard: bool) -> None:
        self._stop_watchdog()
        self._quiesce()
        if prog is not None and hasattr(prog, "close"):
            try:
                prog.close()
            except Exception:  # noqa: BLE001
                pass
        if mgr is not None and owns_mgr:
            try:
                mgr.close()
            except Exception:  # noqa: BLE001 - background save error
                pass            # already classified via the attempt
        if reshard:
            # re-init hook: drop every live executor's compiled caches
            # so the rebuild on the NEW topology starts clean
            try:
                from ....framework.executor import close_all

                close_all()
            except ImportError:  # pragma: no cover
                pass

    # -- the loop --------------------------------------------------------
    def run(self, train_fn, manager=None, loader=None,
            total_steps: Optional[int] = None) -> SupervisorResult:
        total = int(self.total_steps if total_steps is None
                    else total_steps)
        if total <= 0:
            raise ValueError("ElasticSupervisor needs total_steps > 0")
        result = SupervisorResult()
        losses: Dict[int, float] = {}
        topo = Topology(self.initial_world_size)
        restarts = 0
        last_sig = None
        history: List[dict] = []
        _flight.record("elastic/start", total_steps=total,
                       world_size=topo.world_size,
                       max_restarts=self.max_restarts)
        while True:
            rec = {"attempt": len(history), "world_size": topo.world_size,
                   "ts": time.time()}
            prog = mgr = it = None
            owns_mgr = False
            prev_fault_hook = None
            hook_installed = False
            self._progress = {"dispatched": 0, "drained": 0}
            self._step_t0 = None
            self._current_step = 0
            self._stall_bundles = []
            steps_done = 0
            t_attempt = time.perf_counter()
            last_cluster_poll = 0.0
            try:
                if self.preflight:
                    v = preflight_device(
                        attempts=self.preflight_attempts,
                        timeout_s=self.preflight_timeout_s,
                        backoff_s=self.backoff_s,
                        probe_code=self.preflight_probe_code,
                        sleep_fn=self.sleep_fn)
                    result.preflight_retries += max(v.attempts - 1, 0)
                    if not v.ok:
                        raise PreflightError(v)
                prog = self._wrap_program(train_fn(topo))
                mgr, owns_mgr = self._manager_for(manager, topo)
                scope = getattr(prog, "scope", None)
                start = 0
                if mgr is not None and scope is None and not (
                        hasattr(prog, "state")
                        and hasattr(prog, "load_state")):
                    # a stateless program (bare callable) has nothing
                    # to checkpoint: run unsupervised-checkpointing
                    # instead of crashing the first save (and then
                    # reading as a poison step)
                    _flight.record("elastic/ckpt_skipped",
                                   reason="program has no scope and no "
                                          "state()/load_state()")
                    if owns_mgr:
                        mgr.close()
                    mgr, owns_mgr = None, False
                if mgr is not None:
                    it = self._fresh_iterator(loader)
                    if it is not None:
                        mgr.register("data", it)
                    for name, comp in (getattr(prog, "components", None)
                                       or {}).items():
                        mgr.register(name, comp)
                    # chain the chaos hook in FRONT of any caller-
                    # installed fault hook, and restore the caller's
                    # when the attempt ends — the supervisor must not
                    # silently eat a reused manager's own hook
                    prev_fault_hook = getattr(mgr, "_fault_hook", None)

                    def _hook(phase, step, _prev=prev_fault_hook):
                        chaos.checkpoint_fault_hook(phase, step)
                        if _prev is not None:
                            _prev(phase, step)

                    mgr.set_fault_hook(_hook)
                    hook_installed = True
                    # the port places restored state on a device: the
                    # program's own (``device``), else the card
                    device = getattr(prog, "device", None)
                    if scope is not None:
                        meta = mgr.restore(scope=scope, device=device)
                    else:
                        meta = mgr.restore(device=device)
                        if meta is not None and hasattr(prog, "load_state"):
                            prog.load_state(meta.get("state") or {})
                    if meta is not None:
                        start = int(meta["step"])
                        stat_add("elastic_restores")
                elif loader is not None:
                    it = self._fresh_iterator(loader)
                stat_set("elastic_world_size", topo.world_size)
                self._start_watchdog()
                _flight.record("elastic/attempt", attempt=len(history),
                               start_step=start,
                               world_size=topo.world_size)
                for step in range(start + 1, total + 1):
                    self._current_step = step
                    now = time.monotonic()
                    if self.cluster_fn is not None and \
                            now - last_cluster_poll >= self.cluster_poll_s:
                        last_cluster_poll = now
                        dead = [r for r in self._poll_dead_ranks()
                                if r in topo.ranks]
                        if dead:
                            raise DeadRankDetected(dead)
                    self._progress["dispatched"] += 1
                    self._step_t0 = time.perf_counter()
                    chaos.step_hook(step, topology=topo)
                    batch = next(it) if it is not None else None
                    loss = prog.step(batch)
                    self._progress["drained"] += 1
                    self._step_t0 = None
                    steps_done += 1
                    if loss is not None:
                        losses[step] = float(loss)
                    if self._stalled is not None and self._stalled.is_set():
                        raise StallDetected(
                            step, self._stall_bundles[-1]
                            if self._stall_bundles else None)
                    if mgr is not None and self.save_every > 0 \
                            and step % self.save_every == 0:
                        if scope is not None:
                            mgr.save(step, scope=scope)
                        else:
                            mgr.save(step, state=prog.state())
                if mgr is not None:
                    mgr.wait()
                    if hook_installed:
                        mgr.set_fault_hook(prev_fault_hook)
                self._stop_watchdog()
                dt = time.perf_counter() - t_attempt
                result.steps_per_sec = steps_done / dt if dt > 0 else 0.0
                result.restarts = restarts
                result.reshards = sum(1 for h in history
                                      if h.get("kind") == FAILURE_TOPOLOGY)
                result.status = "recovered" if restarts else "ok"
                result.history = history
                result.final_world_size = topo.world_size
                result.final_step = total
                result.losses = [losses[s] for s in range(1, total + 1)
                                 if s in losses]
                result.train = prog
                if restarts:
                    stat_add("elastic_runs_recovered")
                _flight.record("elastic/done", status=result.status,
                               restarts=restarts,
                               world_size=topo.world_size)
                if mgr is not None and owns_mgr:
                    try:
                        mgr.close()
                    except Exception:  # noqa: BLE001
                        pass
                return result
            except Exception as e:  # noqa: BLE001 - the whole point
                dead = []
                if isinstance(e, chaos.RankKilled):
                    dead = [e.rank]
                elif isinstance(e, DeadRankDetected):
                    dead = list(e.ranks)
                else:
                    dead = [r for r in self._poll_dead_ranks()
                            if r in topo.ranks]
                sig = (self._current_step, type(e).__name__,
                       str(e)[:200])
                repeat = sig == last_sig
                last_sig = sig
                kind = classify_failure(e, dead_ranks=dead, repeat=repeat)
                err = f"{type(e).__name__}: {e}"[:300]
                rec.update(kind=kind, step=self._current_step,
                           error=err, dead_ranks=dead)
                history.append(rec)
                stat_add("elastic_failures")
                _flight.record("elastic/failure", kind=kind,
                               step=self._current_step, error=err,
                               dead_ranks=dead,
                               world_size=topo.world_size)
                try:
                    from ....observe.health import dump_postmortem

                    rec["postmortem"] = dump_postmortem(
                        f"elastic_{kind}", directory=self.postmortem_dir,
                        exc=(type(e), e, e.__traceback__),
                        extra={"restart_history": history,
                               "world_size": topo.world_size})
                except Exception:  # noqa: BLE001 - diagnosis best-effort
                    pass
                if mgr is not None and hook_installed:
                    try:
                        mgr.set_fault_hook(prev_fault_hook)
                    except Exception:  # noqa: BLE001
                        pass
                self._cleanup_attempt(prog, mgr, owns_mgr,
                                      reshard=kind == FAILURE_TOPOLOGY)
                if kind == FAILURE_POISON:
                    stat_add("elastic_terminal_failures")
                    _flight.record("elastic/terminal", reason="poison",
                                   step=self._current_step)
                    raise ElasticTerminated(
                        f"poison step {self._current_step}: replaying "
                        f"cannot help ({err}); restart history: "
                        f"{len(history)} attempt(s)", history) from e
                restarts += 1
                stat_add("elastic_restarts")
                if restarts > self.max_restarts:
                    stat_add("elastic_terminal_failures")
                    _flight.record("elastic/terminal", reason="budget",
                                   restarts=restarts)
                    raise ElasticTerminated(
                        f"restart budget exhausted ({self.max_restarts} "
                        f"restarts; FLAGS_elastic_max_restarts); last "
                        f"failure: {err}; restart history: "
                        f"{len(history)} attempt(s)", history) from e
                if kind == FAILURE_TOPOLOGY:
                    topo = topo.without(dead or [max(topo.ranks)])
                    if topo.world_size <= 0:
                        stat_add("elastic_terminal_failures")
                        raise ElasticTerminated(
                            "no live ranks left to re-shard onto",
                            history) from e
                    stat_add("elastic_reshards")
                    _flight.record("elastic/reshard", dead_ranks=dead,
                                   world_size=topo.world_size)
                backoff = self.backoff_s * (2 ** (restarts - 1))
                _flight.record("elastic/restart", attempt=len(history),
                               backoff_s=backoff,
                               world_size=topo.world_size)
                if backoff > 0:
                    self.sleep_fn(backoff)
