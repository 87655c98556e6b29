"""Fault injection -- PyTorch port of
``paddle_tpu/distributed/fleet/elastic/chaos.py`` (no JAX in it), the
module the port's disaggregated-serving router (``serving/disagg.py``)
consults for ``kill_prefill_replica``; its hook reads
``sys.modules.get("paddle_tpu_torch.distributed.fleet.elastic.chaos")``,
this module; the elastic supervisor (``supervisor.py``) consults the
other faults.

Recovery paths that are only exercised when real hardware dies are
recovery paths that have silently rotted by the time they matter.  This
module keeps a small process-wide armory of *injectable* faults that
the hook points -- and nothing else -- consult, so every classified
failure mode is driven by tests:

- ``kill_rank_mid_step``   (params ``rank``, ``at_step``): raises
  :class:`RankKilled` from the supervisor's step hook — the
  topology-change path (re-shard + elastic restore).
- ``hang_device_call``     (params ``at_step``, ``seconds``): sleeps
  inside the in-flight step window so the stall watchdog trips — the
  transient path (postmortem bundle + restart in place).
- ``torn_checkpoint``      (params ``at_step``): raises from the
  checkpoint writer's ``pre_commit`` fault hook, leaving exactly the
  torn ``.tmp`` a killed process would — restore must fall back.
- ``heartbeat_blackhole``  (params ``rank``): the named rank's
  :class:`~paddle_tpu.observe.health.HealthReporter` drops its beats
  so the health plane dead-lists a live process — the
  dead-rank-detection path.
- ``preflight_init_timeout`` (no params): one preflight probe reports
  ``init_timeout`` without spawning the subprocess -- a device whose
  init never completes, on demand.
- ``kill_prefill_replica`` (params ``replica``): the disaggregated
  serving router (``serving/disagg.py``) hard-stops the named prefill
  replica at its handoff hook — the in-flight prefill dies with
  ``ServerClosedError`` and the router's re-dispatch path must finish
  the request on a survivor with zero drops.

Arming is explicit (:func:`inject`) and consumption is counted: a
fault fires ``count`` times then disarms (``count=-1`` = until
:func:`clear`).  Firing is observable — every arm/fire lands in the
flight recorder and on ``chaos_faults_armed`` / ``chaos_faults_fired``.
The module deliberately imports almost nothing: hook points in
low-level code (heartbeats) check ``sys.modules`` for it, so a process
that never imports chaos pays nothing.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

__all__ = ["FAULTS", "RankKilled", "TornCheckpoint", "inject", "clear",
           "armed", "take", "step_hook", "checkpoint_fault_hook"]

FAULTS = ("kill_rank_mid_step", "hang_device_call", "torn_checkpoint",
          "heartbeat_blackhole", "preflight_init_timeout",
          "kill_prefill_replica")


class RankKilled(RuntimeError):
    """An (injected) rank death: the supervisor classifies this as a
    topology change and re-shards onto the survivors."""

    def __init__(self, rank: int, msg: Optional[str] = None):
        super().__init__(msg or f"rank {rank} killed")
        self.rank = int(rank)


class TornCheckpoint(RuntimeError):
    """Injected writer death mid-commit: leaves the torn ``.tmp`` a
    killed process would; restore must fall back to the previous
    intact step."""


_LOCK = threading.Lock()
_ARMED: List[dict] = []  # {"fault": name, "count": n, **params}


def _flight(event: str, **fields) -> None:
    try:
        from ....observe import flight

        flight.record(event, **fields)
    except Exception:  # noqa: BLE001 - chaos must never add real faults
        pass


def inject(fault: str, count: int = 1, **params) -> None:
    """Arm ``fault`` to fire ``count`` times (``-1`` = until
    :func:`clear`).  ``params`` are matched against the hook point's
    context (e.g. ``at_step=4`` fires only at step 4) — a param the
    hook does not supply is treated as fault payload (``rank=1`` on a
    kill names the victim)."""
    if fault not in FAULTS:
        raise KeyError(f"unknown chaos fault {fault!r} (have {FAULTS})")
    with _LOCK:
        _ARMED.append({"fault": fault, "count": int(count), **params})
    from ....monitor import stat_add

    stat_add("chaos_faults_armed")
    _flight("chaos/inject", fault=fault, count=count, **params)


def clear(fault: Optional[str] = None) -> None:
    """Disarm every armed fault (or only ``fault``)."""
    with _LOCK:
        if fault is None:
            _ARMED.clear()
        else:
            _ARMED[:] = [f for f in _ARMED if f["fault"] != fault]


def armed(fault: Optional[str] = None) -> List[dict]:
    """Snapshot of armed faults (tests/debugging)."""
    with _LOCK:
        return [dict(f) for f in _ARMED
                if fault is None or f["fault"] == fault]


def take(fault: str, **ctx) -> Optional[dict]:
    """Consume one firing of ``fault`` whose params match ``ctx``
    (params present in BOTH must be equal; payload-only params pass
    through).  Returns the fault's param dict or ``None``."""
    with _LOCK:
        for f in _ARMED:
            if f["fault"] != fault:
                continue
            if any(k in ctx and f[k] != ctx[k]
                   for k in f if k not in ("fault", "count")):
                continue
            if f["count"] > 0:
                f["count"] -= 1
                if f["count"] == 0:
                    _ARMED.remove(f)
            fired = {k: v for k, v in f.items() if k != "count"}
            break
        else:
            return None
    from ....monitor import stat_add

    stat_add("chaos_faults_fired")
    _flight("chaos/fire", **fired, **{k: v for k, v in ctx.items()
                                      if k not in fired})
    return fired


def step_hook(step: int, topology=None) -> None:
    """The supervisor's per-step hook point, called inside the
    in-flight window (after dispatch accounting, before the train
    step) so a hang here is indistinguishable from a wedged device
    call to the watchdog."""
    f = take("hang_device_call", at_step=step)
    if f is not None:
        time.sleep(float(f.get("seconds", 1.0)))
    f = take("kill_rank_mid_step", at_step=step)
    if f is not None:
        rank = int(f.get("rank", 1))
        raise RankKilled(rank, f"chaos: rank {rank} killed mid-step "
                               f"{step}")


def checkpoint_fault_hook(phase: str, step: int) -> None:
    """Install on a :class:`~paddle_tpu.ckpt.CheckpointManager` via
    ``set_fault_hook`` (the supervisor does): an armed
    ``torn_checkpoint`` kills the writer at ``pre_commit``, leaving
    the torn ``.tmp`` on disk."""
    if phase != "pre_commit":
        return
    f = take("torn_checkpoint", at_step=step)
    if f is not None:
        raise TornCheckpoint(
            f"chaos: checkpoint writer killed pre-commit at step {step}")
