"""Sharded checkpointing over ``paddle_tpu_torch.ckpt``.

Counterpart of ``paddle_tpu/distributed/checkpoint.py``: ``save_sharded``
writes the scope's state as a committed checkpoint step (synchronous: it
returns once the step is durable), called from every process of a job:
each rank writes its own blocks of the ZeRO-1 sharded optimizer state
(``shard_r<k>.npz``), rank 0 the replicated values, and rank 0 commits
the manifest after the barrier (``barrier=``, e.g. a ``ckpt.KVBarrier``
on the fleet KV server; else the live group's store).
``load_sharded`` restores the newest intact one onto the card (or
``device``), the sharded values re-assembled in full; the next executor
run cuts them to the rank count of that run, so a checkpoint written at
one rank count resumes at any other.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

from ..ckpt import CheckpointError, CheckpointManager

# one manager per directory for the process lifetime
_MANAGERS: Dict[str, CheckpointManager] = {}


def _manager(dirname: str) -> CheckpointManager:
    key = os.path.abspath(dirname)
    m = _MANAGERS.get(key)
    if m is None:
        # synchronous by design: save_sharded returns once the
        # checkpoint is durable; CheckpointManager saves asynchronously
        m = _MANAGERS[key] = CheckpointManager(key, async_save=False)
    return m


def save_sharded(scope, dirname, var_names: Optional[Sequence[str]] = None,
                 step: Optional[int] = None, barrier=None):
    """Write the scope's state as a committed checkpoint step under
    ``dirname``; returns the sorted saved variable names.  Call from
    every process of the job.  ``step`` defaults to one past the newest
    committed step in ``dirname``, read from the local listing: with
    several processes on a filesystem whose listings lag, pass the
    training step, which every rank agrees on.  ``barrier`` (a callable
    of a tag, e.g. ``ckpt.KVBarrier``) becomes the directory's manager's
    commit barrier."""
    m = _manager(dirname)
    if barrier is not None:
        m._barrier = barrier
    if step is None:
        step = m.next_step()
    return m.save(step, scope=scope, var_names=var_names, wait=True)


def load_sharded(scope, dirname, var_names: Optional[Sequence[str]] = None,
                 device=None):
    """Restore the newest intact checkpoint under ``dirname`` into the
    scope, on ``device`` (the card unless told otherwise)."""
    dirname = os.path.abspath(dirname)
    if not os.path.isdir(dirname):
        raise CheckpointError(
            f"load_sharded: checkpoint directory {dirname!r} does not "
            f"exist (nothing was ever saved here, or the path is wrong)")
    m = _manager(dirname)
    meta = m.restore(scope=scope, var_names=var_names, device=device)
    if meta is None:
        raise CheckpointError(
            f"load_sharded: {dirname!r} contains no committed "
            f"checkpoint (empty directory, or only torn .tmp saves "
            f"from a crashed run)")
    return list(meta["vars"]) if var_names is None else sorted(
        n for n in meta["vars"] if n in set(var_names))
