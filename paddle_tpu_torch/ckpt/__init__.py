"""``paddle_tpu_torch.ckpt`` -- asynchronous, atomic checkpointing.

Counterpart of ``paddle_tpu.ckpt``:

- :class:`CheckpointManager` -- async background writes, atomic
  tmp+manifest+rename commits, SHA-256 integrity, retention GC,
  pending-save coalescing; the JAX package's on-disk layout.
- :func:`snapshot_scope` / :func:`restore_scope` -- the scope's state to
  host tensors on the step boundary and back onto the card;
  :class:`GeneratorState` carries the scope's ``torch.Generator``.
- :class:`ResumableIterator` -- data-iterator position as checkpoint
  state, so resume continues the exact batch sequence.
- :func:`wait_all` -- drain every live manager (``Executor.close()`` and
  interpreter exit call this).

- Several processes: each rank writes its own ``LocalShard`` blocks
  (a ZeRO-1 rank's rows of its optimizer state), rank 0 commits after
  the ``KVBarrier`` (over the fleet KV server) or the group's store
  barrier, and a restore re-assembles the full values at any rank count.
``distributed.checkpoint`` (``save_sharded``/``load_sharded``),
``incubate.checkpoint.auto_checkpoint`` and
``hapi.callbacks.ModelCheckpoint`` are built on this manager.
"""
from .data import ResumableIterator
from .manager import CheckpointError, CheckpointManager, KVBarrier, wait_all
from .state import (GeneratorState, LocalShard, restore_scope,
                    snapshot_scope)

__all__ = [
    "CheckpointManager", "CheckpointError", "KVBarrier", "wait_all",
    "LocalShard", "GeneratorState", "snapshot_scope", "restore_scope",
    "ResumableIterator",
]
