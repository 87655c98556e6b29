"""Resumable data-iterator position for full-state checkpoints.

Counterpart of ``paddle_tpu/ckpt/data.py``, over the port's
``io.DataLoader``.

The reference's auto-checkpoint restores parameters but restarts the
input pipeline from scratch, so a resumed run re-reads batches it
already trained on.  :class:`ResumableIterator` wraps any re-iterable
loader (``paddle_tpu_torch.io.DataLoader``, a list of batches, ...) into an
endless batch stream that tracks ``(epoch, batch)``; its state rides a
:class:`~paddle_tpu_torch.ckpt.CheckpointManager` save (register it as a
component) and restore fast-forwards the underlying loader to the exact
position, so the resumed feed sequence is bitwise the uninterrupted
one.  Determinism contract: the loader must produce the same batch
sequence per epoch (shuffle off, a seeded sampler, or a sampler with
``set_epoch`` — which is called with each epoch number).
"""
from __future__ import annotations

from typing import Optional

__all__ = ["ResumableIterator"]


class ResumableIterator:
    def __init__(self, loader):
        self._loader = loader
        self.epoch = 0
        self.batch = 0          # batches already consumed this epoch
        self._it = None
        self._skip = 0

    # -- iteration --------------------------------------------------------
    def _start_epoch(self) -> None:
        sampler = getattr(self._loader, "batch_sampler", None)
        if sampler is not None and hasattr(sampler, "set_epoch"):
            sampler.set_epoch(self.epoch)
        self._it = iter(self._loader)

    def __iter__(self):
        return self

    def __next__(self):
        if self._it is None:
            self._start_epoch()
            skip, self._skip = self._skip, 0
            for done in range(skip):  # fast-forward after a restore
                try:
                    next(self._it)
                except StopIteration:
                    # The loader is shorter than it was at save time
                    # (dataset shrank / different loader): surfacing the
                    # bare StopIteration would silently END the
                    # consumer's for-loop instead of flagging the stale
                    # checkpoint state.
                    from .manager import CheckpointError

                    # leave a coherent position: a caller that catches
                    # this and keeps iterating restarts THIS epoch from
                    # batch 0 (not half-consumed with a stale counter)
                    self.batch = 0
                    self._it = None
                    raise CheckpointError(
                        f"resume fast-forward exhausted the loader "
                        f"after {done} of {skip} batches (epoch "
                        f"{self.epoch}): the restored iterator position "
                        f"does not fit the current loader") from None
        try:
            b = next(self._it)
        except StopIteration:
            self.epoch += 1
            self.batch = 0
            self._start_epoch()
            b = next(self._it)  # an empty loader raises StopIteration
        self.batch += 1
        return b

    # -- checkpoint component contract ------------------------------------
    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "batch": self.batch}

    def set_state_dict(self, state: Optional[dict]) -> None:
        state = state or {}
        self.epoch = int(state.get("epoch", 0))
        self.batch = int(state.get("batch", 0))
        self._it = None
        self._skip = self.batch
