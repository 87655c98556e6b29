"""Device-state extraction for checkpoints: scope -> host tensors.

Counterpart of ``paddle_tpu/ckpt/state.py``.  The step boundary is the
only moment the training state is consistent, so ``snapshot_scope`` runs
there on the caller's thread, after every live Executor's in-flight
window drained (a pending NaN-scan failure raises before anything is
written).

The JAX package can hand its background writer references to the scope's
arrays, because its compiled step donates and replaces them.  The port's
captured step writes new state into the same tensors, so the next replay
would overwrite what a writer is still reading: a snapshot takes the
bytes before the caller can enqueue another step.  On the card
(``take_snapshot``, the checkpoint manager's path) every state tensor is
cloned on the device, on the stream the steps run on (BERT-base's 1.6 GB
with AdamW's moments: about 1 ms at the card's memory rate), and the
clones are copied to pinned host buffers on a side stream, with an event
the writer thread waits on; the clones are released to the allocator at
once, recorded on the side stream, so their memory returns when the
copies end.  ``snapshot_scope`` waits for that
event and returns the host tensors.

Host values are CPU tensors (numpy holds no bfloat16 or float8 without
``ml_dtypes``); the scope's ``torch.Generator`` becomes a
:class:`GeneratorState`.  ``restore_scope`` places values on the caller's
device (the card unless told otherwise) and rebuilds the generator there;
a value that rebinds a var of a captured step is copied into the graph's
buffer at its next replay, by the executor's identity check.

A scope whose last scanned step failed the NaN scan is refused until a
restore replaces its state, so no poisoned checkpoint is written.

Layer-scanned state (``framework/passes.py`` ``LayerScanPass``), as in
the JAX package: a snapshot of the whole scope leaves the
``@LAYER_STACK@`` carriers out and takes each member through its
``StackedParamRef`` view (the carrier's slice, cloned like any card
tensor), so checkpoints hold per-layer names whether the run was scanned
or not.  A restore writes concrete per-layer tensors over the views; the
next scanned dispatch copies them into the live carrier
(``LayerScanPlan.ensure_stacked``) and an unrolled one reads them as they
are, so a checkpoint crosses the scan flag in both directions.  The
pipeline's packed view (``PackedParamRef``) comes with the
several-process slice.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..framework.place import DeviceLike, default_device
from ..framework.scope import StackedParamRef, to_tensor

RNG_VAR = "@RNG_KEY@"


class LocalShard:
    """This process's contiguous block of a globally sharded value:
    ``array`` (a host tensor), the full value's ``global_shape`` and the
    block's per-dimension ``origin`` (None: an axis-0 block, placed in
    rank order).  A several-process manager writes each rank's block and
    re-assembles the full value at restore; a single-process one refuses
    a partial shard."""

    __slots__ = ("array", "global_shape", "origin")

    def __init__(self, array, global_shape, origin=None):
        self.array = to_tensor(array).cpu()
        self.global_shape = tuple(int(d) for d in global_shape)
        self.origin = (tuple(int(o) for o in origin)
                       if origin is not None else None)

    @property
    def dtype(self):
        return self.array.dtype

    def __repr__(self):
        o = f", origin={self.origin}" if self.origin is not None else ""
        return (f"LocalShard(block={tuple(self.array.shape)}, "
                f"global={self.global_shape}{o})")


class GeneratorState:
    """A ``torch.Generator``'s state (``get_state()``, a uint8 tensor)
    and the device type it belongs to."""

    __slots__ = ("state", "device")

    def __init__(self, state: torch.Tensor, device: str):
        self.state = state
        self.device = str(device)

    def generator(self, device: torch.device) -> torch.Generator:
        if torch.device(device).type != self.device:
            from .manager import CheckpointError

            raise CheckpointError(
                f"a {self.device} generator's state cannot seed a "
                f"generator on {device}")
        gen = torch.Generator(device=device)
        gen.set_state(self.state)
        return gen

    def __repr__(self):
        return f"GeneratorState({self.device}, {self.state.numel()} bytes)"


class _Pending:
    """Host tensors whose copies from the card, on side stream
    ``stream``, end at ``event``."""

    __slots__ = ("values", "event", "stream")

    def __init__(self, values, event=None, stream=None):
        self.values = values
        self.event = event
        self.stream = stream

    def wait(self) -> Dict[str, object]:
        if self.event is not None:
            self.event.synchronize()
            self.event = None
        return self.values


def _check_poison(scope) -> None:
    s = scope
    while s is not None:
        msg = getattr(s, "_nan_poisoned", None)
        if msg:
            from .manager import CheckpointError

            raise CheckpointError(
                f"refusing to snapshot a scope written by a step that "
                f"failed the NaN scan ({msg}); restore a checkpoint first")
        s = s._parent


def _pinned_views(cards, pinned: dict) -> dict:
    """name -> a pinned host tensor for each (name, card tensor): views
    of one flat pinned buffer (one host allocation, no size rounding),
    kept in ``pinned`` and reused while the layout stays the same."""
    layout = tuple((n, tuple(v.shape), v.dtype) for n, v in cards)
    if pinned.get("layout") != layout:
        offsets, total = [], 0
        for _n, v in cards:
            offsets.append(total)
            total += -(-v.numel() * v.element_size() // 64) * 64
        flat = torch.empty(total, dtype=torch.uint8, pin_memory=True)
        pinned.clear()
        pinned["layout"] = layout
        pinned["views"] = {
            n: flat[o:o + v.numel() * v.element_size()].view(v.dtype)
            .view(v.shape) for (n, v), o in zip(cards, offsets)}
    return pinned["views"]


def zero_block(scope, name: str):
    """(global shape, origin) when ``scope`` holds ``name`` as this rank's
    block of a ZeRO-1 sharded accumulator, else None."""
    s = scope
    while s is not None:
        if name in s._vars:
            info = s.zero_blocks.get(name)
            v = s._vars[name]
            if info is not None and isinstance(v, torch.Tensor) \
                    and tuple(v.shape) != tuple(info[0]):
                return info
            return None
        s = s._parent
    return None


def take_snapshot(scope, var_names: Optional[Sequence[str]] = None,
                  pinned=None, stream=None,
                  shards_only: bool = False) -> _Pending:
    """The scope's state, with the card's copies still in flight.

    ``pinned`` (a dict the snapshot fills with its pinned buffer, reused
    by the next snapshot given the same dict while the state's layout
    holds) and ``stream`` (the side stream of the copies) let the
    checkpoint manager reuse its buffers across saves.  A rank's block
    of a sharded accumulator comes back as a :class:`LocalShard`; with
    ``shards_only`` nothing else is taken."""
    from ..framework.executor import drain_all

    drain_all()
    _check_poison(scope)
    if var_names is None:
        # the carriers' bytes are the members' views taken below: saving
        # both would double the checkpoint and tie it to the scan flag
        from ..framework.passes import LAYER_STACK_PREFIX

        var_names = [n for n in scope.local_var_names()
                     if not n.startswith(LAYER_STACK_PREFIX)]
    out: Dict[str, object] = {}
    cards = []
    blocks = {}
    for n in var_names:
        info = zero_block(scope, n)
        if info is not None:
            blocks[n] = info
        elif shards_only:
            continue
        v = scope.get_var(n) if scope.has_var(n) else None
        if isinstance(v, StackedParamRef):
            v = v.device_value()
        if isinstance(v, torch.Generator):
            out[n] = GeneratorState(v.get_state().clone(), v.device.type)
        elif isinstance(v, torch.Tensor):
            if v.device.type == "cuda":
                cards.append((n, v))
            else:
                out[n] = v.detach().clone()
    if not cards:
        return _Pending(_as_shards(out, blocks))
    dev = cards[0][1].device
    cur = torch.cuda.current_stream(dev)
    clones = [(n, v.detach().clone()) for n, v in cards]
    side = stream if stream is not None else torch.cuda.Stream(dev)
    side.wait_stream(cur)
    views = _pinned_views(cards, {} if pinned is None else pinned)
    with torch.cuda.stream(side):
        for n, c in clones:
            views[n].copy_(c, non_blocking=True)
            c.record_stream(side)   # freed now, reused after the copy
            out[n] = views[n]
    del clones
    event = torch.cuda.Event()
    event.record(side)
    return _Pending(_as_shards(out, blocks), event, side)


def _as_shards(out, blocks):
    """``out`` with each name of ``blocks`` a :class:`LocalShard` of its
    host tensor."""
    for n, (shape, origin) in blocks.items():
        if n in out:
            out[n] = LocalShard(out[n], shape, origin)
    return out


def snapshot_scope(scope, var_names: Optional[Sequence[str]] = None
                   ) -> Dict[str, object]:
    """Copy the scope's state to the host: name -> CPU tensor, the
    generator as a :class:`GeneratorState`.  ``var_names=None`` takes
    every local variable (parameters, optimizer slots, AMP loss-scale
    state, the generator: the executor writes nothing else back).
    Every live Executor's window is drained first."""
    return take_snapshot(scope, var_names).wait()


def restore_scope(scope, state: Dict[str, object],
                  var_names: Optional[Sequence[str]] = None,
                  device: DeviceLike = None) -> list:
    """Write restored host values into the scope, on ``device`` (the card
    unless told otherwise); a :class:`GeneratorState` becomes a generator
    there.  The JAX package's ``@RNG_KEY@`` (a uint32 key array) cannot
    seed a torch generator and is refused by name.  Returns the names
    written."""
    from .manager import CheckpointError

    dev = default_device(device)
    names = set(var_names) if var_names is not None else None
    restored = []
    for n, v in state.items():
        if names is not None and n not in names:
            continue
        if isinstance(v, GeneratorState):
            v = v.generator(dev)
        elif n == RNG_VAR:
            raise CheckpointError(
                f"var {RNG_VAR!r} holds {type(v).__name__} "
                f"{getattr(v, 'dtype', '')} values, not a torch.Generator "
                f"state: a JAX PRNG key cannot seed the port's generator; "
                f"restore with var_names that leave {RNG_VAR!r} out")
        elif isinstance(v, LocalShard):
            raise CheckpointError(
                f"var {n!r} is a partial shard {v!r}: a single-process "
                f"scope cannot hold it")
        else:
            v = to_tensor(v if isinstance(v, torch.Tensor)
                          else np.asarray(v)).to(dev)
        scope.set_var(n, v)
        restored.append(n)
    s = scope
    while s is not None:
        s._nan_poisoned = None
        s = s._parent
    return restored
