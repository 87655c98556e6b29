"""Scope: runtime variable storage (name -> torch tensor).

Counterpart of ``paddle_tpu/framework/scope.py``.  Values are tensors on
the executor's device; a Scope is a flat dict with an optional parent
chain, as in the JAX package.  ``StackedParamRef`` is the per-layer view
into a layer-stacked carrier (``framework/passes.py`` ``LayerScanPass``);
the pipeline's packed view, ``PackedParamRef``, belongs to the
several-process slice of the port.

``scope_from_numpy`` builds a Scope from host arrays, e.g. the JAX
package's scope after its startup program: the two packages draw random
numbers with different generators, so a comparison starts both from the
same values.  Anything ``np.asarray`` reads is taken, the JAX package's
carriers and ``StackedParamRef`` views included.
"""
from __future__ import annotations

import itertools
from typing import Dict, Optional

import numpy as np
import torch

from .place import DeviceLike, default_device


def to_tensor(value, device: Optional[torch.device] = None) -> torch.Tensor:
    """``value`` as a tensor on ``device`` (numpy arrays, bfloat16 ones
    from ``ml_dtypes`` included); a tensor passes through when it is
    already there."""
    if not isinstance(value, torch.Tensor):
        arr = np.asarray(value)
        if not arr.flags.c_contiguous:  # (ascontiguousarray makes 0-d 1-d)
            arr = np.ascontiguousarray(arr)
        if not arr.flags.writeable:  # torch tensors are always writable
            arr = arr.copy()
        if arr.dtype.name == "bfloat16":
            value = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        elif arr.dtype.name == "float8_e4m3fn":
            value = torch.from_numpy(arr.view(np.uint8)).view(
                torch.float8_e4m3fn)
        else:
            value = torch.from_numpy(arr)
    if device is not None and value.device != device:
        value = value.to(device)
    return value


def to_numpy(value) -> np.ndarray:
    """Host copy of a tensor (bfloat16 and float8_e4m3fn as the
    ``ml_dtypes`` types of those names)."""
    if not isinstance(value, torch.Tensor):
        return np.asarray(value)
    t = value.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    if t.dtype == torch.float8_e4m3fn:
        import ml_dtypes

        return t.view(torch.uint8).numpy().view(ml_dtypes.float8_e4m3fn)
    return t.numpy()


class _TensorView:
    """Minimal ``.get_tensor()`` compatibility object."""

    def __init__(self, scope: "Scope", name: str):
        self._scope = scope
        self._name = name

    def set(self, array, place=None):
        self._scope.set_var(self._name, array, place)

    def shape(self):
        return list(self._scope.get_var(self._name).shape)

    def __array__(self, dtype=None, copy=None):
        arr = to_numpy(self._scope.get_var(self._name))
        return arr.astype(dtype) if dtype is not None else arr


class _VarView:
    def __init__(self, scope: "Scope", name: str):
        self._scope = scope
        self._name = name

    def get_tensor(self) -> _TensorView:
        return _TensorView(self._scope, self._name)


class StackedParamRef:
    """Per-layer view into a layer-stacked state tensor.

    ``LayerScanPass`` (framework/passes.py) stacks per-layer weights and
    optimizer slots into one ``(num_layers, *shape)`` carrier per family,
    held in the scope under an ``@LAYER_STACK@`` name, so that a
    ``layer_scan`` op reads layer ``k`` as the view ``carrier[k]``.  The
    scope keeps serving the per-layer names through this view: reading
    it (``np.asarray``: checkpoints, ``paddle.save``, tests) copies layer
    ``index`` of the carrier to the host, ``device_value()`` is the live
    slice on the device; writing a concrete tensor over it (a restore, an
    unrolled edge layer's update) makes
    ``LayerScanPlan.ensure_stacked`` copy it into the carrier before the
    next step, so checkpoints stay per-layer across the scan flag.
    """

    __slots__ = ("_scope", "stack_name", "index", "shape", "dtype")

    def __init__(self, scope, stack_name, index, shape, dtype):
        self._scope = scope
        self.stack_name = stack_name
        self.index = int(index)
        self.shape = torch.Size(int(d) for d in shape)
        self.dtype = dtype

    def device_value(self) -> torch.Tensor:
        """The layer's slice of the carrier: a view, no copy."""
        return self._scope.get_var(self.stack_name)[self.index]

    def __array__(self, dtype=None, copy=None):
        arr = to_numpy(self.device_value()).reshape(tuple(self.shape))
        return arr.astype(dtype) if dtype is not None else arr

    def __repr__(self):
        return (f"StackedParamRef({self.stack_name!r}[{self.index}], "
                f"shape={tuple(self.shape)}, dtype={self.dtype})")


_scope_serial = itertools.count()


class Scope:
    def __init__(self, parent: Optional["Scope"] = None):
        self._vars: Dict[str, object] = {}
        self._parent = parent
        self._kids = []
        # monotone id for executor caches: id() of a GC'd scope can be
        # recycled by a new scope and silently serve stale analysis
        self.serial = next(_scope_serial)
        # the NaN scan's message when a step that wrote this scope failed
        # it: ckpt.snapshot_scope refuses such a scope until a restore
        self._nan_poisoned: Optional[str] = None
        # ZeRO-1: name -> (global shape, origin) of each var this scope
        # holds as one rank's block of a sharded accumulator
        # (executor._cut_zero_blocks); a checkpoint writes such a var as
        # a LocalShard while its shape differs from the global one
        self.zero_blocks: Dict[str, tuple] = {}

    # -- core -------------------------------------------------------------
    def has_var(self, name: str) -> bool:
        return name in self._vars or (self._parent is not None
                                      and self._parent.has_var(name))

    def get_var(self, name: str):
        s = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s._parent
        raise KeyError(f"variable {name!r} not found in scope")

    def set_var(self, name: str, value, place=None):
        """Store ``value``; host arrays become tensors, moved to
        ``place``'s device when one is given."""
        if value is not None and not isinstance(
                value, (torch.Generator, StackedParamRef)):
            value = to_tensor(value, None if place is None
                              else place.torch_device())
        self._vars[name] = value

    def erase(self, name: str):
        self._vars.pop(name, None)

    def local_var_names(self):
        return list(self._vars)

    def new_scope(self) -> "Scope":
        """A child scope: it reads its parent's vars and keeps what it
        sets to itself."""
        kid = Scope(self)
        self._kids.append(kid)
        return kid

    def drop_kids(self):
        self._kids.clear()

    # -- reference-api compatibility --------------------------------------
    def var(self, name: str) -> _VarView:
        self._vars.setdefault(name, None)
        return _VarView(self, name)

    def find_var(self, name: str) -> Optional[_VarView]:
        return _VarView(self, name) if self.has_var(name) else None


def scope_from_numpy(arrays: Dict[str, np.ndarray],
                     device: DeviceLike = None) -> Scope:
    """A Scope holding ``arrays`` as tensors on ``device`` (the CUDA card
    unless the caller asks for the CPU), each with its own dtype."""
    dev = default_device(device)
    scope = Scope()
    for name, arr in arrays.items():
        scope.set_var(name, to_tensor(arr, dev))
    return scope


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


def _switch_scope(scope: Scope) -> Scope:
    """Make ``scope`` the global scope; returns the one it replaces
    (``fluid.scope_guard`` and the inference ``Predictor`` load into a
    scope of their own this way)."""
    global _global_scope
    old, _global_scope = _global_scope, scope
    return old
