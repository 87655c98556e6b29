"""Eager Tensor: a torch tensor with Paddle's autograd surface.

Counterpart of ``paddle_tpu/dygraph/tensor.py``.  The payload is a torch
tensor in ``_value`` (on the place, ``dygraph/base.py``), so code
written against the JAX package's ``Tensor`` keeps working.  The tape is
``torch.autograd``: ``stop_gradient`` is ``not _value.requires_grad``, a
parameter is a leaf that requires grad, ``.grad`` is the leaf's
accumulated ``_value.grad`` (it accumulates over ``backward`` calls until
``clear_grad``, Paddle's semantics), and the graph behind a tensor is its
``_value.grad_fn``.  Operators run the ops' lowering rules through
``eager.run_op``; indexing and casts, which have no IR op here, through
``eager.apply_torch`` (the counterpart of ``apply_jax``).
"""
from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from ..framework import unique_name


def _wrap(value: torch.Tensor) -> "Tensor":
    """A Tensor over ``value`` as it is (an op's output: its autograd
    history is its own)."""
    t = Tensor.__new__(Tensor)
    t._value = value
    t._name = None
    t.persistable = False
    t.trainable = True
    return t


def _unwrap(x):
    return x._value if isinstance(x, Tensor) else x


def _as_torch(value, device=None) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value
    arr = np.asarray(value)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    if device is None:
        from .base import current_device

        device = current_device()
    return torch.as_tensor(arr, device=device)


class Tensor:
    def __init__(self, value, name: Optional[str] = None,
                 stop_gradient: bool = True, persistable: bool = False):
        self._value = _as_torch(value)
        self._name = name
        self.persistable = persistable
        self.trainable = True
        if not stop_gradient:
            self.stop_gradient = False

    # -- basic introspection ------------------------------------------------
    @property
    def name(self) -> str:
        if self._name is None:
            self._name = unique_name.generate("eager_tmp")
        return self._name

    @name.setter
    def name(self, value):
        self._name = value

    @property
    def shape(self):
        return list(self._value.shape)

    @property
    def dtype(self):
        return self._value.dtype

    @property
    def ndim(self):
        return self._value.dim()

    @property
    def size(self):
        return self._value.numel()

    @property
    def is_leaf(self):
        return self._value.grad_fn is None

    @property
    def stop_gradient(self) -> bool:
        if self._value.requires_grad:
            return False
        return self.__dict__.get("_stop", True)

    @stop_gradient.setter
    def stop_gradient(self, value: bool):
        value = bool(value)
        self.__dict__["_stop"] = value
        v = self._value
        if not (v.is_floating_point() or v.is_complex()):
            return
        if value and v.requires_grad:
            self._value = v.detach() if v.grad_fn is not None \
                else v.requires_grad_(False)
        elif not value and not v.requires_grad:
            if v.grad_fn is None:
                v.requires_grad_(True)

    def numpy(self):
        """A copy on the host (bfloat16 as float32, which numpy lacks)."""
        v = self._value.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy().copy() if v.device.type == "cpu" \
            else v.cpu().numpy()

    def item(self, *args):
        return self.numpy().item(*args)

    def __len__(self):
        return int(self._value.shape[0])

    def __repr__(self):
        g = ", stop_gradient=False" if not self.stop_gradient else ""
        return f"Tensor(shape={self.shape}, dtype={self.dtype}{g},\n{self._value})"

    def __bool__(self):
        return bool(self._value.detach())

    def __float__(self):
        return float(self._value.detach())

    def __int__(self):
        return int(self._value.detach())

    def __hash__(self):
        return id(self)

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a.astype(dtype) if dtype is not None else a

    # -- autograd -----------------------------------------------------------
    @property
    def grad(self) -> Optional["Tensor"]:
        g = self._value.grad
        if g is None:
            return None
        w = self.__dict__.get("_grad_tensor")
        if w is None or w._value is not g:
            w = self.__dict__["_grad_tensor"] = _wrap(g)
            w._name = self.name + "@GRAD"
        return w

    @grad.setter
    def grad(self, value):
        self._value.grad = None if value is None else _unwrap(value)

    def backward(self, grad_tensor=None, retain_graph=False):
        from .backward import run_backward

        run_backward([self], [grad_tensor], retain_graph=retain_graph)

    def clear_grad(self):
        self._value.grad = None

    clear_gradient = clear_grad

    def detach(self):
        t = _wrap(self._value.detach())
        t._name = self._name
        return t

    def gradient(self):
        g = self.grad
        return None if g is None else g.numpy()

    def set_value(self, value):
        """Write ``value`` into this tensor (state dict loading): in place
        where the shape is this tensor's, so a parameter stays the leaf it
        was."""
        v = _unwrap(value) if isinstance(value, Tensor) else _as_torch(
            value, self._value.device)
        v = v.to(device=self._value.device, dtype=self._value.dtype)
        if tuple(v.shape) == tuple(self._value.shape) \
                and self._value.grad_fn is None:
            with torch.no_grad():
                self._value.copy_(v)
        else:
            self._value = v.detach().requires_grad_(
                self._value.requires_grad)
        return self

    def _set_raw(self, value):
        self._value = value
        return self

    def block_until_ready(self):
        if self._value.is_cuda:
            torch.cuda.synchronize(self._value.device)
        return self

    # -- op helpers (routed through the eager dispatcher) --------------------
    def _ew(self, other, op_type, reverse=False):
        from .eager import run_op

        if not isinstance(other, Tensor):
            v = self._value
            other = _wrap(torch.full((), other, dtype=v.dtype,
                                     device=v.device)
                          if isinstance(other, (int, float, bool))
                          else _as_torch(other, v.device).to(v.dtype))
        x, y = (other, self) if reverse else (self, other)
        return run_op(op_type, {"X": x, "Y": y}, {"axis": -1})["Out"]

    def __add__(self, o):
        return self._ew(o, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, o):
        return self._ew(o, "elementwise_sub")

    def __rsub__(self, o):
        return self._ew(o, "elementwise_sub", reverse=True)

    def __mul__(self, o):
        return self._ew(o, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._ew(o, "elementwise_div")

    def __rtruediv__(self, o):
        return self._ew(o, "elementwise_div", reverse=True)

    def __pow__(self, o):
        return self._ew(o, "elementwise_pow")

    def __mod__(self, o):
        return self._ew(o, "elementwise_mod")

    def __floordiv__(self, o):
        return self._ew(o, "elementwise_floordiv")

    def __matmul__(self, o):
        from .eager import run_op

        return run_op("matmul_v2", {"X": self, "Y": o}, {})["Out"]

    def __neg__(self):
        from .eager import run_op

        return run_op("scale", {"X": self}, {"scale": -1.0, "bias": 0.0})["Out"]

    def __eq__(self, o):  # noqa: E721 - tensor semantics, like the reference
        return self._ew(o, "equal")

    def __ne__(self, o):
        return self._ew(o, "not_equal")

    def __lt__(self, o):
        return self._ew(o, "less_than")

    def __le__(self, o):
        return self._ew(o, "less_equal")

    def __gt__(self, o):
        return self._ew(o, "greater_than")

    def __ge__(self, o):
        return self._ew(o, "greater_equal")

    def __getitem__(self, idx):
        from .eager import apply_torch

        def raw(i):
            if isinstance(i, Tensor):
                v = i._value
                return v if v.dtype == torch.bool else v.long()
            return i

        idx = tuple(raw(i) for i in idx) if isinstance(idx, tuple) \
            else raw(idx)
        return apply_torch(lambda v: v[idx], self)

    def __iter__(self):
        """Iterate rows (reference VarBase iterates dim 0)."""
        if self._value.dim() == 0:
            raise TypeError("iteration over a 0-d tensor")
        return (self[i] for i in range(int(self._value.shape[0])))

    def register_hook(self, hook):
        """Gradient hook (reference imperative/hooks.h VarBase hooks):
        called with this tensor's gradient when backward computes it; a
        returned tensor REPLACES the gradient.  Returns a handle whose
        ``remove()`` detaches the hook."""
        if self.stop_gradient:
            raise RuntimeError(
                "cannot register a gradient hook on a tensor with "
                "stop_gradient=True")

        def run(g):
            out = hook(_wrap(g))
            if out is None:
                return None
            return _unwrap(out) if isinstance(out, Tensor) \
                else _as_torch(out, g.device).to(g.dtype)

        return self._value.register_hook(run)

    # -- common methods -----------------------------------------------------
    def astype(self, dtype):
        from ..framework import dtypes
        from .eager import apply_torch

        td = dtypes.to_torch(dtype)
        return apply_torch(lambda v: v.to(td), self)

    cast = astype

    def reshape(self, *shape):
        from .eager import run_op

        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = shape[0]
        return run_op("reshape2", {"X": self}, {"shape": list(shape)},
                      out_slots=("Out",))["Out"]

    def transpose(self, perm):
        from .eager import run_op

        return run_op("transpose2", {"X": self}, {"axis": list(perm)},
                      out_slots=("Out",))["Out"]

    def _reduce(self, op_type, axis, keepdim):
        from .eager import run_op

        attrs = {"dim": [] if axis is None else ([axis] if isinstance(axis, int) else list(axis)),
                 "keep_dim": keepdim, "reduce_all": axis is None}
        return run_op(op_type, {"X": self}, attrs)["Out"]

    def sum(self, axis=None, keepdim=False):
        return self._reduce("reduce_sum", axis, keepdim)

    def mean(self, axis=None, keepdim=False):
        from .eager import run_op

        if axis is None and not keepdim:
            return run_op("mean", {"X": self}, {})["Out"]
        return self._reduce("reduce_mean", axis, keepdim)

    def max(self, axis=None, keepdim=False):
        return self._reduce("reduce_max", axis, keepdim)

    def min(self, axis=None, keepdim=False):
        return self._reduce("reduce_min", axis, keepdim)

    def clone(self):
        from .eager import apply_torch

        return apply_torch(torch.clone, self)


class Parameter(Tensor):
    """Trainable eager tensor (reference framework.ParamBase): a leaf
    whose ``_value`` requires grad when trainable.  ``_set_raw`` writes
    in place under ``no_grad``, so the leaf keeps its identity and its
    address (an optimizer step, ``amp.decorate``'s cast excepted)."""

    def __init__(self, value, name=None, trainable=True):
        value = _as_torch(value).detach()
        super().__init__(value, name=name or unique_name.generate("param"),
                         stop_gradient=not trainable, persistable=True)
        self.trainable = trainable
        self.optimize_attr = {"learning_rate": 1.0}
        self.regularizer = None
        self.need_clip = True

    def __deepcopy__(self, memo):
        """A new leaf holding a copy of the value, under a name of its own
        (reference ParamBase.__deepcopy__): ``copy.deepcopy`` of a layer
        gives it parameters of its own."""
        new = Parameter.__new__(Parameter)
        memo[id(self)] = new
        for k, v in self.__dict__.items():
            if k != "_grad_tensor":
                new.__dict__[k] = copy.deepcopy(v, memo)
        new._name = unique_name.generate(self.name + "_deepcopy")
        return new

    def _set_raw(self, value):
        v = self._value
        if value.shape == v.shape and value.dtype == v.dtype \
                and value.device == v.device:
            with torch.no_grad():
                v.copy_(value)
        else:
            self._value = value.detach().requires_grad_(v.requires_grad)
        return self

    def __repr__(self):
        return f"Parameter(name={self.name}, shape={self.shape}, dtype={self.dtype},\n{self._value})"
