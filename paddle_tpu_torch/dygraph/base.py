"""Dygraph mode state: the mode switch, the place, the random streams,
``guard`` and the gradient switches.

Counterpart of ``paddle_tpu/dygraph/base.py``.  Two differences, both
because torch is not jax:

- **The place.**  Eager tensors live on one device, the place:
  ``cuda:0`` unless ``set_device("cpu")`` (or ``disable_static("cpu")``)
  asks for the CPU.  Every dygraph entry point that makes a tensor
  (``to_tensor``, a ``Layer``'s parameters, creation and random ops)
  makes it on the place, and raises when the place is the card and torch
  sees none: nothing falls back to the CPU.
- **The random streams.**  The JAX package splits one threefry key per
  random op (``next_eager_key``).  Here each device has one
  ``torch.Generator``, seeded by ``seed(v)`` (0 until then), and random
  ops and initializers draw from the generator of the device they make
  their tensor on.  The two packages' draws agree in distribution, not in
  bits.

``no_grad``/``enable_grad`` are torch's gradient switches: the tape is
``torch.autograd``, so ``torch.no_grad()`` is what stops recording.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict

import numpy as np
import torch

from ..framework.place import default_device


class _DygraphState:
    def __init__(self):
        self.mode_on = True  # reference defaults to dygraph in 2.0 API
        self.place = "gpu:0"
        self.seed = 0
        self.generators: Dict[torch.device, torch.Generator] = {}


_state = _DygraphState()


def in_dygraph_mode() -> bool:
    return _state.mode_on


def enabled() -> bool:
    return _state.mode_on


def enable_static():
    """Switch the 2.0 API into static-graph mode (reference
    paddle.enable_static)."""
    _state.mode_on = False


def disable_static(place=None):
    """Back to dygraph (reference paddle.disable_static), on ``place``
    when one is given."""
    if place is not None:
        set_device(place)
    _state.mode_on = True


@contextlib.contextmanager
def guard(place=None):
    """Enter dygraph mode (reference dygraph/base.py `guard`)."""
    prev = _state.mode_on, _state.place
    if place is not None:
        set_device(place)
    _state.mode_on = True
    try:
        yield
    finally:
        _state.mode_on, _state.place = prev


def _parse_place(place) -> str:
    """``"gpu"``, ``"gpu:i"``, ``"cpu"``, a ``Place`` or a torch device
    -> ``"gpu:i"`` | ``"cpu"``."""
    if hasattr(place, "torch_device"):
        place = place.torch_device()
    if isinstance(place, torch.device):
        return "cpu" if place.type == "cpu" else f"gpu:{place.index or 0}"
    p = str(place).lower().replace("cuda", "gpu")
    if p == "cpu":
        return p
    if p == "gpu":
        return "gpu:0"
    if p.startswith("gpu:") and p[4:].isdigit():
        return p
    raise ValueError(f"unknown device {place!r}: use 'cpu', 'gpu' or "
                     f"'gpu:<index>'")


def set_device(device):
    """Make ``device`` (``"gpu:0"`` | ``"gpu"`` | ``"cpu"``) the place of
    eager tensors; raises for a card torch does not see."""
    p = _parse_place(device)
    _torch_device(p)
    _state.place = p
    return p


def get_device() -> str:
    return _state.place


def _torch_device(place: str) -> torch.device:
    if place == "cpu":
        return torch.device("cpu")
    dev = default_device(torch.device("cuda", int(place[4:])))
    if dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"{place} out of range: "
                           f"{torch.cuda.device_count()} card(s) visible")
    return dev


def current_device() -> torch.device:
    """The place as a ``torch.device``; raises on a card torch does not
    see."""
    return _torch_device(_state.place)


def generator(device: torch.device) -> torch.Generator:
    """The random stream of ``device``, seeded by the last ``seed``."""
    gen = _state.generators.get(device)
    if gen is None:
        gen = _state.generators[device] = torch.Generator(
            device=device).manual_seed(_state.seed)
    return gen


class no_grad:
    """Context manager AND decorator disabling tape recording
    (reference dygraph/base.py `no_grad`).  Both ``@no_grad`` and
    ``@no_grad()`` work, as in the reference."""

    def __new__(cls, func=None):
        self = super().__new__(cls)
        if func is not None and callable(func):
            @functools.wraps(func)
            def wrapper(*args, **kwargs):
                with torch.no_grad():
                    return func(*args, **kwargs)

            return wrapper
        return self

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with torch.no_grad():
                return fn(*args, **kwargs)

        return wrapper

    def __enter__(self):
        self._guard = torch.no_grad()
        self._guard.__enter__()
        return self

    def __exit__(self, *exc):
        self._guard.__exit__(*exc)
        return False


def enable_grad():
    return torch.enable_grad()


def seed(value: int):
    """Seed BOTH execution modes (reference paddle.seed): the eager
    generators and the default programs' random_seed for static-graph
    runs."""
    _state.seed = int(value)
    _state.generators.clear()
    from ..framework import program as prog_mod

    prog_mod.default_main_program().random_seed = int(value)
    prog_mod.default_startup_program().random_seed = int(value)


def to_variable(value, name=None, zero_copy=None, dtype=None):
    """numpy / scalar / Tensor -> eager Tensor on the place (reference
    dygraph base.to_variable).  float64 becomes float32, as in the JAX
    package; 64-bit integers stay 64-bit."""
    from ..framework import dtypes
    from .tensor import Tensor

    if isinstance(value, Tensor):
        return value
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if dtype is not None:
            t = t.to(dtypes.to_torch(dtype))
        elif t.dtype == torch.float64:
            t = t.float()
        return Tensor(t.to(current_device()), name=name, stop_gradient=True)
    arr = np.asarray(value)
    if dtype is not None:
        arr = arr.astype(dtypes.to_np(dtype))
    elif arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    t = torch.as_tensor(arr, device=current_device())
    if dtype is not None:
        t = t.to(dtypes.to_torch(dtype))    # bfloat16, which numpy lacks
    return Tensor(t, name=name, stop_gradient=True)
