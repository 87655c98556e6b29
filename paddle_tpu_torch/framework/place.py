"""Device choice for the PyTorch port.

Counterpart of ``paddle_tpu/framework/place.py``.  There a ``Place``
resolves to a ``jax.Device`` and a host without an accelerator quietly
simulates one on the CPU.  Here every entry point takes a ``device``
and runs on the CUDA card unless the caller asks for the CPU (as the
tests do): asking for the card on a host without one raises instead of
falling back, so a measurement can never come from the CPU by accident.

The static-graph executor takes a ``Place`` as the JAX package's does:
``CPUPlace()`` or ``CUDAPlace(i)`` (``TPUPlace(i)``, the JAX package's
accelerator place, is card ``i`` too); ``_default_place()`` is
``CUDAPlace(0)`` and raises without CUDA (the JAX package's falls back to
the CPU there).
"""
from __future__ import annotations

import os

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def default_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the current CUDA
    card.  Raises ``RuntimeError`` when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "paddle_tpu_torch runs on a CUDA device by default and "
                "torch sees none; pass device='cpu' to run the plain "
                "PyTorch versions of the kernels on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_of(module: torch.nn.Module) -> Optional[torch.device]:
    """The device a module's parameters live on (None without any)."""
    for p in module.parameters():
        return p.device
    return None


class Place:
    """Base device identity (reference platform/place.h)."""

    device_id: int = 0

    def __eq__(self, other):
        return type(self) is type(other) and self.device_id == other.device_id

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"

    def torch_device(self) -> torch.device:
        raise NotImplementedError


class CPUPlace(Place):
    def __init__(self):
        self.device_id = 0

    def torch_device(self) -> torch.device:
        return torch.device("cpu")


class CUDAPlace(Place):
    """CUDA card ``device_id``; raises when torch sees no such card."""

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def torch_device(self) -> torch.device:
        dev = default_device(torch.device("cuda", self.device_id))
        if self.device_id >= torch.cuda.device_count():
            raise RuntimeError(
                f"CUDAPlace({self.device_id}) out of range: "
                f"{torch.cuda.device_count()} card(s) visible")
        return dev


class TPUPlace(CUDAPlace):
    """The JAX package's name for the accelerator's place: here CUDA card
    ``device_id``, as ``static.tpu_places`` and ``Config.enable_tpu``
    map it.  It has no ``jax_device``: the port has no JAX device."""


def _default_place() -> Place:
    """``CUDAPlace(FLAGS_selected_gpus)`` (card 0 unless the launcher
    chose another for this rank), after checking that torch sees a
    card."""
    default_device()
    return CUDAPlace(selected_gpu())


def selected_gpu() -> int:
    """This process's card: the first entry of the ``FLAGS_selected_gpus``
    environment variable (default 0), the reference's per-rank device
    flag, which the launcher exports."""
    raw = os.environ.get("FLAGS_selected_gpus", "").split(",")[0].strip()
    return int(raw) if raw else 0
