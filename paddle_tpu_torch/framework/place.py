"""Device choice for the PyTorch port.

Counterpart of ``paddle_tpu/framework/place.py``.  There a ``Place``
resolves to a ``jax.Device`` and a host without an accelerator quietly
simulates one on the CPU.  Here every entry point takes a ``device``
and runs on the CUDA card unless the caller asks for the CPU (as the
tests do): asking for the card on a host without one raises instead of
falling back, so a measurement can never come from the CPU by accident.
"""
from __future__ import annotations

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
